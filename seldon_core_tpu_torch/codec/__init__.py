"""Payload codecs: proto <-> numpy <-> device, plus the plain-JSON path."""

from seldon_core_tpu_torch.codec.tensor import (  # noqa: F401
    PayloadError,
    array_to_datadef,
    array_to_ndarray,
    array_to_raw_tensor,
    array_to_tensor,
    build_message,
    datadef_to_array,
    get_data_from_proto,
    message_data_kind,
    ndarray_to_array,
    np_dtype,
    raw_tensor_to_array,
    tensor_to_array,
)
from seldon_core_tpu_torch.codec.jsonpath import (  # noqa: F401
    build_json_payload,
    extract_json_payload,
    json_feedback_to_proto,
    json_to_proto,
    proto_to_json,
)
from seldon_core_tpu_torch.codec.device import (  # noqa: F401
    PendingHostCopy,
    from_device,
    from_device_async,
    from_device_many,
    is_device_array,
    to_device,
)
from seldon_core_tpu_torch.codec.bufview import (  # noqa: F401
    BufferView,
    is_frame,
    pack_frame,
    pack_frames,
    stack_views,
    unpack_frame,
    unpack_frames,
    zero_copy_enabled,
)
from seldon_core_tpu_torch.codec.tftensor import (  # noqa: F401
    TfTensorError,
    array_to_tftensor,
    tftensor_to_array,
)
