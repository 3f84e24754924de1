"""Payload codecs: proto <-> numpy <-> device, plus the plain-JSON path."""

from seldon_core_tpu_torch.codec.tensor import (  # noqa: F401
    PayloadError,
    array_to_datadef,
    array_to_ndarray,
    array_to_raw_tensor,
    array_to_tensor,
    datadef_to_array,
    message_data_kind,
    ndarray_to_array,
    np_dtype,
    raw_tensor_to_array,
    tensor_to_array,
)
from seldon_core_tpu_torch.codec.jsonpath import (  # noqa: F401
    build_json_payload,
    extract_json_payload,
)
from seldon_core_tpu_torch.codec.device import (  # noqa: F401
    PendingHostCopy,
    from_device,
    from_device_async,
    is_device_array,
    to_device,
)
