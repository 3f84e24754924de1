"""Model-runtime layer: component API, dispatch, REST server, CLI."""

from seldon_core_tpu_torch.runtime.component import (  # noqa: F401
    MicroserviceError,
    NotImplementedByUser,
    TPUComponent,
    counter_metric,
    gauge_metric,
    timer_metric,
    validate_metrics,
)
from seldon_core_tpu_torch.runtime.message import (  # noqa: F401
    InternalFeedback,
    InternalMessage,
    MsgMeta,
)
