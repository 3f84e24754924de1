"""Node-method dispatch: InternalMessage -> user component -> InternalMessage.

The wrapper-side execution semantics of the reference
(reference: python/seldon_core/seldon_methods.py:28-344):

1. if the component defines a proto-level ``predict_raw`` override, use
   it (converting to/from proto at this one point);
2. otherwise decode features, call the array-level user method, and wrap
   the result echoing the request's wire encoding, attaching
   ``class_names``/``tags``/``metrics``.

The payload handed to user code may be a CUDA ``torch.Tensor`` when the
producer kept it on device and the consumer opts in
(``accepts_device_arrays = True`` on the component); by default it is
materialised to numpy.  This slice of the port dispatches ``predict``
and the health hook; the other node roles (transformers, routers,
combiners, feedback) come with the engine graph.
"""

from __future__ import annotations

import uuid
from typing import Any, Optional

from seldon_core_tpu_torch import codec
from seldon_core_tpu_torch.runtime import component as comp
from seldon_core_tpu_torch.runtime.message import InternalMessage


def _features_for(user_model: Any, msg: InternalMessage) -> Any:
    """The payload as the user method sees it."""
    if codec.is_device_array(msg.payload) and not getattr(user_model, "accepts_device_arrays", False):
        return msg.host_payload()
    return msg.payload


def _construct_response(user_model: Any, msg: InternalMessage, result: Any) -> InternalMessage:
    """Wrap a user-method result (reference: utils.py:426-498)."""
    if isinstance(result, InternalMessage):
        return result
    out = msg.with_payload(result)
    if isinstance(result, (bytes, str, dict)):
        out.names = []
    else:
        out.names = comp.get_class_names(user_model)
    tags = comp.get_custom_tags(user_model)
    if tags:
        out.meta.tags.update(tags)
    metrics = comp.get_custom_metrics(user_model)
    out.meta.metrics = list(metrics) if metrics else []
    return out


def _try_raw(user_model: Any, raw_name: str, msg: InternalMessage) -> Optional[InternalMessage]:
    """Proto-level override path (``predict_raw``)."""
    fn = getattr(user_model, raw_name, None)
    if fn is None:
        return None
    try:
        result = fn(msg.to_proto())
    except comp.NotImplementedByUser:
        return None
    return InternalMessage.from_proto(result)


def _ensure_puid(msg: InternalMessage) -> str:
    """puid of the message, assigning one when the caller didn't —
    standalone microservices have no engine upstream to mint ids."""
    if not msg.meta.puid:
        msg.meta.puid = uuid.uuid4().hex[:24]
    return msg.meta.puid


def predict(user_model: Any, msg: InternalMessage) -> InternalMessage:
    _ensure_puid(msg)
    raw = _try_raw(user_model, "predict_raw", msg)
    if raw is not None:
        return raw
    features = _features_for(user_model, msg)
    result = user_model.predict(features, msg.names, meta=msg.meta.to_dict())
    return _construct_response(user_model, msg, result)


async def predict_async(user_model: Any, msg: InternalMessage) -> InternalMessage:
    """Async-native predict: awaits a component's ``predict_async`` if it
    has one (e.g. CudaServer's batcher-backed path), else runs the sync
    dispatch on the shared pool."""
    fn = getattr(user_model, "predict_async", None)
    if fn is None or hasattr(user_model, "predict_raw"):
        from seldon_core_tpu_torch.runtime.executor_pool import run_dispatch

        return await run_dispatch(predict, user_model, msg)
    _ensure_puid(msg)
    features = _features_for(user_model, msg)
    result = await fn(features, msg.names, meta=msg.meta.to_dict())
    return _construct_response(user_model, msg, result)


def health_check(user_model: Any) -> InternalMessage:
    """Optional user health hook; defaults to a static OK payload."""
    fn = getattr(user_model, "health_status", None)
    if fn is not None:
        return _construct_response(user_model, InternalMessage(kind="ndarray"), fn())
    return InternalMessage(payload={"status": "ok"}, kind="jsonData")
