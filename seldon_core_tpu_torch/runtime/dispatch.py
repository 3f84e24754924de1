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
materialised to numpy.

Every method call is a ``microservice.<method>`` span when tracing is on
(``_traced``): a child of the caller's span, whether its context arrived
in the HTTP headers / gRPC metadata (activated by the server) or in
``meta.traceContext`` (consumed here, tracing on or off).
"""

from __future__ import annotations

import functools
from typing import Any, List, Optional

import numpy as np

from seldon_core_tpu_torch import codec
from seldon_core_tpu_torch.runtime import component as comp
from seldon_core_tpu_torch.runtime.message import InternalFeedback, InternalMessage
from seldon_core_tpu_torch.runtime.puid import new_puid
from seldon_core_tpu_torch.utils import tracing


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
    """Proto-level override path (``predict_raw`` etc.)."""
    fn = getattr(user_model, raw_name, None)
    if fn is None:
        return None
    try:
        result = fn(msg.to_proto())
    except comp.NotImplementedByUser:
        return None
    return InternalMessage.from_proto(result)


def _ensure_puid(msg) -> str:
    """puid of the message (or its feedback request), assigning one when
    the caller didn't — standalone microservices have no engine upstream
    to mint ids."""
    first = msg[0] if isinstance(msg, list) and msg else msg
    meta = getattr(first, "meta", None) or getattr(getattr(first, "request", None), "meta", None)
    if meta is None:
        return ""
    if not meta.puid:
        meta.puid = new_puid()
    return meta.puid


def _consume_trace_context(msg) -> Optional[tracing.SpanContext]:
    """Pop the W3C trace-context carrier off the message meta (and, for
    lists, every member) so responses never echo the caller's context
    downstream, and parse it into a SpanContext (or None).  Consumed even
    when tracing is off: the carrier is hop state, not payload."""
    first = msg
    if isinstance(msg, list):
        if not msg:
            return None
        first = msg[0]
        for other in msg[1:]:
            meta = getattr(other, "meta", None)
            if meta is not None:
                meta.trace_context = {}
    meta = getattr(first, "meta", None) or getattr(getattr(first, "request", None), "meta", None)
    if meta is None or not meta.trace_context:
        return None
    carrier, meta.trace_context = meta.trace_context, {}
    return tracing.extract(carrier)


def _traced(method_name: str):
    """A span per method call, the reference's wrapper-level tracing
    (microservice.py:124-155); one global read when tracing is off.  A
    remote context from the message meta parents the span, unless the
    server already activated one from the headers or metadata (they
    agree when both exist; the ambient one wins)."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(user_model, msg, *args, **kwargs):
            puid = _ensure_puid(msg)
            ctx = _consume_trace_context(msg)
            if tracing.get_tracer() is None:
                return fn(user_model, msg, *args, **kwargs)
            if tracing.current_span() is not None:
                ctx = None
            with tracing.activate_context(ctx):
                with tracing.maybe_span(f"microservice.{method_name}", trace_id=puid):
                    return fn(user_model, msg, *args, **kwargs)

        return wrapper

    return deco


@_traced("predict")
def predict(user_model: Any, msg: InternalMessage) -> InternalMessage:
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
    puid = _ensure_puid(msg)
    ctx = _consume_trace_context(msg)
    if tracing.current_span() is not None:
        ctx = None
    with tracing.activate_context(ctx if tracing.get_tracer() is not None else None):
        with tracing.maybe_span("microservice.predict", trace_id=puid):
            features = _features_for(user_model, msg)
            result = await fn(features, msg.names, meta=msg.meta.to_dict())
    return _construct_response(user_model, msg, result)


@_traced("transform_input")
def transform_input(user_model: Any, msg: InternalMessage) -> InternalMessage:
    raw = _try_raw(user_model, "transform_input_raw", msg)
    if raw is not None:
        return raw
    features = _features_for(user_model, msg)
    result = user_model.transform_input(features, msg.names, meta=msg.meta.to_dict())
    return _construct_response(user_model, msg, result)


@_traced("transform_output")
def transform_output(user_model: Any, msg: InternalMessage) -> InternalMessage:
    raw = _try_raw(user_model, "transform_output_raw", msg)
    if raw is not None:
        return raw
    features = _features_for(user_model, msg)
    result = user_model.transform_output(features, msg.names, meta=msg.meta.to_dict())
    return _construct_response(user_model, msg, result)


@_traced("route")
def route(user_model: Any, msg: InternalMessage) -> InternalMessage:
    """Returns a message whose payload is [[branch_index]]
    (reference: seldon_methods.py route semantics)."""
    raw = _try_raw(user_model, "route_raw", msg)
    if raw is not None:
        return raw
    features = _features_for(user_model, msg)
    branch = user_model.route(features, msg.names)
    if not isinstance(branch, (int, np.integer)):
        raise comp.MicroserviceError(
            f"route must return int, got {type(branch).__name__}", status_code=500, reason="INVALID_ROUTING"
        )
    out = _construct_response(user_model, msg, np.array([[int(branch)]]))
    out.kind = "ndarray"
    return out


@_traced("aggregate")
def aggregate(user_model: Any, msgs: List[InternalMessage]) -> InternalMessage:
    fn = getattr(user_model, "aggregate_raw", None)
    if fn is not None:
        try:
            from seldon_core_tpu_torch.proto import pb

            msg_list = pb.SeldonMessageList(seldonMessages=[m.to_proto() for m in msgs])
            return InternalMessage.from_proto(fn(msg_list))
        except comp.NotImplementedByUser:
            pass
    if not msgs:
        raise comp.MicroserviceError("aggregate called with no inputs", status_code=400, reason="EMPTY_AGGREGATE")
    features_list = [_features_for(user_model, m) for m in msgs]
    names_list = [m.names for m in msgs]
    result = user_model.aggregate(features_list, names_list)
    out = _construct_response(user_model, msgs[0], result)
    # meta of an aggregate response starts from the union of inputs
    for m in msgs[1:]:
        merged = dict(m.meta.tags)
        merged.update(out.meta.tags)
        out.meta.tags = merged
    return out


@_traced("send_feedback")
def send_feedback(
    user_model: Any, feedback: InternalFeedback, predictive_unit_id: Optional[str] = None
) -> InternalMessage:
    """Reference: seldon_methods.py:74-120 — routing picked from the
    response meta for this unit, default response is an empty array."""
    fn = getattr(user_model, "send_feedback_raw", None)
    if fn is not None:
        try:
            return InternalMessage.from_proto(fn(feedback.to_proto()))
        except comp.NotImplementedByUser:
            pass
    request = feedback.request
    features = _features_for(user_model, request) if request is not None else None
    names = request.names if request is not None else []
    truth = feedback.truth.host_payload() if feedback.truth is not None else None
    routing = None
    if feedback.response is not None and predictive_unit_id:
        routing = feedback.response.meta.routing.get(predictive_unit_id)
    result = None
    if hasattr(user_model, "send_feedback"):
        try:
            result = user_model.send_feedback(features, names, feedback.reward, truth, routing=routing)
        except comp.NotImplementedByUser:
            result = None
    if result is None:
        result = np.array([])
    base = request if request is not None else InternalMessage(kind="ndarray")
    return _construct_response(user_model, base, np.asarray(result))


def health_check(user_model: Any) -> InternalMessage:
    """Optional user health hook; defaults to a static OK payload."""
    fn = getattr(user_model, "health_status", None)
    if fn is not None:
        return _construct_response(user_model, InternalMessage(kind="ndarray"), fn())
    return InternalMessage(payload={"status": "ok"}, kind="jsonData")
