"""gRPC server for a single graph-node microservice.

Registers the six node-role services against one user component, the
same all-servicers-on-one-object pattern as the reference wrapper
(reference: python/seldon_core/wrapper.py:133-158), using gRPC generic
handlers (no generated stubs).  Uses the async server; user-model calls
run on worker threads so device compute overlaps request handling.

Every call adopts the caller's ``traceparent`` from the invocation
metadata (when tracing is on) and the tighter of its
``x-seldon-deadline-ms`` metadata and its native gRPC deadline; a spent
budget answers a ``DEADLINE_EXCEEDED`` FAILURE before the model sees the
request.  ``serve(..., tls=)`` binds a secure port.
"""

from __future__ import annotations

import logging
from typing import Any, Optional

import grpc

from seldon_core_tpu_torch.proto import pb, services
from seldon_core_tpu_torch.runtime import dispatch
from seldon_core_tpu_torch.runtime.component import MicroserviceError
from seldon_core_tpu_torch.runtime.executor_pool import run_dispatch
from seldon_core_tpu_torch.runtime.message import InternalFeedback, InternalMessage
from seldon_core_tpu_torch.utils import deadlines as _deadlines
from seldon_core_tpu_torch.utils import tracing as _tracing

logger = logging.getLogger(__name__)

# a batch-32 uint8 224x224x3 request is 4.8 MB, over gRPC's 4 MB default
DEFAULT_MAX_MSG_BYTES = 512 * 1024 * 1024


def failure_proto(code: int, info: str, reason: str) -> pb.SeldonMessage:
    resp = pb.SeldonMessage()
    resp.status.status = pb.Status.FAILURE
    resp.status.code = code
    resp.status.info = info
    resp.status.reason = reason
    return resp


def _grpc_remote_ctx(context) -> Optional[_tracing.SpanContext]:
    """The caller's W3C span context from the invocation metadata (the
    proto has no header field for it), if tracing is on."""
    if _tracing.get_tracer() is None:
        return None
    try:
        return _tracing.extract(context.invocation_metadata() or ())
    except Exception:  # noqa: BLE001 — bad metadata must not fail the call
        return None


def _grpc_deadline_ms(context) -> Optional[float]:
    """The caller's remaining budget in ms: the tighter of the
    ``x-seldon-deadline-ms`` metadata entry and the native gRPC deadline
    (``context.time_remaining()``); None when neither is set."""
    try:
        md_ms = _deadlines.extract_ms(context.invocation_metadata() or ())
    except Exception:  # noqa: BLE001 — bad metadata must not fail the call
        md_ms = None
    try:
        remaining = context.time_remaining()
        native_ms = None if remaining is None else max(0.0, float(remaining) * 1000.0)
    except Exception:  # noqa: BLE001 — an odd context must not fail the call
        native_ms = None
    if md_ms is None:
        return native_ms
    if native_ms is None:
        return md_ms
    return min(md_ms, native_ms)


def _wrap_unary(user_model: Any, fn, unit_id: str = ""):
    async def handler(request, context):
        try:
            with _tracing.activate_context(_grpc_remote_ctx(context)), \
                    _deadlines.activate_ms(_grpc_deadline_ms(context)):
                _deadlines.check(f"microservice grpc ingress {fn.__name__}")
                if isinstance(request, pb.Feedback):
                    out = await run_dispatch(fn, user_model, InternalFeedback.from_proto(request), unit_id)
                elif isinstance(request, pb.SeldonMessageList):
                    msgs = [InternalMessage.from_proto(m) for m in request.seldonMessages]
                    out = await run_dispatch(fn, user_model, msgs)
                else:
                    msg = InternalMessage.from_proto(request)
                    # x-seldon-adapter metadata selects the LoRA weight set,
                    # REST-lane parity: a body tag wins
                    adapter = _deadlines.extract_adapter(context.invocation_metadata() or ())
                    if adapter and "adapter" not in msg.meta.tags:
                        msg.meta.tags["adapter"] = adapter
                    if fn is dispatch.predict:  # async fast path for batched models
                        out = await dispatch.predict_async(user_model, msg)
                    else:
                        out = await run_dispatch(fn, user_model, msg)
            return out.to_proto()
        except MicroserviceError as e:
            return failure_proto(e.status_code, e.message, e.reason)
        except Exception as e:  # noqa: BLE001 — every error must map to a Status
            logger.exception("grpc handler error")
            return failure_proto(500, str(e), "MICROSERVICE_INTERNAL_ERROR")

    return handler


def add_component_services(server: grpc.aio.Server, user_model: Any, unit_id: str = "") -> None:
    """Register Generic/Model/Router/Transformer/OutputTransformer/
    Combiner for `user_model` on `server`."""
    p = _wrap_unary(user_model, dispatch.predict)
    ti = _wrap_unary(user_model, dispatch.transform_input)
    to = _wrap_unary(user_model, dispatch.transform_output)
    rt = _wrap_unary(user_model, dispatch.route)
    ag = _wrap_unary(user_model, dispatch.aggregate)
    fb = _wrap_unary(user_model, dispatch.send_feedback, unit_id)

    server.add_generic_rpc_handlers(
        (
            services.generic_handler(
                "Generic",
                {"TransformInput": ti, "TransformOutput": to, "Route": rt, "Aggregate": ag, "SendFeedback": fb},
            ),
            services.generic_handler("Model", {"Predict": p, "SendFeedback": fb}),
            services.generic_handler("Router", {"Route": rt, "SendFeedback": fb}),
            services.generic_handler("Transformer", {"TransformInput": ti}),
            services.generic_handler("OutputTransformer", {"TransformOutput": to}),
            services.generic_handler("Combiner", {"Aggregate": ag}),
        )
    )


def message_size_options(max_message_bytes: int = DEFAULT_MAX_MSG_BYTES):
    """Channel/server options raising gRPC's 4 MB message cap."""
    return [
        ("grpc.max_send_message_length", max_message_bytes),
        ("grpc.max_receive_message_length", max_message_bytes),
    ]


def build_server(
    user_model: Any,
    unit_id: str = "",
    max_message_bytes: int = DEFAULT_MAX_MSG_BYTES,
) -> grpc.aio.Server:
    server = grpc.aio.server(options=message_size_options(max_message_bytes))
    add_component_services(server, user_model, unit_id)
    return server


async def serve(
    user_model: Any,
    port: int = 5000,
    host: str = "0.0.0.0",
    unit_id: str = "",
    max_message_bytes: int = DEFAULT_MAX_MSG_BYTES,
    tls=None,
) -> grpc.aio.Server:
    """``tls`` is a ``utils.tls.TlsConfig``: when set the port is secure."""
    from seldon_core_tpu_torch.utils.tls import add_grpc_port

    server = build_server(user_model, unit_id, max_message_bytes)
    add_grpc_port(server, f"{host}:{port}", tls)
    await server.start()
    return server
