"""Synchronous gRPC front server — the low-latency ingress.

grpc.aio schedules every request through the event loop; a thread-pool
(sync) gRPC server with direct dispatch keeps asyncio off the hot path.
This server serves the external ``Seldon`` service from the C-core's
thread pool:

* single-local-MODEL predictors take the **fast path** —
  ``PredictorService.predict_sync`` on the handler thread (the thread
  blocks on the dynamic batcher, so the pool's threads coalesce into
  batches);
* multi-node graphs and feedback bridge into the deployment's asyncio
  loop via ``run_coroutine_threadsafe`` (full engine semantics).

The ingress contract is read on the handler thread: the caller's
``traceparent`` and the tighter of ``x-seldon-deadline-ms`` and the
native gRPC deadline, minted once as an ABSOLUTE expiry.  The fast path
activates both around ``predict_sync``; the bridged path re-activates
them inside its coroutine, since ``run_coroutine_threadsafe`` does not
carry the thread's context variables (a deadline re-minted there from a
duration would refund the queueing time).  With ``auth`` every method
answers ``UNAUTHENTICATED`` without a valid bearer token.

``GenerateStream`` streams a single-local-model predictor's
``predict_stream`` (``StreamingLM``): one SeldonMessage of new token ids
per engine chunk; any other predictor answers UNIMPLEMENTED.
"""

from __future__ import annotations

import asyncio
import logging
import time
from concurrent import futures

import grpc
import numpy as np

from seldon_core_tpu_torch.proto import pb, services
from seldon_core_tpu_torch.runtime.component import MicroserviceError
from seldon_core_tpu_torch.runtime.grpc_server import (
    DEFAULT_MAX_MSG_BYTES,
    _grpc_deadline_ms,
    _grpc_remote_ctx,
    message_size_options,
)
from seldon_core_tpu_torch.runtime.message import InternalFeedback, InternalMessage
from seldon_core_tpu_torch.utils import deadlines as _deadlines
from seldon_core_tpu_torch.utils.tracing import activate_context

logger = logging.getLogger(__name__)

# the answer of every streaming lane to a predictor that cannot stream
GENERATE_STREAM_UNSUPPORTED = ("GenerateStream needs a single-local-model predictor whose component implements "
                               "predict_stream (e.g. STREAMING_LM)")


def stream_tags(msg: InternalMessage, carrier) -> dict:
    """A streamed request's tags: its body tags, then the carrier's
    (HTTP headers or gRPC metadata) deadline, priority and adapter where
    the body has none.  The generator runs on other threads than the
    ingress's, so the deadline rides the tags, minted absolute here
    (``deadline_at_monotonic``): a relative one minted at submit would
    refund the hand-off's queueing time."""
    tags = dict(msg.meta.tags)
    ms = _deadlines.extract_ms(carrier)
    if ms is not None:
        tags.setdefault("deadline_at_monotonic", time.monotonic() + ms / 1000.0)
    prio = _deadlines.extract_priority(carrier)
    if prio is not None:
        tags.setdefault("priority", prio)
    adapter = _deadlines.extract_adapter(carrier)
    if adapter:
        tags.setdefault("adapter", adapter)
    return tags


def ingress_tags(msg: InternalMessage, carrier) -> None:
    """A unary request's priority and adapter from the carrier (gRPC
    metadata) into its tags, where its body has none: the body wins."""
    prio = _deadlines.extract_priority(carrier)
    if prio is not None and "priority" not in msg.meta.tags:
        msg.meta.tags["priority"] = prio
    adapter = _deadlines.extract_adapter(carrier)
    if adapter and "adapter" not in msg.meta.tags:
        msg.meta.tags["adapter"] = adapter


def stream_fn(svc):
    """The ``predict_stream`` of a single-local-model predictor, or None."""
    fast = svc.single_local_model()
    return getattr(fast[1] if fast is not None else None, "predict_stream", None)


def _ingress(context):
    """The caller's span context and budget, read on the handler thread;
    the budget is an absolute expiry minted here, once."""
    budget_ms = _grpc_deadline_ms(context)
    budget = _deadlines.Deadline.after_ms(budget_ms) if budget_ms is not None else None
    return _grpc_remote_ctx(context), budget


class SyncSeldonService:
    def __init__(self, gateway, loop: asyncio.AbstractEventLoop, issuer=None):
        self.gateway = gateway
        self.loop = loop
        self.issuer = issuer  # utils.auth.TokenIssuer when OAuth is on

    def _bridge(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result()

    def _check_auth(self, context) -> None:
        if self.issuer is not None and not self.issuer.verify_grpc(context):
            from seldon_core_tpu_torch.utils.auth import UNAUTHENTICATED_MSG

            context.abort(grpc.StatusCode.UNAUTHENTICATED, UNAUTHENTICATED_MSG)

    def predict(self, request: pb.SeldonMessage, context) -> pb.SeldonMessage:
        from seldon_core_tpu_torch.engine.service import failure_message

        self._check_auth(context)
        msg = InternalMessage.from_proto(request)
        ingress_tags(msg, context.invocation_metadata() or ())
        svc = self.gateway.pick()
        if self.gateway.shadows:
            # isolated copies, fired on the loop: primary and shadow both mutate meta
            self.loop.call_soon_threadsafe(self.gateway.shadow, msg.copy())
        ctx, budget = _ingress(context)
        try:
            if svc.single_local_model() is not None:
                with activate_context(ctx), _deadlines.activate(budget):
                    _deadlines.check("gateway grpc ingress Seldon/Predict")
                    out = svc.predict_sync(msg)
            else:
                async def _predict_with_ctx():
                    with activate_context(ctx), _deadlines.activate(budget):
                        _deadlines.check("gateway grpc ingress Seldon/Predict")
                        return await svc.predict(msg)

                out = self._bridge(_predict_with_ctx())
        except MicroserviceError as e:  # the ingress fast-fail (DEADLINE_EXCEEDED)
            out = failure_message(e, msg.meta.puid)
        return self.gateway.finalize_response(out, msg, svc).to_proto()

    def send_feedback(self, request: pb.Feedback, context) -> pb.SeldonMessage:
        from seldon_core_tpu_torch.engine.service import failure_message

        self._check_auth(context)
        fb = InternalFeedback.from_proto(request)
        ctx, budget = _ingress(context)

        async def _feedback_with_ctx():
            with activate_context(ctx), _deadlines.activate(budget):
                _deadlines.check("gateway grpc ingress Seldon/SendFeedback")
                return await self.gateway.send_feedback(fb)

        try:
            out = self._bridge(_feedback_with_ctx())
        except MicroserviceError as e:  # the ingress fast-fail (DEADLINE_EXCEEDED)
            out = failure_message(e, fb.request.meta.puid if fb.request else "")
        return out.to_proto()

    def generate_stream(self, request: pb.SeldonMessage, context):
        """Token streaming (server-streaming ``Seldon/GenerateStream``,
        JAX ``engine/sync_server.py:131-191``): one prompt in, a
        SeldonMessage of newly decoded token ids out per engine chunk.
        A client that cancels closes the generator, which frees the
        engine stream's slot and pages."""
        self._check_auth(context)
        msg = InternalMessage.from_proto(request)
        gen_fn = stream_fn(self.gateway.pick())
        if gen_fn is None:
            context.abort(grpc.StatusCode.UNIMPLEMENTED, GENERATE_STREAM_UNSUPPORTED)
        meta = {"tags": stream_tags(msg, context.invocation_metadata() or ()), "puid": msg.meta.puid}
        it = gen_fn(np.asarray(msg.host_payload()), [], meta=meta)
        try:
            for chunk in it:
                out = InternalMessage(payload=np.asarray(chunk)[None, :], kind="ndarray")
                out.meta.puid = msg.meta.puid
                yield out.to_proto()
        except MicroserviceError as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT if 400 <= e.status_code < 500
                          else grpc.StatusCode.INTERNAL, str(e))
        finally:
            it.close()

    def predict_stream(self, request_iterator, context):
        """Chunked predict: reassemble on the handler thread, run the
        ordinary predict path, stream the reply back in chunks.  Bounded
        by the stream lane's own total-size cap."""
        self._check_auth(context)
        parts = []
        total = 0
        for chunk in request_iterator:
            total += len(chunk.data)
            if total > services.STREAM_MAX_BYTES:
                context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, f"stream exceeds {services.STREAM_MAX_BYTES} bytes")
            parts.append(chunk.data)
        reply = self.predict(pb.SeldonMessage.FromString(b"".join(parts)), context)
        yield from services.chunk_message(reply)


def build_sync_seldon_server(
    gateway,
    loop: asyncio.AbstractEventLoop,
    max_workers: int = 64,
    max_message_bytes: int = DEFAULT_MAX_MSG_BYTES,
    auth=None,
) -> grpc.Server:
    """``auth`` (``utils.auth.OAuthConfig``) requires bearer tokens."""
    issuer = None
    if auth is not None:
        from seldon_core_tpu_torch.utils.auth import TokenIssuer

        issuer = TokenIssuer(auth)
    service = SyncSeldonService(gateway, loop, issuer=issuer)
    server = grpc.server(
        futures.ThreadPoolExecutor(max_workers=max_workers, thread_name_prefix="seldon-grpc"),
        options=message_size_options(max_message_bytes),
    )
    server.add_generic_rpc_handlers(
        (
            services.generic_handler(
                "Seldon",
                {
                    "Predict": service.predict,
                    "SendFeedback": service.send_feedback,
                    "PredictStream": service.predict_stream,
                    "GenerateStream": service.generate_stream,
                },
            ),
        )
    )
    return server
