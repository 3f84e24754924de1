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
  Context variables do not cross that bridge.

``GenerateStream`` answers UNIMPLEMENTED: token streaming is not ported
(``ROADMAP.md`` §A item 8.6).
"""

from __future__ import annotations

import asyncio
import logging
from concurrent import futures

import grpc

from seldon_core_tpu_torch.proto import pb, services
from seldon_core_tpu_torch.runtime.grpc_server import DEFAULT_MAX_MSG_BYTES, message_size_options
from seldon_core_tpu_torch.runtime.message import InternalFeedback, InternalMessage

logger = logging.getLogger(__name__)

GENERATE_STREAM_LATER = (
    "Seldon/GenerateStream (token streaming) is not ported yet: it comes with ROADMAP.md §A item 8.6"
)


class SyncSeldonService:
    def __init__(self, gateway, loop: asyncio.AbstractEventLoop):
        self.gateway = gateway
        self.loop = loop

    def _bridge(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result()

    def predict(self, request: pb.SeldonMessage, context) -> pb.SeldonMessage:
        msg = InternalMessage.from_proto(request)
        svc = self.gateway.pick()
        if self.gateway.shadows:
            # isolated copies, fired on the loop: primary and shadow both mutate meta
            self.loop.call_soon_threadsafe(self.gateway.shadow, msg.copy())
        if svc.single_local_model() is not None:
            out = svc.predict_sync(msg)
        else:
            out = self._bridge(svc.predict(msg))
        return self.gateway.finalize_response(out, msg, svc).to_proto()

    def send_feedback(self, request: pb.Feedback, context) -> pb.SeldonMessage:
        return self._bridge(self.gateway.send_feedback(InternalFeedback.from_proto(request))).to_proto()

    def generate_stream(self, request: pb.SeldonMessage, context):
        context.abort(grpc.StatusCode.UNIMPLEMENTED, GENERATE_STREAM_LATER)
        yield  # pragma: no cover — a generator, as the RPC is server-streaming

    def predict_stream(self, request_iterator, context):
        """Chunked predict: reassemble on the handler thread, run the
        ordinary predict path, stream the reply back in chunks.  Bounded
        by the stream lane's own total-size cap."""
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
) -> grpc.Server:
    service = SyncSeldonService(gateway, loop)
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
