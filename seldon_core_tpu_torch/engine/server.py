"""Orchestrator front server: external REST + gRPC around predictors.

The ingress-facing shell of the data plane, equivalent to the reference
engine's controllers (reference: RestClientController.java:127-268,
SeldonGrpcServer.java:30-60, SeldonService.java:30-67):

    POST /api/v0.1/predictions   POST /api/v0.1/feedback
    GET  /ping /ready /live      PUT/POST /pause /unpause
    GET  /metrics /seldon.json
    gRPC seldon.protos.Seldon/Predict, /SendFeedback, /PredictStream

A ``Gateway`` fronts one *deployment* = several predictors with traffic
weights (canary / A-B across predictors, the reference's Istio
VirtualService weight semantics,
reference: seldondeployment_controller.go:171-239) plus optional shadow
traffic (reference: ambassador.go:50-133).

Not ported: the debug endpoints (``ROADMAP.md`` §A item 8.11),
explanations (§A item 11), token streaming over SSE and
``Seldon/GenerateStream`` (§A item 8.6: the RPC answers UNIMPLEMENTED),
auth, TLS, the caller's trace context and deadline (§A item 4), and the
``grpc.aio`` front end: gRPC is served by the sync server of
``engine/sync_server.py`` alone (§A item 2.2).
``/metrics`` is a hand-built text: the gateway's counters and each local
component's custom metrics.
"""

from __future__ import annotations

import asyncio
import logging
import random
import threading
from collections import OrderedDict
from typing import List, Optional, Sequence, Set, Tuple

import grpc
from aiohttp import web

from seldon_core_tpu_torch.engine.service import PredictorService
from seldon_core_tpu_torch.engine.sync_server import build_sync_seldon_server
from seldon_core_tpu_torch.runtime.grpc_server import DEFAULT_MAX_MSG_BYTES
from seldon_core_tpu_torch.runtime.message import InternalFeedback, InternalMessage
from seldon_core_tpu_torch.runtime.rest import _error_response, _request_body, prometheus_text
from seldon_core_tpu_torch.utils.deadlines import extract_adapter

logger = logging.getLogger(__name__)

class Gateway:
    """Weighted traffic split across predictors of one deployment."""

    def __init__(
        self,
        predictors: Sequence[Tuple[PredictorService, float]],
        shadows: Sequence[PredictorService] = (),
        seed: Optional[int] = None,
    ):
        if not predictors:
            raise ValueError("gateway needs at least one predictor")
        self.entries: List[Tuple[PredictorService, float]] = list(predictors)
        total = sum(w for _, w in self.entries)
        if total <= 0:  # all-zero weights -> uniform
            self.entries = [(p, 1.0) for p, _ in self.entries]
            total = float(len(self.entries))
        self._weights = [w / total for _, w in self.entries]
        self.shadows = list(shadows)
        self._rng = random.Random(seed)
        # puid -> serving predictor name, so feedback can be routed to
        # the predictor that actually served the request (reference
        # semantics: PredictiveUnitBean.java:206-246 follows the
        # recorded routing; broadcasting would teach every predictor's
        # MAB from traffic it never saw).  Bounded FIFO eviction.
        self._served: "OrderedDict[str, str]" = OrderedDict()
        self._served_cap = 65536
        self._served_lock = threading.Lock()
        self.unrouted_feedback = 0
        # strong refs to in-flight shadow tasks: the loop holds tasks weakly
        self._shadow_tasks: Set[asyncio.Future] = set()

    def _record_served(self, puid: str, predictor: str) -> None:
        if not puid:
            return
        with self._served_lock:
            self._served[puid] = predictor
            while len(self._served) > self._served_cap:
                self._served.popitem(last=False)

    def finalize_response(self, response: InternalMessage, request: InternalMessage,
                          svc: PredictorService) -> InternalMessage:
        """Stamp the serving predictor on the response and record the
        puid→predictor mapping — one helper shared by the async and
        sync ingress paths so they cannot drift.  The tag is assigned
        unconditionally: a request may arrive with a stale client-echoed
        `predictor` tag that would otherwise misroute feedback."""
        response.meta.tags["predictor"] = svc.name
        self._record_served(response.meta.puid or request.meta.puid, svc.name)
        return response

    def _feedback_target(self, feedback: InternalFeedback) -> Optional[PredictorService]:
        """The predictor that served the request, if identifiable: by
        the `predictor` response tag, else by the recorded puid.  An
        unresolvable tag falls through to the puid lookup."""
        for msg in (feedback.response, feedback.request):
            if msg is None:
                continue
            name = msg.meta.tags.get("predictor")
            if name:
                svc = self.by_name(str(name))
                if svc is not None:
                    return svc
            if msg.meta.puid:
                with self._served_lock:
                    name = self._served.get(msg.meta.puid)
                if name:
                    svc = self.by_name(name)
                    if svc is not None:
                        return svc
        return None

    @property
    def predictors(self) -> List[PredictorService]:
        return [p for p, _ in self.entries]

    def pick(self) -> PredictorService:
        r = self._rng.random()
        acc = 0.0
        for (svc, _), w in zip(self.entries, self._weights):
            acc += w
            if r < acc:
                return svc
        return self.entries[-1][0]

    def by_name(self, name: str) -> Optional[PredictorService]:
        for svc in self.predictors:
            if svc.name == name:
                return svc
        return None

    def shadow(self, request: InternalMessage) -> None:
        """Fire-and-forget isolated copies to the shadows, responses
        dropped — the primary and shadows each mutate their own meta
        (puid assignment), never a shared one.  Runs on the loop."""
        for svc in self.shadows:
            task = asyncio.ensure_future(svc.predict(request.copy()))
            self._shadow_tasks.add(task)
            task.add_done_callback(self._shadow_tasks.discard)

    async def predict(self, request: InternalMessage, predictor: Optional[str] = None) -> InternalMessage:
        svc = self.by_name(predictor) if predictor else None
        if svc is None:
            svc = self.pick()
        self.shadow(request)
        response = await svc.predict(request)
        return self.finalize_response(response, request, svc)

    async def send_feedback(self, feedback: InternalFeedback) -> InternalMessage:
        # feedback goes ONLY to the predictor that served the request
        # (predictor tag or recorded puid).  Unidentifiable feedback is
        # a counted drop — never a broadcast, which would teach every
        # predictor's bandit from traffic it never served.
        target = self._feedback_target(feedback)
        if target is None and len(self.entries) == 1 and not self._has_identifiers(feedback):
            # single-predictor gateway AND the feedback never carried a
            # tag/puid: the route is unambiguous.  Feedback whose
            # identifiers failed to resolve still drops.
            target = self.entries[0][0]
        if target is None:
            logger.warning("dropping unroutable feedback (no predictor tag, puid unknown)")
            with self._served_lock:
                self.unrouted_feedback += 1
            return InternalMessage(
                payload=None,
                kind="jsonData",
                status={
                    "status": "FAILURE",
                    "code": 404,
                    "info": "feedback not routable: no predictor tag and puid unknown (expired or never served here)",
                    "reason": "FEEDBACK_UNROUTED",
                },
            )
        return await target.send_feedback(feedback)

    @staticmethod
    def _has_identifiers(feedback: InternalFeedback) -> bool:
        """True when the feedback carries any routing identifier (a
        predictor tag or a puid) on its response or request."""
        for msg in (feedback.response, feedback.request):
            if msg is not None and (msg.meta.tags.get("predictor") or msg.meta.puid):
                return True
        return False

    async def ready(self) -> bool:
        checks = await asyncio.gather(*(p.ready() for p in self.predictors))
        return all(checks)

    def pause(self) -> None:
        for p in self.predictors:
            p.pause()

    def unpause(self) -> None:
        for p in self.predictors:
            p.unpause()

    async def close(self) -> None:
        await asyncio.gather(*(p.close() for p in self.predictors))

    def metrics_text(self) -> str:
        """Prometheus text: per-predictor request / failure / feedback
        counts, unrouted feedback, and every local component's custom
        metrics labelled with its predictor and unit."""
        lines = ["# TYPE seldon_api_gateway_requests_total counter",
                 "# TYPE seldon_api_gateway_failures_total counter",
                 "# TYPE seldon_api_gateway_feedback_total counter"]
        for svc in self.predictors:
            for key in ("requests", "failures", "feedback"):
                lines.append(f'seldon_api_gateway_{key}_total{{predictor="{svc.name}"}} {svc.stats[key]}')
        lines += ["# TYPE seldon_api_gateway_feedback_unrouted counter",
                  f"seldon_api_gateway_feedback_unrouted {self.unrouted_feedback}"]
        typed = set()
        for svc in self.predictors:
            for unit in svc.graph.walk():
                component = svc.executor.component(unit.name)
                if component is None:
                    continue
                text = prometheus_text(component, labels={"predictor": svc.name, "unit": unit.name})
                for line in text.splitlines():
                    if line.startswith("# TYPE"):
                        if line in typed:
                            continue
                        typed.add(line)
                    lines.append(line)
        return "\n".join(lines) + "\n"


def _http_status(out: InternalMessage) -> int:
    """HTTP code for a gateway response: FAILURE statuses surface their
    code (clamped to a valid HTTP error range), everything else is 200."""
    if out.status and out.status.get("status") == "FAILURE":
        code = int(out.status.get("code", 500))
        return code if 400 <= code < 600 else 500
    return 200


def build_gateway_app(gateway: Gateway) -> web.Application:
    app = web.Application(client_max_size=DEFAULT_MAX_MSG_BYTES)

    async def predictions(request: web.Request) -> web.Response:
        try:
            msg = InternalMessage.from_json(await _request_body(request))
            # X-Seldon-Adapter selects the LoRA weight set; an explicit
            # tag in the body wins
            adapter = extract_adapter(request.headers)
            if adapter and "adapter" not in msg.meta.tags:
                msg.meta.tags["adapter"] = adapter
            out = await gateway.predict(msg, predictor=request.query.get("predictor"))
            return web.json_response(out.to_json(), status=_http_status(out))
        except Exception as e:  # noqa: BLE001
            return _error_response(e)

    async def feedback(request: web.Request) -> web.Response:
        try:
            fb = InternalFeedback.from_json(await _request_body(request))
            out = await gateway.send_feedback(fb)
            return web.json_response(out.to_json(), status=_http_status(out))
        except Exception as e:  # noqa: BLE001
            return _error_response(e)

    async def ping(_r: web.Request) -> web.Response:
        return web.Response(text="pong")

    async def live(_r: web.Request) -> web.Response:
        return web.Response(text="live")

    async def ready(_r: web.Request) -> web.Response:
        ok = await gateway.ready()
        return web.Response(text="ready" if ok else "not ready", status=200 if ok else 503)

    async def pause(_r: web.Request) -> web.Response:
        gateway.pause()
        return web.Response(text="paused")

    async def unpause(_r: web.Request) -> web.Response:
        gateway.unpause()
        return web.Response(text="unpaused")

    async def metrics_endpoint(_r: web.Request) -> web.Response:
        from seldon_core_tpu_torch.runtime.executor_pool import run_dispatch

        try:
            text = await run_dispatch(gateway.metrics_text)
        except Exception as e:  # noqa: BLE001
            return _error_response(e)
        return web.Response(text=text, content_type="text/plain")

    async def openapi_endpoint(_r: web.Request) -> web.Response:
        from seldon_core_tpu_torch.runtime.openapi import gateway_openapi

        return web.json_response(gateway_openapi())

    app.router.add_get("/seldon.json", openapi_endpoint)
    app.router.add_post("/api/v0.1/predictions", predictions)
    app.router.add_get("/api/v0.1/predictions", predictions)
    app.router.add_post("/predict", predictions)  # convenience alias
    app.router.add_post("/api/v0.1/feedback", feedback)
    app.router.add_get("/ping", ping)
    app.router.add_get("/live", live)
    app.router.add_get("/ready", ready)
    app.router.add_route("*", "/pause", pause)
    app.router.add_route("*", "/unpause", unpause)
    app.router.add_get("/metrics", metrics_endpoint)
    return app


class GrpcServerHandle:
    """Async facade over the sync gRPC server, so a caller on the loop
    stops it without blocking the loop."""

    def __init__(self, server: grpc.Server):
        self.server = server

    async def stop(self, grace=None):
        event = self.server.stop(grace)
        await asyncio.get_running_loop().run_in_executor(None, event.wait)


async def serve_gateway(
    gateway: Gateway,
    host: str = "0.0.0.0",
    http_port: int = 8000,
    grpc_port: int = 5001,
    max_message_bytes: int = DEFAULT_MAX_MSG_BYTES,
):
    """Start the REST front server and the sync gRPC one; returns
    (runner, GrpcServerHandle).  Await it inside the running loop that
    the sync server bridges into."""
    from seldon_core_tpu_torch.runtime import rest

    runner = await rest.serve(build_gateway_app(gateway), host=host, port=http_port)
    server = build_sync_seldon_server(gateway, asyncio.get_running_loop(), max_message_bytes=max_message_bytes)
    server.add_insecure_port(f"{host}:{grpc_port}")
    server.start()
    return runner, GrpcServerHandle(server)
