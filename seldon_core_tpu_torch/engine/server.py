"""Orchestrator front server: external REST + gRPC around predictors.

The ingress-facing shell of the data plane, equivalent to the reference
engine's controllers (reference: RestClientController.java:127-268,
SeldonGrpcServer.java:30-60, SeldonService.java:30-67):

    POST /api/v0.1/predictions   POST /api/v0.1/feedback
    POST /api/v0.1/generate/stream
    GET  /ping /ready /live      PUT/POST /pause /unpause
    GET  /metrics /seldon.json
    gRPC seldon.protos.Seldon/Predict, /SendFeedback, /PredictStream,
         /GenerateStream

A ``Gateway`` fronts one *deployment* = several predictors with traffic
weights (canary / A-B across predictors, the reference's Istio
VirtualService weight semantics,
reference: seldondeployment_controller.go:171-239) plus optional shadow
traffic (reference: ambassador.go:50-133).

Every ingress carries the request contract: ``X-Seldon-Deadline-Ms``
mints the end-to-end budget (a spent one answers 504
``DEADLINE_EXCEEDED`` naming the hop), ``X-Seldon-Priority`` and
``X-Seldon-Adapter`` land in ``meta.tags`` (a body tag wins), and a
``traceparent`` makes the gateway's spans children of the caller's.
``build_gateway_app(gateway, auth=)`` requires ``Authorization: Bearer``
tokens from the gateway's own ``/oauth/token`` (the client-credentials
grant) on the data and admin endpoints, and ``serve_gateway(..., tls=,
auth=)`` puts TLS and the same tokens on both listeners.  ``/metrics``
is the metrics registry (``utils/metrics.py``: the observer's
``seldon_api_engine_*`` series, the transport hops) plus the gateway's
per-predictor counts and, for a predictor without an observer, its
local components' custom metrics.

Token streaming: ``POST /api/v0.1/generate/stream`` (Server-Sent
Events) and ``Seldon/GenerateStream`` serve a single-local-model
predictor's ``predict_stream`` (``StreamingLM``).

Not ported: the debug endpoints (``ROADMAP.md`` §A item 8.11),
explanations (§A item 11), and the ``grpc.aio`` front end: gRPC is
served by the sync server of ``engine/sync_server.py`` alone (queued in
``ROADMAP.md`` §A until a deployment needs it).  Breakers, hedging,
fallbacks and replica balancing run in the engine
(``engine/{transport,executor}.py``) behind every listener.
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
from seldon_core_tpu_torch.engine.sync_server import build_sync_seldon_server, stream_fn, stream_tags
from seldon_core_tpu_torch.runtime import component as comp
from seldon_core_tpu_torch.runtime.grpc_server import DEFAULT_MAX_MSG_BYTES
from seldon_core_tpu_torch.runtime.message import InternalFeedback, InternalMessage
from seldon_core_tpu_torch.runtime.rest import _error_response, _ingress, _request_body
from seldon_core_tpu_torch.utils import deadlines as _deadlines
from seldon_core_tpu_torch.utils import metrics as _metrics

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
            _metrics.increment_counter(
                "seldon_api_gateway_feedback_unrouted",
                "feedback messages dropped because the serving predictor could not be identified",
            )
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

    def _stats_families(self) -> List[_metrics.FamilySnapshot]:
        """Per-predictor request / failure / feedback counts."""
        out = []
        for key in ("requests", "failures", "feedback"):
            name = f"seldon_api_gateway_{key}_total"
            samples = [(name, (("predictor", svc.name),), float(svc.stats[key])) for svc in self.predictors]
            out.append((name, "counter", f"gateway {key} per predictor", samples))
        return out

    def _component_families(self) -> List[_metrics.FamilySnapshot]:
        """Custom metrics of the local components of every predictor
        without an observer, labelled with its predictor and unit (an
        observer re-registers them with the reference's labels)."""
        merged: dict = {}
        for svc in self.predictors:
            if svc.executor.observer is not None:
                continue
            for unit in svc.graph.walk():
                component = svc.executor.component(unit.name)
                if component is None:
                    continue
                for name, kind, doc, samples in _metrics.custom_metric_families(
                        comp.get_custom_metrics(component) or [], labels={"predictor": svc.name, "unit": unit.name}):
                    merged.setdefault(name, (name, kind, doc, []))[3].extend(samples)
        return list(merged.values())

    def metrics_exposition(self) -> bytes:
        """The ``/metrics`` body of this gateway, on every listener."""
        return _metrics.generate_latest(collectors=(self._stats_families, self._component_families))


def _http_status(out: InternalMessage) -> int:
    """HTTP code for a gateway response: FAILURE statuses surface their
    code (clamped to a valid HTTP error range), everything else is 200."""
    if out.status and out.status.get("status") == "FAILURE":
        code = int(out.status.get("code", 500))
        return code if 400 <= code < 600 else 500
    return 200


def build_gateway_app(gateway: Gateway, auth=None) -> web.Application:
    """``auth`` is a ``utils.auth.OAuthConfig``: when set, the data
    endpoints and the admin verbs need ``Authorization: Bearer`` tokens
    issued by this gateway's ``/oauth/token`` (client-credentials grant,
    reference: seldon_client.py:1186-1227).  Probes, ``/metrics``,
    ``/seldon.json`` and ``/oauth/token`` stay open."""
    middlewares = []
    issuer = None
    if auth is not None:
        from seldon_core_tpu_torch.utils.auth import UNAUTHENTICATED_MSG, TokenIssuer

        issuer = TokenIssuer(auth)

        @web.middleware
        async def require_token(request: web.Request, handler):
            guarded = request.path.startswith("/api/") or request.path in ("/predict", "/pause", "/unpause")
            if guarded and not issuer.verify_header(request.headers.get("Authorization")):
                resp = web.json_response(
                    {"status": {"status": "FAILURE", "code": 401, "info": UNAUTHENTICATED_MSG,
                                "reason": "UNAUTHORIZED"}},
                    status=401,
                )
                # drain a small declared body (the keep-alive socket stays
                # usable); a body-less request has nothing to drain; only an
                # unsized or oversized upload forces a close, since buffering
                # it for a 401 would pay for bytes being rejected
                cl = request.content_length
                chunked = "chunked" in request.headers.get("Transfer-Encoding", "").lower()
                if cl is not None and cl <= 1 << 20:
                    await request.read()
                elif cl is not None or chunked:
                    resp.force_close()
                return resp
            return await handler(request)

        middlewares.append(require_token)
    app = web.Application(client_max_size=DEFAULT_MAX_MSG_BYTES, middlewares=middlewares)

    if issuer is not None:
        from seldon_core_tpu_torch.utils.auth import parse_basic_auth

        async def oauth_token(request: web.Request) -> web.Response:
            creds = parse_basic_auth(request.headers.get("Authorization"))
            if creds is None or not issuer.check_credentials(*creds):
                return web.json_response({"error": "invalid_client"}, status=401)
            return web.json_response(issuer.issue())

        app.router.add_post("/oauth/token", oauth_token)

    async def predictions(request: web.Request) -> web.Response:
        try:
            msg = InternalMessage.from_json(await _request_body(request))
            # X-Seldon-Priority and X-Seldon-Adapter land in meta.tags;
            # an explicit tag in the body wins
            prio = _deadlines.extract_priority(request.headers)
            if prio is not None and "priority" not in msg.meta.tags:
                msg.meta.tags["priority"] = prio
            adapter = _deadlines.extract_adapter(request.headers)
            if adapter and "adapter" not in msg.meta.tags:
                msg.meta.tags["adapter"] = adapter
            # the caller's traceparent parents the predictor.predict span;
            # the deadline budget rides every hop below
            with _ingress(request):
                _deadlines.check("gateway ingress /api/v0.1/predictions")
                out = await gateway.predict(msg, predictor=request.query.get("predictor"))
            return web.json_response(out.to_json(), status=_http_status(out))
        except Exception as e:  # noqa: BLE001
            return _error_response(e)

    async def feedback(request: web.Request) -> web.Response:
        try:
            fb = InternalFeedback.from_json(await _request_body(request))
            # feedback is exempt from retries, not from the ingress contract
            with _ingress(request):
                _deadlines.check("gateway ingress /api/v0.1/feedback")
                out = await gateway.send_feedback(fb)
            return web.json_response(out.to_json(), status=_http_status(out))
        except Exception as e:  # noqa: BLE001
            return _error_response(e)

    async def generate_stream_sse(request: web.Request) -> web.StreamResponse:
        """Token streaming over HTTP: Server-Sent Events, one ``data:
        {"tokens": [...]}`` event per engine chunk, then ``event: end``
        with the puid (the REST twin of ``Seldon/GenerateStream``, JAX
        ``engine/server.py:360-459``).  The first chunk is pulled before
        the headers go out, so a bad prompt, a shed or a spent deadline
        answers an HTTP error, not a 200 stream."""
        import json

        import numpy as np

        try:
            msg = InternalMessage.from_json(await _request_body(request))
        except Exception as e:  # noqa: BLE001
            return _error_response(e)
        svc = gateway.by_name(request.query.get("predictor", "")) or gateway.pick()
        gen_fn = stream_fn(svc)
        if gen_fn is None:
            return web.json_response(
                {"status": {"status": "FAILURE", "code": 501,
                            "info": "token streaming needs a single-local-model predictor whose component "
                                    "implements predict_stream (e.g. STREAMING_LM)",
                            "reason": "NOT_IMPLEMENTED"}},
                status=501,
            )
        # the generator runs on executor threads without this context, so
        # the SLO headers ride meta.tags (a body tag wins), the deadline
        # minted absolute here: a relative one re-minted at submit would
        # refund the executor's queueing time
        meta = {"tags": stream_tags(msg, request.headers), "puid": msg.meta.puid}
        loop = asyncio.get_running_loop()
        end = object()
        try:
            it = gen_fn(np.asarray(msg.host_payload()), [], meta=meta)
            first = await loop.run_in_executor(None, next, it, end)
        except Exception as e:  # noqa: BLE001
            return _error_response(e)
        resp = web.StreamResponse(headers={"Content-Type": "text/event-stream", "Cache-Control": "no-cache"})
        try:
            await resp.prepare(request)
            chunk = first
            while True:
                if chunk is end:
                    await resp.write(f"event: end\ndata: {json.dumps({'puid': msg.meta.puid})}\n\n".encode())
                    break
                await resp.write(f"data: {json.dumps({'tokens': np.asarray(chunk).tolist()})}\n\n".encode())
                try:
                    chunk = await loop.run_in_executor(None, next, it, end)
                except comp.MicroserviceError as e:
                    await resp.write(f"event: error\ndata: {json.dumps(e.to_status())}\n\n".encode())
                    break
                except Exception as e:  # noqa: BLE001 — a mid-stream engine fault: an error event,
                    # never a silent truncation that reads as completion
                    status = {"status": "FAILURE", "code": 500, "info": str(e), "reason": "ENGINE_ERROR"}
                    await resp.write(f"event: error\ndata: {json.dumps(status)}\n\n".encode())
                    break
            await resp.write_eof()
        except ConnectionError:
            pass  # the client went away; closing the generator frees its stream
        finally:
            await loop.run_in_executor(None, it.close)
        return resp

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
            body = await run_dispatch(gateway.metrics_exposition)
        except Exception as e:  # noqa: BLE001
            return _error_response(e)
        return web.Response(body=body, content_type=_metrics.CONTENT_TYPE_LATEST.split(";")[0])

    async def openapi_endpoint(_r: web.Request) -> web.Response:
        from seldon_core_tpu_torch.runtime.openapi import gateway_openapi

        return web.json_response(gateway_openapi())

    app.router.add_get("/seldon.json", openapi_endpoint)
    app.router.add_post("/api/v0.1/predictions", predictions)
    app.router.add_get("/api/v0.1/predictions", predictions)
    app.router.add_post("/predict", predictions)  # convenience alias
    app.router.add_post("/api/v0.1/feedback", feedback)
    app.router.add_post("/api/v0.1/generate/stream", generate_stream_sse)
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
    tls=None,
    auth=None,
):
    """Start the REST front server and the sync gRPC one; returns
    (runner, GrpcServerHandle).  ``tls`` (``utils.tls.TlsConfig``)
    terminates TLS and ``auth`` (``utils.auth.OAuthConfig``) requires
    bearer tokens on both listeners.  Await it inside the running loop
    that the sync server bridges into."""
    from seldon_core_tpu_torch.runtime import rest
    from seldon_core_tpu_torch.utils.tls import add_grpc_port

    runner = await rest.serve(build_gateway_app(gateway, auth=auth), host=host, port=http_port, tls=tls)
    server = build_sync_seldon_server(gateway, asyncio.get_running_loop(), max_message_bytes=max_message_bytes,
                                      auth=auth)
    add_grpc_port(server, f"{host}:{grpc_port}", tls)
    server.start()
    return runner, GrpcServerHandle(server)
