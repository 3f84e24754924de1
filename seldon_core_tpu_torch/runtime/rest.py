"""REST server for a single graph-node microservice.

aiohttp application exposing the reference wrapper's endpoint surface
(reference: python/seldon_core/wrapper.py:21-98):

    POST /predict  /transform-input  /transform-output
         /route    /aggregate       /send-feedback
         /api/v0.1/predictions (alias of /predict)
    GET  /health/ping  /health/status  /metrics  /seldon.json

plus a component's ``custom_routes``.  Requests are JSON bodies (or a
``json`` query field).  Payload stays in plain-dict form end-to-end — no
proto round-trip on the REST path.  Error bodies match the JAX package:
a component's MicroserviceError carries its own code and reason (e.g.
400 ``BAD_INPUT_SHAPE``), an undecodable payload is 400 ``BAD_PAYLOAD``,
anything else is 500 ``MICROSERVICE_INTERNAL_ERROR``.  Multipart bodies
and the caller's trace context and deadline are not ported
(``ROADMAP.md`` §A item 4); ``/metrics`` is a hand-built text of the
component's custom metrics.
"""

from __future__ import annotations

import asyncio
import json
import logging
from typing import Any, Callable, Dict, Mapping, Optional

from aiohttp import web

from seldon_core_tpu_torch.codec.tensor import PayloadError
from seldon_core_tpu_torch.runtime import component as comp
from seldon_core_tpu_torch.runtime import dispatch
from seldon_core_tpu_torch.runtime.component import MicroserviceError
from seldon_core_tpu_torch.runtime.executor_pool import run_dispatch
from seldon_core_tpu_torch.runtime.message import InternalFeedback, InternalMessage
from seldon_core_tpu_torch.utils.deadlines import extract_adapter

logger = logging.getLogger(__name__)


def _loads_400(text: Any, what: str) -> Any:
    """json.loads that maps client syntax errors to 400, not 500."""
    try:
        return json.loads(text)
    except json.JSONDecodeError as e:
        raise MicroserviceError(f"{what} is not valid JSON: {e}", status_code=400, reason="BAD_REQUEST")


async def _request_body(request: web.Request) -> Dict[str, Any]:
    """JSON body, else a ``json`` query field."""
    if request.method == "POST" and request.can_read_body:
        return _loads_400(await request.text(), "request body")
    if "json" in request.query:
        return _loads_400(request.query["json"], "query field 'json'")
    raise MicroserviceError("empty request body", status_code=400, reason="BAD_REQUEST")


def _error_response(e: Exception) -> web.Response:
    if isinstance(e, MicroserviceError):
        return web.json_response({"status": e.to_status()}, status=e.status_code)
    if isinstance(e, PayloadError):
        # undecodable payload is the client's error, not a server fault
        body = {"status": {"status": "FAILURE", "code": 400, "info": str(e), "reason": "BAD_PAYLOAD"}}
        return web.json_response(body, status=400)
    logger.exception("unhandled microservice error")
    body = {"status": {"status": "FAILURE", "code": 500, "info": str(e), "reason": "MICROSERVICE_INTERNAL_ERROR"}}
    return web.json_response(body, status=500)


def prometheus_text(user_model: Any, labels: Optional[Mapping[str, str]] = None) -> str:
    """The component's custom metrics in Prometheus text exposition:
    COUNTER as counter, GAUGE as gauge, TIMER as a gauge in ms.
    ``labels`` are added to every sample (the gateway names the unit)."""
    lines = []
    typed = set()
    for m in comp.get_custom_metrics(user_model) or []:
        name = m["key"]
        kind = "counter" if m["type"] == comp.COUNTER else "gauge"
        tags = {**(m.get("tags") or {}), **(labels or {})}
        label_text = ",".join(f'{k}="{v}"' for k, v in sorted(tags.items()))
        if name not in typed:
            typed.add(name)
            lines.append(f"# TYPE {name} {kind}")
        value = float(m["value"])
        lines.append(f"{name}{{{label_text}}} {value!r}" if label_text else f"{name} {value!r}")
    return "\n".join(lines) + "\n"


def _custom_endpoint(user_handler: Callable) -> Callable:
    """Wrap a user custom-route handler: aiohttp Responses pass
    through, anything else JSON-serialises, errors map to Status.
    Sync handlers run on the dispatch pool — they are expected to
    block, and must not freeze the event loop."""

    async def handler(request: web.Request) -> web.Response:
        try:
            if asyncio.iscoroutinefunction(user_handler):
                result = await user_handler(request)
            else:
                result = await run_dispatch(user_handler, request)
                if asyncio.iscoroutine(result):  # sync fn returned a coroutine
                    result = await result
            if isinstance(result, web.Response):
                return result
            return web.json_response(result)
        except Exception as e:  # noqa: BLE001
            return _error_response(e)

    return handler


def _message_endpoint(user_model: Any, fn: Callable) -> Callable:
    async def handler(request: web.Request) -> web.Response:
        try:
            msg = InternalMessage.from_json(await _request_body(request))
            # X-Seldon-Adapter selects the LoRA weight set; the component
            # reads meta.tags.adapter, and an explicit body tag wins
            adapter = extract_adapter(request.headers)
            if adapter and "adapter" not in msg.meta.tags:
                msg.meta.tags["adapter"] = adapter
            if fn is dispatch.predict:  # async fast path for batched models
                out = await dispatch.predict_async(user_model, msg)
            else:
                out = await run_dispatch(fn, user_model, msg)
            return web.json_response(out.to_json())
        except Exception as e:  # noqa: BLE001 — every error must map to a Status
            return _error_response(e)

    return handler


def build_app(user_model: Any, unit_id: str = "") -> web.Application:
    app = web.Application(client_max_size=1024 * 1024 * 512)

    async def aggregate_handler(request: web.Request) -> web.Response:
        try:
            body = await _request_body(request)
            raw_list = body.get("seldonMessages", []) if isinstance(body, dict) else body
            msgs = [InternalMessage.from_json(b) for b in raw_list]
            out = await run_dispatch(dispatch.aggregate, user_model, msgs)
            return web.json_response(out.to_json())
        except Exception as e:  # noqa: BLE001
            return _error_response(e)

    async def feedback_handler(request: web.Request) -> web.Response:
        try:
            fb = InternalFeedback.from_json(await _request_body(request))
            out = await run_dispatch(dispatch.send_feedback, user_model, fb, unit_id)
            return web.json_response(out.to_json())
        except Exception as e:  # noqa: BLE001
            return _error_response(e)

    async def ping(_request: web.Request) -> web.Response:
        return web.Response(text="pong")

    async def status(_request: web.Request) -> web.Response:
        try:
            out = await run_dispatch(dispatch.health_check, user_model)
            return web.json_response(out.to_json())
        except Exception as e:  # noqa: BLE001
            return _error_response(e)

    async def metrics_endpoint(_request: web.Request) -> web.Response:
        try:
            text = await run_dispatch(prometheus_text, user_model)
        except Exception as e:  # noqa: BLE001
            return _error_response(e)
        return web.Response(text=text, content_type="text/plain")

    async def openapi_endpoint(_request: web.Request) -> web.Response:
        from seldon_core_tpu_torch.runtime.openapi import wrapper_openapi

        return web.json_response(wrapper_openapi())

    for path, fn in (
        ("/predict", dispatch.predict),
        ("/api/v0.1/predictions", dispatch.predict),  # engine-compatible alias
        ("/transform-input", dispatch.transform_input),
        ("/transform-output", dispatch.transform_output),
        ("/route", dispatch.route),
    ):
        handler = _message_endpoint(user_model, fn)
        app.router.add_post(path, handler)
        app.router.add_get(path, handler)
    app.router.add_post("/aggregate", aggregate_handler)
    app.router.add_get("/aggregate", aggregate_handler)
    app.router.add_post("/send-feedback", feedback_handler)
    app.router.add_get("/send-feedback", feedback_handler)
    app.router.add_get("/health/ping", ping)
    app.router.add_get("/health/status", status)
    app.router.add_get("/metrics", metrics_endpoint)
    app.router.add_get("/seldon.json", openapi_endpoint)

    # component-declared endpoints (reference analogue: custom_service
    # second process exposing user routes)
    custom = getattr(user_model, "custom_routes", None)
    if callable(custom):
        for path, user_handler in (custom() or {}).items():
            app.router.add_route("*", path, _custom_endpoint(user_handler))
    return app


async def serve(app: web.Application, host: str = "0.0.0.0", port: int = 9000) -> web.AppRunner:
    """Start serving an app; returns the runner for cleanup."""
    runner = web.AppRunner(app, access_log=None)
    await runner.setup()
    await web.TCPSite(runner, host, port).start()
    return runner
