"""REST server for a single graph-node microservice.

aiohttp application exposing the reference wrapper's endpoint surface
(reference: python/seldon_core/wrapper.py:21-98) that this slice of the
port serves:

    POST /predict
    GET  /health/ping  /health/status  /metrics

Requests are JSON bodies (or a ``json`` query field).  Payload stays in
plain-dict form end-to-end — no proto round-trip on the REST path.
Error bodies match the JAX package: a component's MicroserviceError
carries its own code and reason (e.g. 400 ``BAD_INPUT_SHAPE``), an
undecodable payload is 400 ``BAD_PAYLOAD``, anything else is 500
``MICROSERVICE_INTERNAL_ERROR``.
"""

from __future__ import annotations

import json
import logging
from typing import Any, Dict

from aiohttp import web

from seldon_core_tpu_torch.codec.tensor import PayloadError
from seldon_core_tpu_torch.runtime import component as comp
from seldon_core_tpu_torch.runtime import dispatch
from seldon_core_tpu_torch.runtime.component import MicroserviceError
from seldon_core_tpu_torch.runtime.executor_pool import run_dispatch
from seldon_core_tpu_torch.runtime.message import InternalMessage

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


def prometheus_text(user_model: Any) -> str:
    """The component's custom metrics in Prometheus text exposition:
    COUNTER as counter, GAUGE as gauge, TIMER as a gauge in ms."""
    lines = []
    typed = set()
    for m in comp.get_custom_metrics(user_model) or []:
        name = m["key"]
        kind = "counter" if m["type"] == comp.COUNTER else "gauge"
        labels = ",".join(f'{k}="{v}"' for k, v in sorted((m.get("tags") or {}).items()))
        if name not in typed:
            typed.add(name)
            lines.append(f"# TYPE {name} {kind}")
        lines.append(f"{name}{{{labels}}} {float(m['value'])!r}" if labels else f"{name} {float(m['value'])!r}")
    return "\n".join(lines) + "\n"


def build_app(user_model: Any) -> web.Application:
    app = web.Application(client_max_size=1024 * 1024 * 512)

    async def predict_handler(request: web.Request) -> web.Response:
        try:
            msg = InternalMessage.from_json(await _request_body(request))
            out = await dispatch.predict_async(user_model, msg)
            return web.json_response(out.to_json())
        except Exception as e:  # noqa: BLE001 — every error must map to a Status
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

    app.router.add_post("/predict", predict_handler)
    app.router.add_get("/predict", predict_handler)
    app.router.add_get("/health/ping", ping)
    app.router.add_get("/health/status", status)
    app.router.add_get("/metrics", metrics_endpoint)
    return app


async def serve(app: web.Application, host: str = "0.0.0.0", port: int = 9000) -> web.AppRunner:
    """Start serving an app; returns the runner for cleanup."""
    runner = web.AppRunner(app, access_log=None)
    await runner.setup()
    await web.TCPSite(runner, host, port).start()
    return runner
