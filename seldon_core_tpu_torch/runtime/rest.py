"""REST server for a single graph-node microservice.

aiohttp application exposing the reference wrapper's endpoint surface
(reference: python/seldon_core/wrapper.py:21-98):

    POST /predict  /transform-input  /transform-output
         /route    /aggregate       /send-feedback
         /api/v0.1/predictions (alias of /predict)
    GET  /health/ping  /health/status  /metrics  /seldon.json

plus a component's ``custom_routes``.  Requests are JSON bodies, a
``json`` form or query field, or multipart form fields (the reference's
``flask_utils.get_request``).  Payload stays in plain-dict form
end-to-end — no proto round-trip on the REST path.  Error bodies match
the JAX package: a component's MicroserviceError carries its own code
and reason (e.g. 400 ``BAD_INPUT_SHAPE``), an undecodable payload is 400
``BAD_PAYLOAD``, anything else is 500 ``MICROSERVICE_INTERNAL_ERROR``.

Every endpoint is an ingress: it adopts the caller's ``traceparent``
(when tracing is on) and ``X-Seldon-Deadline-Ms`` budget, and fails a
spent budget with 504 ``DEADLINE_EXCEEDED`` before the model sees the
request.  ``serve(..., tls=)`` terminates HTTPS.  ``/metrics`` is the
metrics registry plus the component's custom metrics.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import logging
from typing import Any, Callable, Dict, Optional

from aiohttp import web

from seldon_core_tpu_torch.codec.tensor import PayloadError
from seldon_core_tpu_torch.runtime import component as comp
from seldon_core_tpu_torch.runtime import dispatch
from seldon_core_tpu_torch.runtime.component import MicroserviceError
from seldon_core_tpu_torch.runtime.executor_pool import run_dispatch
from seldon_core_tpu_torch.runtime.message import InternalFeedback, InternalMessage
from seldon_core_tpu_torch.utils import deadlines as _deadlines
from seldon_core_tpu_torch.utils import metrics as _metrics
from seldon_core_tpu_torch.utils import tracing as _tracing

logger = logging.getLogger(__name__)


def _loads_400(text: Any, what: str) -> Any:
    """json.loads that maps client syntax errors to 400, not 500."""
    try:
        return json.loads(text)
    except json.JSONDecodeError as e:
        raise MicroserviceError(f"{what} is not valid JSON: {e}", status_code=400, reason="BAD_REQUEST")


async def _multipart_body(request: web.Request) -> Dict[str, Any]:
    """multipart/form-data request: every top-level message key is a
    form field (reference: flask_utils.get_multi_form_data_request).

    A field means the same thing whether sent as text or as a file
    upload: ``strData`` is taken literally, ``binData`` (file only)
    stays raw bytes, every other key is JSON-parsed.  A lone ``json``
    field carries the whole message."""
    form = await request.post()
    keys = list(form.keys())
    if "json" in keys:
        # the whole message in one field; mixing it with per-key fields
        # is ambiguous and rejected
        if len(keys) > 1:
            raise MicroserviceError(
                "multipart request mixes a 'json' field with message-key fields",
                status_code=400,
                reason="BAD_REQUEST",
            )
        val = form["json"]
        if isinstance(val, web.FileField):  # json=@file.json upload
            val = val.file.read()
        return _loads_400(val, "multipart field 'json'")
    out: Dict[str, Any] = {}
    for key, val in form.items():
        if isinstance(val, web.FileField):
            data = val.file.read()
            if key == "binData":
                out[key] = data
                continue
            try:
                text = data.decode("utf-8")
            except UnicodeDecodeError:
                raise MicroserviceError(
                    f"multipart file field {key!r} is not utf-8 (binary payloads go in 'binData')",
                    status_code=400,
                    reason="BAD_REQUEST",
                )
            # a file upload carries the same content its text-field twin
            # would: strData stays literal, JSON keys are parsed
            out[key] = text if key == "strData" else _loads_400(text, f"multipart file field {key!r}")
        elif key == "strData":
            out[key] = val
        else:
            out[key] = _loads_400(val, f"multipart field {key!r}")
    if not out:
        raise MicroserviceError("empty multipart request", status_code=400, reason="BAD_REQUEST")
    return out


async def _request_body(request: web.Request) -> Dict[str, Any]:
    """JSON body, a ``json`` field in form or query, or multipart fields
    (reference: flask_utils.get_request semantics)."""
    if request.content_type == "application/json":
        return _loads_400(await request.text(), "JSON body")
    if request.content_type and request.content_type.startswith("multipart/form-data"):
        return await _multipart_body(request)
    if request.method == "POST":
        form = await request.post()
        if "json" in form:
            return _loads_400(form["json"], "form field 'json'")
        text = await request.text()  # raw body fallback
        if text:
            return _loads_400(text, "request body")
    if "json" in request.query:
        return _loads_400(request.query["json"], "query field 'json'")
    raise MicroserviceError("empty request body", status_code=400, reason="BAD_REQUEST")


def _remote_ctx(request: web.Request) -> Optional[_tracing.SpanContext]:
    """The caller's W3C span context from the HTTP headers, if tracing is
    on (the body-meta carrier is handled at dispatch).  One global read
    when off."""
    if _tracing.get_tracer() is None:
        return None
    return _tracing.extract(request.headers)


def _remote_deadline_ms(request: web.Request) -> Optional[float]:
    """The caller's remaining end-to-end budget from the
    ``X-Seldon-Deadline-Ms`` header (None when absent or malformed)."""
    return _deadlines.extract_ms(request.headers)


@contextlib.contextmanager
def _ingress(request: web.Request):
    """The ingress contract of one request: adopt the caller's trace and
    budget for the enclosed scope (pair with ``_deadlines.check``)."""
    with _tracing.activate_context(_remote_ctx(request)), _deadlines.activate_ms(_remote_deadline_ms(request)):
        yield


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


def component_collector(user_model: Any) -> _metrics.Collector:
    """The component's custom metrics as a scrape-time collector."""
    return lambda: _metrics.custom_metric_families(comp.get_custom_metrics(user_model) or [])


def _custom_endpoint(user_handler: Callable) -> Callable:
    """Wrap a user custom-route handler: aiohttp Responses pass
    through, anything else JSON-serialises, errors map to Status.
    Sync handlers run on the dispatch pool — they are expected to
    block, and must not freeze the event loop."""

    async def handler(request: web.Request) -> web.Response:
        try:
            # custom routes are ingress too: the user handler inherits the
            # caller's trace and budget
            with _ingress(request):
                _deadlines.check(f"microservice ingress {request.path}")
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
            adapter = _deadlines.extract_adapter(request.headers)
            if adapter and "adapter" not in msg.meta.tags:
                msg.meta.tags["adapter"] = adapter
            # the caller's span parents the dispatch span (run_dispatch
            # copies the context onto the pool thread); a spent budget
            # fails here, before the model sees anything
            with _ingress(request):
                _deadlines.check(f"microservice ingress {request.path}")
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
            with _ingress(request):
                _deadlines.check("microservice ingress /aggregate")
                out = await run_dispatch(dispatch.aggregate, user_model, msgs)
            return web.json_response(out.to_json())
        except Exception as e:  # noqa: BLE001
            return _error_response(e)

    async def feedback_handler(request: web.Request) -> web.Response:
        try:
            fb = InternalFeedback.from_json(await _request_body(request))
            with _ingress(request):
                _deadlines.check("microservice ingress /send-feedback")
                out = await run_dispatch(dispatch.send_feedback, user_model, fb, unit_id)
            return web.json_response(out.to_json())
        except Exception as e:  # noqa: BLE001
            return _error_response(e)

    async def ping(_request: web.Request) -> web.Response:
        return web.Response(text="pong")

    async def status(request: web.Request) -> web.Response:
        try:
            # a probe with a budget fast-fails instead of piling onto a
            # saturated dispatch pool
            with _ingress(request):
                _deadlines.check("microservice ingress /health/status")
                out = await run_dispatch(dispatch.health_check, user_model)
            return web.json_response(out.to_json())
        except Exception as e:  # noqa: BLE001
            return _error_response(e)

    collectors = (component_collector(user_model),)

    async def metrics_endpoint(request: web.Request) -> web.Response:
        om = _metrics.wants_openmetrics(request.headers.get("Accept"))
        try:
            body = await run_dispatch(_metrics.generate_latest, None, collectors, om)
        except Exception as e:  # noqa: BLE001
            return _error_response(e)
        if om:  # OpenMetrics 1.0: the histograms' trace exemplars ride it
            return web.Response(body=body, headers={"Content-Type": _metrics.CONTENT_TYPE_OPENMETRICS})
        return web.Response(body=body, content_type=_metrics.CONTENT_TYPE_LATEST.split(";")[0])

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


async def serve(app: web.Application, host: str = "0.0.0.0", port: int = 9000, tls=None) -> web.AppRunner:
    """Start serving an app; returns the runner for cleanup.  ``tls`` is a
    ``utils.tls.TlsConfig``: when set the listener terminates HTTPS (the
    same files as the gRPC lane)."""
    runner = web.AppRunner(app, access_log=None)
    await runner.setup()
    ssl_context = None
    if tls is not None and tls.enabled:
        from seldon_core_tpu_torch.utils.tls import server_ssl_context

        ssl_context = server_ssl_context(tls)
    await web.TCPSite(runner, host, port, ssl_context=ssl_context).start()
    return runner
