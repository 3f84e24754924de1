"""The port's REST request bodies against the JAX package's, multipart included.

``seldon_core_tpu_torch/runtime/rest.py`` ``_request_body`` (which the
gateway shares) and ``seldon_core_tpu/runtime/rest.py`` ``_request_body``
behind two aiohttp apps get the same requests: JSON bodies, a ``json``
form or query field, multipart per-key fields (text and file uploads,
``strData`` literal, ``binData`` raw bytes) and the refusals (a ``json``
field mixed with key fields, a non-utf-8 file, an empty form, bad JSON).
The dict each gives, or its error status and reason, is equal exactly.
Then a multipart predict through the port's microservice and gateway
answers what the same JSON predict answers.
"""

import asyncio
import json

import aiohttp
import numpy as np
import pytest
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer

from seldon_core_tpu.runtime import rest as jax_rest
from seldon_core_tpu.runtime.component import MicroserviceError as JaxMicroserviceError
from seldon_core_tpu_torch.runtime import rest
from seldon_core_tpu_torch.runtime.component import MicroserviceError
from seldon_core_tpu_torch.engine.transport import CircuitBreaker


@pytest.fixture(autouse=True)
def fresh_breakers():
    """The breaker registry is process-wide: start and leave every test
    with every endpoint closed."""
    CircuitBreaker.reset_all()
    yield
    CircuitBreaker.reset_all()


DATA = {"ndarray": [[1.0, 2.0], [3.0, 4.0]]}
META = {"tags": {"adapter": "a1"}, "puid": "p-1"}


def _echo_app(request_body):
    async def handler(request):
        try:
            body = await request_body(request)
        except (MicroserviceError, JaxMicroserviceError) as e:
            return web.json_response({"error": [e.status_code, e.reason]}, status=e.status_code)
        # bytes are not JSON: give them back as a tagged list
        return web.json_response({k: (["bytes", list(v)] if isinstance(v, bytes) else v)
                                  for k, v in body.items()} if isinstance(body, dict) else body)

    app = web.Application()
    app.router.add_route("*", "/echo", handler)
    return app


def _form(*fields):
    form = aiohttp.FormData(default_to_multipart=True)
    for name, value, filename in fields:
        if filename is None:
            form.add_field(name, value)
        else:
            form.add_field(name, value, filename=filename, content_type="application/octet-stream")
    return form


CASES = {
    "json_body": dict(json={"data": DATA, "meta": META}),
    "raw_body_no_type": dict(data=json.dumps({"data": DATA}).encode()),
    "form_json_field": dict(data={"json": json.dumps({"data": DATA})}),
    "query_json": dict(params={"json": json.dumps({"data": DATA})}, method="GET"),
    "multipart_json_text": dict(form=[("json", json.dumps({"data": DATA, "meta": META}), None)]),
    "multipart_json_file": dict(form=[("json", json.dumps({"data": DATA}).encode(), "msg.json")]),
    "multipart_keys_text": dict(form=[("data", json.dumps(DATA), None), ("meta", json.dumps(META), None)]),
    "multipart_keys_files": dict(form=[("data", json.dumps(DATA).encode(), "d.json"),
                                       ("meta", json.dumps(META).encode(), "m.json")]),
    "multipart_strdata": dict(form=[("strData", "hello {not json}", None)]),
    "multipart_strdata_file": dict(form=[("strData", "hi there".encode(), "s.txt")]),
    "multipart_bindata": dict(form=[("binData", bytes([0, 1, 2, 255]), "b.bin")]),
    "multipart_mixed_json": dict(form=[("json", "{}", None), ("data", json.dumps(DATA), None)]),
    "multipart_not_utf8": dict(form=[("data", b"\xff\xfe", "d.bin")]),
    "multipart_bad_json": dict(form=[("data", "{nope", None)]),
    "bad_json_body": dict(data=b"{nope", headers={"Content-Type": "application/json"}),
    "empty": dict(data=b""),
}


async def _send(client, case):
    kw = dict(case)
    method = kw.pop("method", "POST")
    form = kw.pop("form", None)
    if form is not None:
        kw["data"] = _form(*form)
    resp = await client.request(method, "/echo", **kw)
    return resp.status, await resp.json()


@pytest.mark.parametrize("name", sorted(CASES))
def test_request_body_equals_jax(name):
    async def go():
        out = []
        for request_body in (jax_rest._request_body, rest._request_body):
            async with TestClient(TestServer(_echo_app(request_body))) as client:
                out.append(await _send(client, CASES[name]))
        return out

    theirs, ours = asyncio.run(go())
    assert ours == theirs


class Doubler:
    def predict(self, X, names, meta=None):
        return np.asarray(X) * 2


def test_multipart_predict_answers_as_the_json_predict():
    """The microservice's /predict and the gateway's /api/v0.1/predictions
    read a multipart predict as the JSON one."""
    from seldon_core_tpu_torch.engine import PredictorService, UnitSpec
    from seldon_core_tpu_torch.engine import server

    gw = server.Gateway([(PredictorService(UnitSpec(name="m", type="MODEL", component=Doubler()), name="p"), 1.0)])

    async def go(app, path):
        async with TestClient(TestServer(app)) as client:
            as_json = await (await client.post(path, json={"data": DATA})).json()
            resp = await client.post(path, data=_form(("data", json.dumps(DATA), None)))
            assert resp.status == 200, await resp.text()
            return as_json, await resp.json()

    for app, path in ((rest.build_app(Doubler()), "/predict"),
                      (server.build_gateway_app(gw), "/api/v0.1/predictions")):
        as_json, as_form = asyncio.run(go(app, path))
        assert as_form["data"] == as_json["data"] and as_json["data"]["ndarray"] == [[2.0, 4.0], [6.0, 8.0]]
