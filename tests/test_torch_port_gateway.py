"""The port's gateway against the JAX package's.

A JAX ``Gateway`` over a ``JaxServer`` ResNetTiny ``MODEL`` graph and the
port's over a ``CudaServer(device="cpu")`` with the same f32 parameters
are driven over REST and over gRPC (the sync gRPC front server, the
only one the port has): logits agree within ``rtol = atol = 1e-4``
(the tolerance of ``tests/test_torch_port_server.py``; batch shapes
differ between calls, so never bit-equality).  Then the gateway's own
semantics on toy models: traffic weights (the same seeded pick
sequence as JAX), shadows on isolated copies, feedback routed to the
predictor that served the puid, pause → not ready, ``/seldon.json``, and
``GenerateStream``'s answer to a predictor that cannot stream.
"""

import asyncio
import base64
import os
import socket
import sys

import jax
import numpy as np
import pytest

from seldon_core_tpu.engine import PredictorService as JaxPredictorService
from seldon_core_tpu.engine import UnitSpec as JaxUnitSpec
from seldon_core_tpu.engine import server as jax_server
from seldon_core_tpu.models.jaxserver import JaxServer
from seldon_core_tpu.models.resnet import ResNetTiny as FlaxResNetTiny
from seldon_core_tpu.proto import services as jax_services
from seldon_core_tpu.runtime.message import InternalFeedback as JaxFeedback
from seldon_core_tpu.runtime.message import InternalMessage as JaxMessage
from seldon_core_tpu_torch.engine import PredictorService, UnitSpec
from seldon_core_tpu_torch.engine import server
from seldon_core_tpu_torch.models.cudaserver import CudaServer
from seldon_core_tpu_torch.proto import pb, services
from seldon_core_tpu_torch.runtime import grpc_server
from seldon_core_tpu_torch.runtime.message import InternalFeedback, InternalMessage

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_resnet import random_variables  # noqa: E402
from seldon_core_tpu_torch.engine.transport import CircuitBreaker


@pytest.fixture(autouse=True)
def fresh_breakers():
    """The breaker registry is process-wide: start and leave every test
    with every endpoint closed."""
    CircuitBreaker.reset_all()
    yield
    CircuitBreaker.reset_all()


NUM_CLASSES = 10
SHAPE = (32, 32, 3)
# f32 servers, same weights: rtol = atol = 1e-4 (summation order only)
TOL = dict(rtol=1e-4, atol=1e-4)

PACKAGES = {
    "jax": (jax_server, JaxPredictorService, JaxUnitSpec, JaxMessage, JaxFeedback),
    "torch_port": (server, PredictorService, UnitSpec, InternalMessage, InternalFeedback),
}


@pytest.fixture(scope="module")
def models():
    """A JaxServer and a CPU CudaServer with the same f32 parameters."""
    variables = random_variables(FlaxResNetTiny(num_classes=NUM_CLASSES), SHAPE, seed=29)
    common = dict(model="resnet_tiny", num_classes=NUM_CLASSES, dtype="float32", normalize=True,
                  max_batch_size=4, warmup=False)
    js = JaxServer(**common)
    js.load()
    js.variables = jax.device_put(variables)
    cs = CudaServer(device="cpu", variables=variables, **common)
    cs.load()
    yield {"jax": js, "torch_port": cs}
    cs.unload()
    js.unload()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def raw_body(x: np.ndarray) -> dict:
    return {"data": {"rawTensor": {"shape": list(x.shape), "dtype": x.dtype.name,
                                   "data": base64.b64encode(x.tobytes()).decode()}}}


def from_json(body: dict) -> np.ndarray:
    r = body["data"]["rawTensor"]
    return np.frombuffer(base64.b64decode(r["data"]), dtype=np.dtype(r["dtype"])).reshape(r["shape"])


def from_proto(msg: pb.SeldonMessage) -> np.ndarray:
    r = msg.data.rawTensor
    return np.frombuffer(r.data, dtype=np.dtype(r.dtype)).reshape(tuple(r.shape))


def proto_request(x: np.ndarray) -> pb.SeldonMessage:
    msg = pb.SeldonMessage()
    msg.data.rawTensor.shape.extend(x.shape)
    msg.data.rawTensor.dtype = x.dtype.name
    msg.data.rawTensor.data = x.tobytes()
    return msg


async def drive(pkg, gateway, batches):
    """Serve `gateway` with the package's serve_gateway and send every
    batch over REST and over gRPC; returns the REST and gRPC answers and
    the gateway's /metrics text."""
    import aiohttp
    import grpc

    mod = PACKAGES[pkg][0]
    http_port, grpc_port = free_port(), free_port()
    runner, handle = await mod.serve_gateway(gateway, host="127.0.0.1", http_port=http_port,
                                             grpc_port=grpc_port)
    rest_out, grpc_out = [], []
    try:
        async with aiohttp.ClientSession() as session:
            for x in batches:
                async with session.post(f"http://127.0.0.1:{http_port}/api/v0.1/predictions",
                                        json=raw_body(x)) as resp:
                    assert resp.status == 200, await resp.text()
                    rest_out.append(await resp.json())
            async with session.get(f"http://127.0.0.1:{http_port}/metrics") as resp:
                metrics = await resp.text()
        async with grpc.aio.insecure_channel(f"127.0.0.1:{grpc_port}",
                                             options=grpc_server.message_size_options()) as channel:
            predict = services.unary_callable(channel, "Seldon", "Predict")
            for x in batches:
                grpc_out.append(await predict(proto_request(x), timeout=60))
    finally:
        await handle.stop(None)
        await runner.cleanup()
    return rest_out, grpc_out, metrics


def test_resnet_tiny_through_both_gateways(models):
    rng = np.random.default_rng(31)
    batches = [rng.integers(0, 256, (n, *SHAPE)).astype(np.uint8) for n in (1, 3, 4)]
    got = {}
    for pkg, (_, Service, Spec, _, _) in PACKAGES.items():
        gw = PACKAGES[pkg][0].Gateway([(Service(Spec(name="resnet", type="MODEL", component=models[pkg]),
                                                name="main"), 1.0)])
        got[pkg] = asyncio.run(drive(pkg, gw, batches))
    (p_rest, p_grpc, p_metrics), (j_rest, j_grpc, _) = got["torch_port"], got["jax"]
    for i, x in enumerate(batches):
        np.testing.assert_allclose(from_json(p_rest[i]), from_json(j_rest[i]), **TOL)
        np.testing.assert_allclose(from_proto(p_grpc[i]), from_proto(j_grpc[i]), **TOL)
        np.testing.assert_allclose(from_proto(p_grpc[i]), from_json(p_rest[i]), **TOL)
        assert from_proto(p_grpc[i]).shape == (len(x), NUM_CLASSES)
        p, j = p_rest[i]["meta"], j_rest[i]["meta"]
        assert p["requestPath"] == j["requestPath"] == {"resnet": "local"}
        assert p["tags"]["predictor"] == j["tags"]["predictor"] == "main"
        assert p_grpc[i].meta.tags["predictor"].string_value == "main" and p_grpc[i].meta.puid
        assert p_grpc[i].status.status == pb.Status.SUCCESS and p_grpc[i].status.code == 200
    assert 'seldon_api_gateway_requests_total{predictor="main"} 3' in p_metrics
    assert 'cudaserver_batches_total{predictor="main",unit="resnet"}' in p_metrics


class FixedModel:
    def __init__(self, value=1.0):
        self.value = value
        self.rewards = []
        self.seen = 0

    def predict(self, X, names, meta=None):
        self.seen += 1
        return np.array([[self.value]])

    def send_feedback(self, features, names, reward, truth, routing=None):
        self.rewards.append(reward)


def gateway(pkg, weights, seed=None, shadow=False):
    mod, Service, Spec, _, _ = PACKAGES[pkg]
    models = {name: FixedModel(float(i)) for i, name in enumerate(weights)}
    entries = [(Service(Spec(name="m", type="MODEL", component=models[name]), name=name), w)
               for name, w in weights.items()]
    shadows = []
    if shadow:
        models["shadow"] = FixedModel(9.0)
        shadows = [Service(Spec(name="m", type="MODEL", component=models["shadow"]), name="shadow")]
    return mod.Gateway(entries, shadows=shadows, seed=seed), models


def test_traffic_weights_pick_the_same_sequence_as_jax():
    weights = {"a": 0.2, "b": 0.5, "c": 0.3}
    gateways = {pkg: gateway(pkg, weights, seed=11)[0] for pkg in PACKAGES}
    seqs = {pkg: [gw.pick().name for _ in range(300)] for pkg, gw in gateways.items()}
    assert seqs["torch_port"] == seqs["jax"]
    assert set(seqs["torch_port"]) == set(weights)
    zero = gateway("torch_port", {"a": 0.0, "b": 0.0}, seed=1)[0]
    assert {zero.pick().name for _ in range(100)} == {"a", "b"}  # all-zero weights -> uniform


def test_predictor_pin_and_shadow_copy():
    gw, models = gateway("torch_port", {"a": 1.0, "b": 0.0}, shadow=True)

    async def go():
        out = await gw.predict(InternalMessage(payload=np.ones((1, 1)), kind="tensor"), predictor="b")
        await asyncio.gather(*list(gw._shadow_tasks))
        return out

    out = asyncio.run(go())
    assert out.meta.tags["predictor"] == "b" and np.array_equal(out.payload, [[1.0]])
    assert models["shadow"].seen == 1 and models["a"].seen == 0


def test_feedback_routed_to_the_predictor_that_served_the_puid():
    results = {}
    for pkg in PACKAGES:
        gw, models = gateway(pkg, {"a": 0.5, "b": 0.5}, seed=3)
        Message, Feedback = PACKAGES[pkg][3], PACKAGES[pkg][4]

        async def go(gw=gw, Message=Message, Feedback=Feedback):
            statuses = []
            for _ in range(6):
                out = await gw.predict(Message(payload=np.ones((1, 1)), kind="tensor"))
                served = out.meta.tags.pop("predictor")  # stripped: the puid alone must route it
                fb = Feedback(request=Message(payload=np.ones((1, 1)), kind="tensor"), response=out, reward=1.0)
                statuses.append((served, (await gw.send_feedback(fb)).status["status"]))
            stranger = Message(payload=None, kind="jsonData")
            stranger.meta.puid = "never-served"
            dropped = await gw.send_feedback(Feedback(response=stranger, reward=1.0))
            return statuses, dropped.status

        statuses, dropped = asyncio.run(go())
        served = [s for s, _ in statuses]
        assert all(st == "SUCCESS" for _, st in statuses)
        assert len(models["a"].rewards) == served.count("a") and len(models["b"].rewards) == served.count("b")
        assert dropped["code"] == 404 and dropped["reason"] == "FEEDBACK_UNROUTED"
        results[pkg] = served
    assert results["torch_port"] == results["jax"]


def test_pause_ready_and_openapi_over_rest():
    import aiohttp

    async def go(pkg):
        mod, Service, Spec, _, _ = PACKAGES[pkg]
        gw = mod.Gateway([(Service(Spec(name="m", type="MODEL", component=FixedModel()), name="main"), 1.0)])
        http_port = free_port()
        runner, handle = await mod.serve_gateway(gw, host="127.0.0.1", http_port=http_port, grpc_port=free_port())
        base = f"http://127.0.0.1:{http_port}"
        seen = []
        try:
            async with aiohttp.ClientSession() as session:
                for method, path in (("GET", "/ready"), ("POST", "/pause"), ("GET", "/ready"), ("GET", "/live"),
                                     ("GET", "/ping"), ("PUT", "/unpause"), ("GET", "/ready")):
                    async with session.request(method, base + path) as resp:
                        seen.append((path, resp.status, await resp.text()))
                async with session.get(base + "/seldon.json") as resp:
                    doc = await resp.json()
                async with session.post(base + "/api/v0.1/feedback", json={"reward": 1.0}) as resp:
                    seen.append(("feedback", resp.status, (await resp.json())["status"]["status"]))
        finally:
            await handle.stop(None)
            await runner.cleanup()
        return seen, doc

    got = {pkg: asyncio.run(go(pkg)) for pkg in PACKAGES}
    assert got["torch_port"][0] == got["jax"][0]
    assert [s for _, s, _ in got["torch_port"][0][:3]] == [200, 200, 503]
    port_doc, jax_doc = got["torch_port"][1], got["jax"][1]
    assert port_doc["info"]["version"] and port_doc["info"].pop("version") and jax_doc["info"].pop("version")
    assert "/api/v0.1/explanations" in port_doc["paths"]
    assert port_doc == jax_doc


def test_grpc_feedback_stream_and_generate_stream():
    import grpc

    model = FixedModel(2.0)

    async def go():
        gw = server.Gateway([(PredictorService(UnitSpec(name="m", type="MODEL", component=model), name="main"), 1.0)])
        grpc_port = free_port()
        runner, handle = await server.serve_gateway(gw, host="127.0.0.1", http_port=free_port(),
                                                    grpc_port=grpc_port)
        try:
            async with grpc.aio.insecure_channel(f"127.0.0.1:{grpc_port}") as channel:
                predict = services.unary_callable(channel, "Seldon", "Predict")
                out = await predict(proto_request(np.ones((1, 2), np.float32)), timeout=30)
                fb = pb.Feedback(reward=0.5)
                fb.response.CopyFrom(out)
                ack = await services.unary_callable(channel, "Seldon", "SendFeedback")(fb, timeout=30)
                # the streaming client helpers are the JAX package's (the port has no streaming client)
                stream = jax_services.stream_callable(channel, "Seldon", "PredictStream")
                chunks = [c async for c in stream(services.chunk_message(proto_request(np.ones((1, 2), np.float32)),
                                                                         chunk_bytes=5), timeout=30)]
                streamed = pb.SeldonMessage.FromString(
                    jax_services.assemble_chunks(chunks, jax_services.pb.SeldonMessage).SerializeToString())
                gen = jax_services.unary_stream_callable(channel, "Seldon", "GenerateStream")
                with pytest.raises(grpc.aio.AioRpcError) as info:
                    [c async for c in gen(proto_request(np.ones((1, 2), np.int32)), timeout=30)]
                return out, ack, streamed, info.value
        finally:
            await handle.stop(None)
            await runner.cleanup()

    out, ack, streamed, err = asyncio.run(go())
    assert out.meta.tags["predictor"].string_value == "main"
    assert ack.status.status == pb.Status.SUCCESS and model.rewards == [0.5]
    assert list(streamed.data.tensor.values) == [2.0] or from_proto(streamed).tolist() == [[2.0]]
    # FixedModel has no predict_stream: the JAX sync server's answer, word for word
    assert err.code() == grpc.StatusCode.UNIMPLEMENTED
    assert err.details() == ("GenerateStream needs a single-local-model predictor whose component implements "
                             "predict_stream (e.g. STREAMING_LM)")


def test_multi_node_graph_bridges_to_the_loop_over_sync_grpc():
    import grpc

    class TimesTwo:
        def transform_input(self, X, names, meta=None):
            return np.asarray(X) * 2

    class Doubler:
        def predict(self, X, names, meta=None):
            return np.asarray(X) * 2

    async def go():
        graph = UnitSpec(name="t", type="TRANSFORMER", component=TimesTwo(),
                         children=[UnitSpec(name="m", type="MODEL", component=Doubler())])
        gw = server.Gateway([(PredictorService(graph, name="main"), 1.0)])
        grpc_port = free_port()
        runner, handle = await server.serve_gateway(gw, host="127.0.0.1", http_port=free_port(),
                                                    grpc_port=grpc_port)
        try:
            async with grpc.aio.insecure_channel(f"127.0.0.1:{grpc_port}") as channel:
                req = pb.SeldonMessage()
                req.data.tensor.shape.extend([1, 1])
                req.data.tensor.values.extend([3.0])
                return await services.unary_callable(channel, "Seldon", "Predict")(req, timeout=30)
        finally:
            await handle.stop(None)
            await runner.cleanup()

    resp = asyncio.run(go())
    assert list(resp.data.tensor.values) == [12.0]
    assert set(resp.meta.requestPath) == {"t", "m"}


# ---------------------------------------------------------------- A4: the request contract on both gateways

CERTS = os.path.join(os.path.dirname(__file__), "data", "torch_port_tls")
TRACE_ID = "4bf92f3577b34da6a3ce929d0e0e4736"
OAUTH = ("client", "s3cret")


async def drive_a4(pkg, gw, x):
    """Serve `gw` with TLS and OAuth on both listeners and tracing on, and
    send the A4 requests: a token from /oauth/token, then predictions with
    a token, a traceparent, a deadline and a priority, and the refusals
    (no token, a spent deadline) over REST and sync gRPC."""
    import ssl

    import aiohttp
    import grpc

    from seldon_core_tpu.utils import auth as jax_auth
    from seldon_core_tpu.utils import tls as jax_tls
    from seldon_core_tpu.utils import tracing as jax_tracing
    from seldon_core_tpu_torch.utils import auth, tls, tracing

    tls_mod, auth_mod, tracing_mod = (jax_tls, jax_auth, jax_tracing) if pkg == "jax" else (tls, auth, tracing)
    mod = PACKAGES[pkg][0]
    tracer = tracing_mod.setup_tracing(service_name=f"{pkg}-gateway")
    http_port, grpc_port = free_port(), free_port()
    cfg = tls_mod.TlsConfig(cert_file=os.path.join(CERTS, "server.crt"), key_file=os.path.join(CERTS, "server.key"))
    runner, handle = await mod.serve_gateway(gw, host="127.0.0.1", http_port=http_port, grpc_port=grpc_port,
                                             tls=cfg, auth=auth_mod.OAuthConfig(*OAUTH))
    ctx = ssl.create_default_context(cafile=os.path.join(CERTS, "ca.crt"))
    base = f"https://localhost:{http_port}"
    out = {}
    try:
        timeout = aiohttp.ClientTimeout(total=60)
        async with aiohttp.ClientSession(timeout=timeout) as s:
            basic = base64.b64encode(":".join(OAUTH).encode()).decode()
            async with s.post(base + "/oauth/token", headers={"Authorization": f"Basic {basic}"}, ssl=ctx) as r:
                token = (await r.json())["access_token"]
            wrong = base64.b64encode(b"client:nope").decode()
            async with s.post(base + "/oauth/token", headers={"Authorization": f"Basic {wrong}"}, ssl=ctx) as r:
                out["bad_credentials"] = (r.status, await r.json())
            async with s.post(base + "/api/v0.1/predictions", json=raw_body(x), ssl=ctx) as r:
                out["rest_no_token"] = (r.status, await r.json())
            headers = {"Authorization": f"Bearer {token}", "traceparent": f"00-{TRACE_ID}-00f067aa0ba902b7-01",
                       "X-Seldon-Deadline-Ms": "10000", "X-Seldon-Priority": "99"}
            async with s.post(base + "/api/v0.1/predictions", json=raw_body(x), headers=headers, ssl=ctx) as r:
                assert r.status == 200, await r.text()
                out["rest"] = await r.json()
            async with s.post(base + "/api/v0.1/predictions", json=raw_body(x),
                              headers={**headers, "X-Seldon-Deadline-Ms": "0"}, ssl=ctx) as r:
                out["rest_spent"] = (r.status, await r.json())
            for path in ("/ping", "/metrics"):  # probes and metrics stay open
                async with s.get(base + path, ssl=ctx) as r:
                    out[path] = r.status
        with open(os.path.join(CERTS, "ca.crt"), "rb") as f:
            creds = grpc.ssl_channel_credentials(root_certificates=f.read())
        async with grpc.aio.secure_channel(f"localhost:{grpc_port}", creds,
                                           options=grpc_server.message_size_options()) as channel:
            predict = services.unary_callable(channel, "Seldon", "Predict")
            with pytest.raises(grpc.aio.AioRpcError) as err:
                await predict(proto_request(x), timeout=30)
            out["grpc_no_token"] = (err.value.code(), err.value.details())
            md = [("authorization", f"Bearer {token}"), ("traceparent", f"00-{TRACE_ID}-b7ad6b7169203331-01"),
                  ("x-seldon-deadline-ms", "10000")]
            out["grpc"] = await predict(proto_request(x), timeout=30, metadata=md)
            spent = await predict(proto_request(x), timeout=30, metadata=md[:2] + [("x-seldon-deadline-ms", "0")])
            out["grpc_spent"] = (spent.status.status, spent.status.code, spent.status.reason, spent.status.info)
    finally:
        await handle.stop(None)
        await runner.cleanup()
        tracer.close()
        tracing_mod._tracer = None
    out["spans"] = list(tracer.spans)
    return out


def _span_shape(spans):
    """(name, trace id, parent's name or the remote parent's id) per span."""
    by_id = {s.span_id: s.name for s in spans}
    return sorted((s.name, s.trace_id, by_id.get(s.parent_span_id, s.parent_span_id)) for s in spans)


def test_a4_contract_on_both_gateways(models):
    """TLS, OAuth, deadlines, priority and W3C tracing on the REST and
    sync gRPC listeners of both gateways: the same answers, refusals and
    span trees (names, trace ids, parents)."""
    x = np.random.default_rng(37).integers(0, 256, (2, *SHAPE)).astype(np.uint8)
    got = {}
    for pkg, (mod, Service, Spec, _, _) in PACKAGES.items():
        gw = mod.Gateway([(Service(Spec(name="resnet", type="MODEL", component=models[pkg]), name="main"), 1.0)])
        got[pkg] = asyncio.run(drive_a4(pkg, gw, x))
    ours, theirs = got["torch_port"], got["jax"]
    np.testing.assert_allclose(from_json(ours["rest"]), from_json(theirs["rest"]), **TOL)
    np.testing.assert_allclose(from_proto(ours["grpc"]), from_proto(theirs["grpc"]), **TOL)
    for key in ("bad_credentials", "rest_no_token", "rest_spent", "grpc_no_token", "grpc_spent", "/ping", "/metrics"):
        assert ours[key] == theirs[key], key
    assert ours["rest_no_token"][0] == 401 and ours["bad_credentials"][0] == 401
    assert ours["rest_spent"][0] == 504 and ours["rest_spent"][1]["status"]["reason"] == "DEADLINE_EXCEEDED"
    assert "gateway ingress /api/v0.1/predictions" in ours["rest_spent"][1]["status"]["info"]
    assert ours["grpc_spent"][:3] == (pb.Status.FAILURE, 504, "DEADLINE_EXCEEDED")
    assert "gateway grpc ingress Seldon/Predict" in ours["grpc_spent"][3]
    assert ours["grpc_no_token"][0].name == "UNAUTHENTICATED"
    assert ours["rest"]["meta"]["tags"]["priority"] == theirs["rest"]["meta"]["tags"]["priority"] == 15
    assert _span_shape(ours["spans"]) == _span_shape(theirs["spans"])
    names = {(s.name, s.trace_id) for s in ours["spans"]}
    assert {("predictor.predict", TRACE_ID), ("node.resnet.transform_input", TRACE_ID),
            ("microservice.predict", TRACE_ID)} <= names
