"""The port's gRPC contract against the JAX package's.

* ``proto/services.py``: the method tables equal JAX's by service,
  method and message type; chunking round-trips.
* ``runtime/grpc_server.py``: ResNetTiny served by the JAX
  ``build_server(JaxServer)`` and the port's
  ``build_server(CudaServer(device="cpu"))`` on loopback, from the same
  f32 parameters: uint8 and float payloads agree within
  ``rtol = atol = 1e-4`` (the tolerance of
  ``tests/test_torch_port_server.py``), and error statuses are equal.
* The node-role services (Generic, Router, Transformer,
  OutputTransformer, Combiner, Model/SendFeedback) over a toy component
  answer byte for byte what the JAX server answers (puid cleared).

Messages cross between the packages only as bytes: both ``seldon_pb2``
modules carry the same descriptor.
"""

import asyncio
import os
import socket
import sys

import jax
import numpy as np
import pytest

from seldon_core_tpu.models.jaxserver import JaxServer
from seldon_core_tpu.models.resnet import ResNetTiny as FlaxResNetTiny
from seldon_core_tpu.proto import services as jax_services
from seldon_core_tpu.runtime import grpc_server as jax_grpc_server
from seldon_core_tpu_torch.models.cudaserver import CudaServer
from seldon_core_tpu_torch.proto import pb, services
from seldon_core_tpu_torch.runtime import grpc_server

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_dispatch_roles import Scaler, request_bytes  # noqa: E402
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


def test_method_tables_equal_jax():
    def names(table):
        return {svc: {m: (req.DESCRIPTOR.full_name, resp.DESCRIPTOR.full_name) for m, (req, resp) in methods.items()}
                for svc, methods in table.items()}

    for attr in ("SERVICES", "STREAM_METHODS", "UNARY_STREAM_METHODS"):
        assert names(getattr(services, attr)) == names(getattr(jax_services, attr)), attr
    assert len(services.SERVICES) == 7
    assert services.method_path("Model", "Predict") == jax_services.method_path("Model", "Predict")
    assert services.STREAM_MAX_BYTES == jax_services.STREAM_MAX_BYTES
    assert services.STREAM_CHUNK_BYTES == jax_services.STREAM_CHUNK_BYTES


@pytest.mark.parametrize("chunk_bytes", [1, 7, 1 << 20])
def test_chunking_round_trips(chunk_bytes):
    msg = pb.SeldonMessage.FromString(request_bytes("rawTensor"))
    chunks = list(services.chunk_message(msg, chunk_bytes=chunk_bytes))
    assert pb.SeldonMessage.FromString(b"".join(c.data for c in chunks)) == msg
    jax_chunks = list(jax_services.chunk_message(jax_services.pb.SeldonMessage.FromString(msg.SerializeToString()),
                                                 chunk_bytes=chunk_bytes))
    assert [c.data for c in chunks] == [c.data for c in jax_chunks]
    assert list(services.chunk_message(pb.SeldonMessage()))[0].data == b""


@pytest.fixture(scope="module")
def servers():
    """A JaxServer and a CPU CudaServer with the same f32 parameters."""
    variables = random_variables(FlaxResNetTiny(num_classes=NUM_CLASSES), SHAPE, seed=23)
    common = dict(model="resnet_tiny", num_classes=NUM_CLASSES, dtype="float32", normalize=True,
                  max_batch_size=4, warmup=False)
    js = JaxServer(**common)
    js.load()
    js.variables = jax.device_put(variables)
    cs = CudaServer(device="cpu", variables=variables, **common)
    cs.load()
    yield js, cs
    cs.unload()
    js.unload()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


async def call_both(jax_component, port_component, calls):
    """Serve each component on its own aio server (JAX's and the port's
    build_server) and make each call on both; returns the responses as
    bytes, JAX's first."""
    import grpc

    out = []
    servers, channels = [], []
    try:
        for build, component in ((jax_grpc_server.build_server, jax_component),
                                 (grpc_server.build_server, port_component)):
            server = build(component, unit_id="unit-1")
            port = server.add_insecure_port(f"127.0.0.1:{free_port()}")
            await server.start()
            servers.append(server)
            channels.append(grpc.aio.insecure_channel(f"127.0.0.1:{port}",
                                                      options=grpc_server.message_size_options()))
        for service, method, raw, metadata in calls:
            pair = []
            for channel in channels:
                call = services.unary_callable(channel, service, method)
                req_cls = services.SERVICES[service][method][0]
                resp = await call(req_cls.FromString(raw), timeout=60, metadata=metadata)
                pair.append(resp.SerializeToString(deterministic=True))
            out.append(pair)
    finally:
        for channel in channels:
            await channel.close()
        for server in servers:
            await server.stop(grace=None)
    return out


def predict_request(x: np.ndarray, kind: str) -> bytes:
    msg = pb.SeldonMessage()
    if kind == "rawTensor":
        msg.data.rawTensor.shape.extend(x.shape)
        msg.data.rawTensor.dtype = x.dtype.name
        msg.data.rawTensor.data = x.tobytes()
    else:
        msg.data.tensor.shape.extend(x.shape)
        msg.data.tensor.values.extend(x.ravel().tolist())
    return msg.SerializeToString()


def logits(raw: bytes) -> np.ndarray:
    msg = pb.SeldonMessage.FromString(raw)
    assert msg.status.status == pb.Status.SUCCESS and not msg.status.reason, msg.status
    which = msg.data.WhichOneof("data_oneof")
    if which == "rawTensor":
        r = msg.data.rawTensor
        return np.frombuffer(r.data, dtype=np.dtype(r.dtype)).reshape(tuple(r.shape))
    return np.asarray(msg.data.tensor.values).reshape(tuple(msg.data.tensor.shape))


def test_resnet_tiny_over_grpc_matches_jax(servers):
    rng = np.random.default_rng(5)
    u8 = rng.integers(0, 256, (3, *SHAPE)).astype(np.uint8)
    f32 = rng.standard_normal((2, *SHAPE)).astype(np.float32)
    calls = [("Model", "Predict", predict_request(u8, "rawTensor"), ()),
             ("Model", "Predict", predict_request(u8[:1].reshape(1, -1), "rawTensor"), ()),
             ("Model", "Predict", predict_request(f32, "tensor"), ()),
             ("Model", "Predict", predict_request(f32[:1], "rawTensor"), ())]
    js, cs = servers
    results = asyncio.run(call_both(js, cs, calls))
    for jax_raw, port_raw in results:
        got, want = logits(port_raw), logits(jax_raw)
        assert got.shape == want.shape and got.shape[-1] == NUM_CLASSES
        np.testing.assert_allclose(got, want, **TOL)
        a, b = pb.SeldonMessage.FromString(port_raw), pb.SeldonMessage.FromString(jax_raw)
        assert a.data.WhichOneof("data_oneof") == b.data.WhichOneof("data_oneof")
        assert list(a.data.names) == list(b.data.names)
        assert a.meta.puid and b.meta.puid


def test_error_statuses_match_jax(servers):
    bad_shape = predict_request(np.zeros((1, 5, 5, 3), np.uint8), "rawTensor")
    bad_dtype = pb.SeldonMessage()
    bad_dtype.data.rawTensor.shape.extend([1, 2])
    bad_dtype.data.rawTensor.dtype = "complex1024"
    bad_dtype.data.rawTensor.data = b"\0" * 8
    calls = [("Model", "Predict", bad_shape, ()),
             ("Model", "Predict", bad_dtype.SerializeToString(), ()),
             ("Router", "Route", bad_shape, ()),
             ("Generic", "TransformInput", predict_request(np.zeros((1, *SHAPE), np.uint8), "rawTensor"), ())]
    js, cs = servers
    for jax_raw, port_raw in asyncio.run(call_both(js, cs, calls)):
        a, b = pb.SeldonMessage.FromString(port_raw), pb.SeldonMessage.FromString(jax_raw)
        assert a.status.status == pb.Status.FAILURE
        assert (a.status.code, a.status.reason) == (b.status.code, b.status.reason)
    assert pb.SeldonMessage.FromString(asyncio.run(call_both(js, cs, calls[:1]))[0][1]).status.reason == \
        "BAD_INPUT_SHAPE"


def role_calls():
    tensor = request_bytes("tensor")
    pair = pb.SeldonMessageList(seldonMessages=[pb.SeldonMessage.FromString(tensor),
                                                pb.SeldonMessage.FromString(request_bytes("tensor", 1))])
    fb = pb.Feedback(reward=0.5)
    fb.request.ParseFromString(tensor)
    fb.response.ParseFromString(tensor)
    fb.response.meta.routing["unit-1"] = 0
    adapter = (("x-seldon-adapter", "a1"),)
    return [
        ("Generic", "TransformInput", tensor, ()),
        ("Generic", "TransformOutput", tensor, ()),
        ("Generic", "Route", tensor, ()),
        ("Generic", "Aggregate", pair.SerializeToString(), ()),
        ("Generic", "SendFeedback", fb.SerializeToString(), ()),
        ("Model", "Predict", tensor, adapter),
        ("Model", "SendFeedback", fb.SerializeToString(), ()),
        ("Router", "Route", tensor, ()),
        ("Router", "SendFeedback", fb.SerializeToString(), ()),
        ("Transformer", "TransformInput", tensor, ()),
        ("OutputTransformer", "TransformOutput", tensor, ()),
        ("Combiner", "Aggregate", pair.SerializeToString(), ()),
    ]


def test_node_role_services_match_jax_byte_for_byte():
    calls = role_calls()
    results = asyncio.run(call_both(Scaler(), Scaler(), calls))
    for (service, method, _, metadata), (jax_raw, port_raw) in zip(calls, results):
        a, b = pb.SeldonMessage.FromString(port_raw), pb.SeldonMessage.FromString(jax_raw)
        assert a.status.status == pb.Status.SUCCESS, (service, method, a.status)
        a.meta.puid = b.meta.puid = ""
        assert a.SerializeToString(deterministic=True) == b.SerializeToString(deterministic=True), (service, method)
        if metadata:  # x-seldon-adapter metadata lands in meta.tags.adapter
            assert a.meta.tags["adapter"].string_value == "a1"


def test_unregistered_method_is_unimplemented():
    import grpc

    async def go():
        server = grpc_server.build_server(Scaler())
        port = server.add_insecure_port(f"127.0.0.1:{free_port()}")
        await server.start()
        try:
            async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as channel:
                call = services.unary_callable(channel, "Combiner", "Aggregate")
                await call(pb.SeldonMessageList(), timeout=10)
                predict = channel.unary_unary("/seldon.protos.Combiner/Predict",
                                              request_serializer=lambda m: m.SerializeToString(),
                                              response_deserializer=pb.SeldonMessage.FromString)
                with pytest.raises(grpc.aio.AioRpcError) as info:
                    await predict(pb.SeldonMessage(), timeout=10)
                return info.value.code()
        finally:
            await server.stop(grace=None)

    assert asyncio.run(go()).name == "UNIMPLEMENTED"


def test_spent_budget_fails_at_the_grpc_ingress_as_jax():
    """x-seldon-deadline-ms: 0 (or a spent native deadline) answers the
    same DEADLINE_EXCEEDED FAILURE, byte for byte, before the model runs."""
    class Counting(Scaler):
        calls = 0

        def predict(self, X, names, meta=None):
            Counting.calls += 1
            return super().predict(X, names, meta)

        def transform_input(self, X, names, meta=None):
            Counting.calls += 1
            return super().transform_input(X, names, meta)

        def route(self, features, names):
            Counting.calls += 1
            return super().route(features, names)

    calls = [(service, method, request_bytes("tensor"), [("x-seldon-deadline-ms", "0")])
             for service, method in (("Model", "Predict"), ("Generic", "TransformInput"), ("Router", "Route"))]
    component = Counting()
    results = asyncio.run(call_both(Scaler(), component, calls))
    for (service, method, _, _), (jax_raw, port_raw) in zip(calls, results):
        assert port_raw == jax_raw, (service, method)
        out = pb.SeldonMessage.FromString(port_raw)
        assert (out.status.code, out.status.reason) == (504, "DEADLINE_EXCEEDED")
        assert f"microservice grpc ingress {method_name(method)}" in out.status.info
    assert component.calls == 0


def method_name(rpc: str) -> str:
    return {"Predict": "predict", "TransformInput": "transform_input", "Route": "route"}[rpc]


def test_two_process_deployment_stitches_one_trace(tmp_path):
    """The gateway in this process, the CLI with --tracing and a JSONL
    span sink in another, behind a combiner over its REST and gRPC
    endpoints (tests/test_trace_propagation.py's acceptance scenario, on
    ResNetTiny).  One trace, the client's; every microservice span has a
    gateway node span as its parent; the hop's bytes and in-flight gauge
    on the gateway's /metrics; the served rows equal the in-process
    model's; a spent budget stops at the gateway."""
    import json
    import subprocess
    import time
    import urllib.request

    from seldon_core_tpu_torch.engine import PredictorService, UnitSpec
    from seldon_core_tpu_torch.engine.graph import Endpoint
    from seldon_core_tpu_torch.runtime.message import InternalMessage
    from seldon_core_tpu_torch.utils import deadlines, metrics, tracing

    spans_path = tmp_path / "worker-spans.jsonl"
    log_path = tmp_path / "worker.log"
    http_port, grpc_port = free_port(), free_port()
    params = [{"name": "model", "value": "resnet_tiny", "type": "STRING"},
              {"name": "num_classes", "value": str(NUM_CLASSES), "type": "INT"},
              {"name": "dtype", "value": "float32", "type": "STRING"},
              {"name": "normalize", "value": "true", "type": "BOOL"},
              {"name": "max_batch_size", "value": "4", "type": "INT"},
              {"name": "warmup", "value": "false", "type": "BOOL"},
              {"name": "seed", "value": "5", "type": "INT"},
              {"name": "input_shape", "value": json.dumps(list(SHAPE)), "type": "JSON"},
              {"name": "device", "value": "cpu", "type": "STRING"}]
    env = dict(os.environ, TRACING="1", SELDON_TPU_TRACE_EXPORT=str(spans_path))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(log_path, "wb") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "seldon_core_tpu_torch.runtime.microservice",
             "seldon_core_tpu_torch.models.cudaserver.CudaServer", "--api", "BOTH", "--host", "127.0.0.1",
             "--http-port", str(http_port), "--grpc-port", str(grpc_port), "--unit-id", "worker",
             "--parameters", json.dumps(params)],
            cwd=root, env=env, stdout=log, stderr=subprocess.STDOUT)
    local = CudaServer(device="cpu", **{p["name"]: json.loads(p["value"]) if p["type"] in ("INT", "JSON", "BOOL")
                                         else p["value"] for p in params if p["name"] != "device"})
    local.load()
    tracer = tracing.setup_tracing("gateway")
    try:
        deadline = time.time() + 120
        while True:
            assert proc.poll() is None, log_path.read_text()[-4000:]
            try:
                urllib.request.urlopen(f"http://127.0.0.1:{http_port}/health/ping", timeout=1).read()
                break
            except OSError:
                assert time.time() < deadline, "the worker never became ready"
                time.sleep(0.2)
        graph = UnitSpec(name="combiner", type="COMBINER", implementation="AVERAGE_COMBINER", children=[
            UnitSpec(name="rest-leg", type="MODEL", remote=True, endpoint=Endpoint("127.0.0.1", http_port, "REST")),
            UnitSpec(name="grpc-leg", type="MODEL", remote=True, endpoint=Endpoint("127.0.0.1", grpc_port, "GRPC"))])
        svc = PredictorService(graph, name="main")
        images = np.random.default_rng(41).integers(0, 256, (3, *SHAPE)).astype(np.uint8)
        ctx = tracing.extract({"traceparent": "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01"})

        async def go():
            try:
                outs = []
                with tracing.activate_context(ctx):
                    with deadlines.activate_ms(30_000.0):
                        for i in range(3):
                            outs.append(await svc.predict(InternalMessage(payload=images[i:i + 1],
                                                                          kind="rawTensor")))
                    with deadlines.activate_ms(0.0):
                        spent = await svc.predict(InternalMessage(payload=images[:1], kind="rawTensor"))
                return outs, spent
            finally:
                await svc.close()

        outs, spent = asyncio.run(go())
        local_spans = [s.to_dict() for s in tracer.spans]
        exposition = metrics.generate_latest().decode()
    finally:
        tracer.close()
        tracing._tracer = None
        local.unload()
        proc.terminate()
        proc.wait(timeout=30)
    want = np.asarray(local.predict(images, []), np.float64)
    for i, out in enumerate(outs):
        assert out.status["status"] == "SUCCESS", out.status
        got = np.asarray(out.host_payload(), np.float64)[0]
        assert np.linalg.norm(got - want[i]) / np.linalg.norm(want[i]) <= 2e-2
    assert spent.status["code"] == 504 and spent.status["reason"] == "DEADLINE_EXCEEDED"
    assert "node 'rest-leg'" in spent.status["info"] or "node 'grpc-leg'" in spent.status["info"]
    worker = [json.loads(line) for line in spans_path.read_text().splitlines() if line.strip()]
    micro = [s for s in worker if s["name"].startswith("microservice.")]
    assert len(micro) == 6  # three requests, two legs each; the spent one never left the gateway
    node_ids = {s["spanId"]: s["name"] for s in local_spans if s["name"].startswith("node.")}
    assert {node_ids[s["parentSpanId"]] for s in micro} == {"node.rest-leg.transform_input",
                                                            "node.grpc-leg.transform_input"}
    assert {s["traceId"] for s in local_spans + worker} == {"0af7651916cd43dd8448eb211c80319c"}
    samples = {}
    for line in exposition.splitlines():
        if line and not line.startswith("#"):
            key, _, val = line.rpartition(" ")
            samples[key] = float(val)
    for transport, unit in (("grpc", "grpc-leg"), ("rest", "rest-leg")):
        labels = f'method="predict",transport="{transport}",unit="{unit}"'
        assert samples[f"seldon_tpu_transport_request_bytes_total{{{labels}}}"] > 0
        assert samples[f"seldon_tpu_transport_response_bytes_total{{{labels}}}"] > 0
        assert samples[f"seldon_tpu_transport_inflight{{{labels}}}"] == 0.0


def test_served_resnet_tiny_fallback_matches_jax(servers):
    """One graph through JAX's executor and the port's: a router whose
    branch is a primary that sheds (a transient 503) with ResNetTiny of
    the same f32 parameters as its fallback.  The same tags, routing and
    requestPath; logits within TOL."""
    from seldon_core_tpu.engine import PredictorService as JaxPredictorService
    from seldon_core_tpu.engine import UnitSpec as JaxUnitSpec
    from seldon_core_tpu.runtime.component import MicroserviceError as JaxMicroserviceError
    from seldon_core_tpu.runtime.message import InternalMessage as JaxMessage
    from seldon_core_tpu_torch.engine import PredictorService, UnitSpec
    from seldon_core_tpu_torch.runtime.component import MicroserviceError
    from seldon_core_tpu_torch.runtime.message import InternalMessage

    js, cs = servers
    images = np.random.default_rng(7).integers(0, 256, (2, *SHAPE)).astype(np.uint8)
    outs = {}
    for pkg, spec_cls, svc_cls, msg_cls, error, fallback in (
            ("jax", JaxUnitSpec, JaxPredictorService, JaxMessage, JaxMicroserviceError, js),
            ("torch_port", UnitSpec, PredictorService, InternalMessage, MicroserviceError, cs)):
        class Shedding:
            def predict(self, X, names, meta=None, error=error):
                raise error("overloaded", status_code=503, reason="SHED")

        primary = spec_cls(name="resnet", type="MODEL", component=Shedding())
        primary.fallback = spec_cls(name="resnet-small", type="MODEL", component=fallback,
                                    image="resnet-tiny:fallback")
        router = spec_cls(name="router", type="ROUTER", implementation="RANDOM_ABTEST",
                          parameters=[{"name": "ratio_a", "value": "1.0", "type": "FLOAT"}],
                          children=[primary, spec_cls(name="other", type="MODEL", component=Scaler())])
        svc = svc_cls(router, name="p")
        outs[pkg] = asyncio.run(svc.predict(msg_cls(payload=images, kind="rawTensor")))
    ours, theirs = outs["torch_port"], outs["jax"]
    assert ours.status == theirs.status and ours.status["code"] == 200
    assert ours.meta.tags == theirs.meta.tags == {"degraded": True, "fallback_for": "resnet"}
    assert ours.meta.routing == theirs.meta.routing == {"router": 0}
    assert ours.meta.request_path == theirs.meta.request_path
    assert ours.meta.request_path["resnet-small"] == "resnet-tiny:fallback"
    got, want = np.asarray(ours.host_payload()), np.asarray(theirs.host_payload())
    assert got.shape == want.shape == (2, NUM_CLASSES)
    np.testing.assert_allclose(got, want, **TOL)


def test_balanced_replicas_answer_across_a_killed_replica(tmp_path):
    """Two port microservice replicas (the CLI with --api GRPC, ResNetTiny
    on the CPU, one seed) behind a BalancedClient in the graph's root
    node, as JAX's deployer wires an autoscaled root.  Both serve; after
    SIGKILL of one, every request is still answered with the in-process
    rows, the dead replica's breaker opens and failovers are counted."""
    import json
    import signal
    import subprocess
    import time

    import grpc

    from seldon_core_tpu_torch.engine import BalancedClient, PredictorService, UnitSpec, build_client
    from seldon_core_tpu_torch.engine.graph import Endpoint
    from seldon_core_tpu_torch.runtime.message import InternalMessage
    from seldon_core_tpu_torch.utils import metrics

    params = [{"name": "model", "value": "resnet_tiny", "type": "STRING"},
              {"name": "num_classes", "value": str(NUM_CLASSES), "type": "INT"},
              {"name": "dtype", "value": "float32", "type": "STRING"},
              {"name": "normalize", "value": "true", "type": "BOOL"},
              {"name": "max_batch_size", "value": "4", "type": "INT"},
              {"name": "warmup", "value": "false", "type": "BOOL"},
              {"name": "seed", "value": "5", "type": "INT"},
              {"name": "input_shape", "value": json.dumps(list(SHAPE)), "type": "JSON"},
              {"name": "device", "value": "cpu", "type": "STRING"}]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ports = [free_port(), free_port()]
    procs = []
    for i, port in enumerate(ports):
        log = open(tmp_path / f"replica{i}.log", "wb")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "seldon_core_tpu_torch.runtime.microservice",
             "seldon_core_tpu_torch.models.cudaserver.CudaServer", "--api", "GRPC", "--host", "127.0.0.1",
             "--grpc-port", str(port), "--unit-id", f"replica{i}", "--parameters", json.dumps(params)],
            cwd=root, stdout=log, stderr=subprocess.STDOUT))
        log.close()
    local = CudaServer(device="cpu", **{p["name"]: json.loads(p["value"]) if p["type"] in ("INT", "JSON", "BOOL")
                                         else p["value"] for p in params if p["name"] != "device"})
    local.load()
    images = np.random.default_rng(43).integers(0, 256, (12, *SHAPE)).astype(np.uint8)
    probe = predict_request(images[:1], "rawTensor")
    ann = {"seldon.io/breaker-failures": "2", "seldon.io/breaker-reset-ms": "60000",
           "seldon.io/grpc-retries": "2", "seldon.io/grpc-read-timeout": "20000"}
    failovers = 'seldon_tpu_transport_failovers_total{method="transform_input",transport="balanced",unit="model"}'

    def failover_count() -> float:
        for line in metrics.generate_latest().decode().splitlines():
            if line.startswith(failovers + " "):
                return float(line.rpartition(" ")[2])
        return 0.0

    try:
        for i, port in enumerate(ports):  # ready: the replica answers a predict
            deadline = time.time() + 120
            with grpc.insecure_channel(f"127.0.0.1:{port}") as channel:
                predict = services.unary_callable(channel, "Model", "Predict")
                while True:
                    assert procs[i].poll() is None, (tmp_path / f"replica{i}.log").read_text()[-4000:]
                    try:
                        predict(pb.SeldonMessage.FromString(probe), timeout=5)
                        break
                    except grpc.RpcError:
                        assert time.time() < deadline, f"replica {i} never became ready"
                        time.sleep(0.2)
        endpoint = lambda port: UnitSpec(name="model", type="MODEL",  # noqa: E731
                                         endpoint=Endpoint("127.0.0.1", port, "GRPC"))
        before = failover_count()

        async def go():
            replicas = [build_client(endpoint(port), ann) for port in ports]
            svc = PredictorService(endpoint(ports[0]), name="main", annotations=ann,
                                   clients={"model": BalancedClient(replicas)})
            assert svc.single_local_model() is None  # a balanced root is not fast-path eligible
            outs = []
            try:
                for i in range(4):
                    outs.append(await asyncio.wait_for(
                        svc.predict(InternalMessage(payload=images[i:i + 1], kind="rawTensor")), 60))
                procs[1].send_signal(signal.SIGKILL)
                procs[1].wait(timeout=30)
                for i in range(4, 12):
                    outs.append(await asyncio.wait_for(
                        svc.predict(InternalMessage(payload=images[i:i + 1], kind="rawTensor")), 60))
                return outs, [r.breaker.state for r in replicas]
            finally:
                await svc.close()

        outs, states = asyncio.run(go())
        after = failover_count()
    finally:
        local.unload()
        for proc in procs:
            if proc.poll() is None:
                proc.terminate()
            proc.wait(timeout=30)
    want = np.asarray(local.predict(images, []), np.float64)
    for i, out in enumerate(outs):
        assert out.status["status"] == "SUCCESS", (i, out.status)
        got = np.asarray(out.host_payload(), np.float64)[0]
        assert np.linalg.norm(got - want[i]) / np.linalg.norm(want[i]) <= 2e-2
    assert states == ["closed", "open"]
    assert after - before >= 1
