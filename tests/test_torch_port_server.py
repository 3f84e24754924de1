"""The PyTorch port's serving stack against the JAX package's.

``CudaServer(device="cpu")`` and ``JaxServer`` serve ResNetTiny from the
same parameters (numpy-drawn flax variables, converted for the port);
their answers are compared directly and over REST (aiohttp TestClient).
Batch shapes differ between calls, so outputs are compared with
``allclose``, never bit-equality; tolerances are stated per test.
"""

import asyncio
import base64
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import jax
import numpy as np
import pytest
import torch

from seldon_core_tpu.batching import DynamicBatcher as JaxDynamicBatcher
from seldon_core_tpu.models.jaxserver import JaxServer
from seldon_core_tpu.models.resnet import ResNetTiny as FlaxResNetTiny
from seldon_core_tpu.runtime import rest as jax_rest
from seldon_core_tpu_torch.batching import DynamicBatcher, bucket_for, normalize_buckets
from seldon_core_tpu_torch.codec import PayloadError, from_device_async
from seldon_core_tpu_torch.models.cudaserver import CudaServer
from seldon_core_tpu_torch.proto import pb
from seldon_core_tpu_torch.runtime import MicroserviceError, microservice
from seldon_core_tpu_torch.runtime import rest
from seldon_core_tpu_torch.runtime.message import InternalMessage

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_resnet import random_variables  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_CLASSES = 10
SHAPE = (32, 32, 3)
# f32 servers, same weights: rtol = atol = 1e-4 (summation order only)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def servers():
    """A JaxServer and a CPU CudaServer with the same f32 parameters."""
    variables = random_variables(FlaxResNetTiny(num_classes=NUM_CLASSES), SHAPE, seed=21)
    common = dict(model="resnet_tiny", num_classes=NUM_CLASSES, dtype="float32", normalize=True,
                  max_batch_size=4, warmup=False)
    js = JaxServer(**common)
    js.load()
    js.variables = jax.device_put(variables)
    cs = CudaServer(device="cpu", variables=variables, **common)
    cs.load()
    yield js, cs
    js.unload()
    cs.unload()


def _images(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, *SHAPE), dtype=np.uint8)


def _raw_body(arr):
    return {"data": {"rawTensor": {"shape": list(arr.shape), "dtype": arr.dtype.name,
                                   "data": base64.b64encode(arr.tobytes()).decode("ascii")}}}


def _decode(body):
    data = body["data"]
    if "rawTensor" in data:
        r = data["rawTensor"]
        return np.frombuffer(base64.b64decode(r["data"]), dtype=r["dtype"]).reshape(r["shape"])
    if "ndarray" in data:
        return np.asarray(data["ndarray"], np.float64)
    t = data["tensor"]
    return np.asarray(t["values"]).reshape(t["shape"])


class TestAgainstJaxServer:
    def test_uint8_input_is_normalized_in_both(self, servers):
        js, cs = servers
        x = _images(3, seed=1)
        ref = np.asarray(js.predict(x, []))
        got = cs.predict(x, [])
        assert got.shape == (3, NUM_CLASSES) and got.dtype == np.float32
        np.testing.assert_allclose(got, ref, **TOL)

    def test_float_input_skips_normalization_in_both(self, servers):
        js, cs = servers
        x = _images(2, seed=2)
        xf = x.astype(np.float32)
        ref = np.asarray(js.predict(xf, []))
        got = cs.predict(xf, [])
        np.testing.assert_allclose(got, ref, **TOL)
        # the same pixels as uint8 are normalized, so the answers differ
        assert np.abs(got - cs.predict(x, [])).max() > 1e-2

    def test_single_example_without_batch_dim(self, servers):
        js, cs = servers
        x = _images(1, seed=3)[0]
        got = cs.predict(x, [])
        assert got.shape == (NUM_CLASSES,)
        np.testing.assert_allclose(got, np.asarray(js.predict(x, [])), **TOL)

    def test_bad_shape_error_matches(self, servers):
        js, cs = servers
        with pytest.raises(MicroserviceError) as port_err:
            cs.predict(np.zeros((2, 5)), [])
        from seldon_core_tpu.runtime import MicroserviceError as JaxMicroserviceError

        with pytest.raises(JaxMicroserviceError) as jax_err:
            js.predict(np.zeros((2, 5)), [])
        assert port_err.value.to_status() == jax_err.value.to_status()
        assert port_err.value.reason == "BAD_INPUT_SHAPE"

    def test_class_names_and_health(self, servers):
        js, cs = servers
        assert cs.class_names() == js.class_names()
        health = cs.health_status()
        assert health["loaded"] and health["device"] == "cpu" and health["buckets"] == [1, 2, 4]
        assert health["signatures"] == [list(SHAPE)]
        assert "fused_normalize" in health["kernel_launches"]


def test_launches_at_ready_leave_the_traffic_launches(monkeypatch):
    """``/health/status`` keeps the launch counts of the moment load
    finished, warmup included, so a reader of a replica process gets its
    traffic's launches as counts less those (one a batch).  On the CPU
    the plain version counts nothing: a stand-in counts each device call
    as K1 would on the card."""
    from seldon_core_tpu_torch.ops import kernels

    original = CudaServer.device_call

    def counted(self, batch):
        kernels._count("fused_normalize")
        return original(self, batch)

    monkeypatch.setattr(CudaServer, "device_call", counted)
    cs = CudaServer(model="resnet_tiny", num_classes=NUM_CLASSES, dtype="float32", normalize=True,
                    max_batch_size=4, device="cpu", warmup=True, warmup_dtypes=["uint8"])
    before = kernels.launch_counts()["fused_normalize"]
    cs.load()
    try:
        health = cs.health_status()
        warm = health["kernel_launches_at_ready"]["fused_normalize"] - before
        assert warm == len(health["buckets"]) * len(health["signatures"])
        for n in (1, 3, 2):
            cs.predict(np.random.default_rng(n).integers(0, 256, size=(n, *SHAPE), dtype=np.uint8), [])
        health = cs.health_status()
        served = health["kernel_launches"]["fused_normalize"] - health["kernel_launches_at_ready"]["fused_normalize"]
        assert served == cs.batcher.stats.batches == 3
    finally:
        cs.unload()


class TestOutputTails:
    @pytest.mark.parametrize("tail", [dict(softmax_outputs=True), dict(top_k=3)])
    def test_softmax_and_top_k_match_jax(self, tail):
        variables = random_variables(FlaxResNetTiny(num_classes=NUM_CLASSES), SHAPE, seed=22)
        common = dict(model="resnet_tiny", num_classes=NUM_CLASSES, dtype="float32", normalize=True,
                      max_batch_size=2, warmup=False, **tail)
        js = JaxServer(**common)
        js.load()
        js.variables = jax.device_put(variables)
        cs = CudaServer(device="cpu", variables=variables, **common)
        x = _images(2, seed=4)
        try:
            ref, got = np.asarray(js.predict(x, [])), cs.predict(x, [])
        finally:
            js.unload()
            cs.unload()
        assert got.shape == ref.shape
        if "top_k" in tail:  # [batch, 2, k]: class indices, then scores
            np.testing.assert_array_equal(got[:, 0], ref[:, 0])
            np.testing.assert_allclose(got[:, 1], ref[:, 1], **TOL)
            assert cs.class_names() == js.class_names() == []
        else:  # softmax: tolerance 1e-5 on probabilities
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)


class TestRest:
    def _post_both(self, servers, body, path="/predict", method="post"):
        js, cs = servers

        async def scenario():
            from aiohttp.test_utils import TestClient, TestServer

            out = []
            for app in (jax_rest.build_app(js), rest.build_app(cs)):
                client = TestClient(TestServer(app))
                await client.start_server()
                try:
                    if method == "post":
                        resp = await client.post(path, json=body)
                    else:
                        resp = await client.get(path)
                    out.append((resp.status, await resp.json()))
                finally:
                    await client.close()
            return out

        return asyncio.run(scenario())

    def test_predict_uint8_raw_tensor(self, servers):
        (js_status, js_body), (status, body) = self._post_both(servers, _raw_body(_images(2, seed=5)))
        assert js_status == status == 200
        assert body["data"]["rawTensor"]["dtype"] == js_body["data"]["rawTensor"]["dtype"] == "float32"
        assert body["data"]["names"] == js_body["data"]["names"]
        np.testing.assert_allclose(_decode(body), _decode(js_body), **TOL)
        assert {m["key"] for m in body["meta"]["metrics"]} >= {"cudaserver_batches_total"}

    def test_predict_ndarray_is_not_normalized(self, servers):
        x = _images(1, seed=6).astype(np.float64)
        (js_status, js_body), (status, body) = self._post_both(servers, {"data": {"ndarray": x.tolist()}})
        assert js_status == status == 200 and "ndarray" in body["data"]
        np.testing.assert_allclose(_decode(body), _decode(js_body), **TOL)

    def test_bad_input_shape_status_matches(self, servers):
        (js_status, js_body), (status, body) = self._post_both(servers, {"data": {"ndarray": [[1.0, 2.0, 3.0]]}})
        assert js_status == status == 400
        assert body == js_body
        assert body["status"]["reason"] == "BAD_INPUT_SHAPE"

    @pytest.mark.parametrize("body", [{"data": {}}, {"meta": {}},
                                      {"data": {"rawTensor": {"dtype": "nope", "data": ""}}}])
    def test_bad_payload_status_matches(self, servers, body):
        (js_status, js_body), (status, port_body) = self._post_both(servers, body)
        assert js_status == status == 400
        assert port_body == js_body
        assert port_body["status"]["reason"] == "BAD_PAYLOAD"

    def test_health_status_and_ping(self, servers):
        _, (status, body) = self._post_both(servers, None, path="/health/status", method="get")
        assert status == 200
        assert body["jsonData"]["loaded"] is True and body["jsonData"]["model"] == "resnet_tiny"

        async def ping():
            from aiohttp.test_utils import TestClient, TestServer

            client = TestClient(TestServer(rest.build_app(servers[1])))
            await client.start_server()
            try:
                pong = await (await client.get("/health/ping")).text()
                metrics = await (await client.get("/metrics")).text()
                bad = await client.post("/predict", data=b"{not json")
                return pong, metrics, bad.status, await bad.json()
            finally:
                await client.close()

        pong, metrics, bad_status, bad_body = asyncio.run(ping())
        assert pong == "pong"
        assert "# TYPE cudaserver_batches_total gauge" in metrics
        assert 'cudaserver_kernel_launches{kernel="fused_normalize"}' in metrics
        assert bad_status == 400 and bad_body["status"]["reason"] == "BAD_REQUEST"


class TestDeviceAndParameters:
    def test_cuda_requested_without_cuda_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(MicroserviceError, match="CUDA is not available") as err:
            CudaServer()
        assert err.value.reason == "NO_CUDA_DEVICE"

    def test_unknown_model_names_the_supported_ones(self):
        with pytest.raises(MicroserviceError, match="resnet50") as err:
            CudaServer(device="cpu", model="detector_yolo").load()
        assert err.value.reason == "UNKNOWN_MODEL"

    @pytest.mark.parametrize("name", ["model_uri", "quantize", "precision", "mesh", "extra_input_shapes"])
    def test_ported_parameters_refuse_or_serve_as_jaxserver(self, name, tmp_path):
        # quantize and precision are ported (the int8 lanes): a value
        # outside their vocabulary is refused as JaxServer refuses it.
        # model_uri and extra_input_shapes landed (ROADMAP A5, A6), and
        # mesh (A12): the server takes each and serves
        common = dict(device="cpu", model="resnet_tiny", num_classes=NUM_CLASSES, dtype="float32",
                      max_batch_size=2, warmup=False)
        if name == "mesh":
            # a batch-sharded replica group over a {"data": 2} mesh: the
            # weights once per distinct device, each batch split over the
            # data positions, the answers joined in order; JaxServer's
            # data-sharded program on two host devices answers the same
            from seldon_core_tpu.parallel import create_mesh as jax_create_mesh

            variables = random_variables(FlaxResNetTiny(num_classes=NUM_CLASSES), SHAPE, seed=6)
            mesh_common = dict(common, normalize=True, max_batch_size=4)
            js = JaxServer(mesh=jax_create_mesh({"data": 2}, devices=jax.devices()[:2]), **mesh_common)
            js.load()
            js.variables = jax.device_put(variables)
            cs = CudaServer(mesh={"data": 2}, variables=variables, **mesh_common)
            cs.load()
            x = _images(4, seed=7)
            try:
                assert cs.health_status()["mesh"] == {"data": 2} and len(cs._replicas) == 1
                np.testing.assert_allclose(cs.predict(x, []), np.asarray(js.predict(x, [])), **TOL)
            finally:
                js.unload(), cs.unload()
            return
        if name == "model_uri":
            from flax import serialization

            variables = random_variables(FlaxResNetTiny(num_classes=NUM_CLASSES), SHAPE, seed=4)
            (tmp_path / "w.msgpack").write_bytes(serialization.to_bytes(variables))
            served, held = CudaServer(model_uri=f"file://{tmp_path}", **common), CudaServer(variables=variables, **common)
            served.load(), held.load()
            x = _images(2, seed=5).astype(np.float32)
            try:  # same module, same batch shape: the same bits
                np.testing.assert_array_equal(served.predict(x, []), held.predict(x, []))
            finally:
                served.unload(), held.unload()
            return
        if name == "extra_input_shapes":
            cs = CudaServer(input_shape=SHAPE, extra_input_shapes=[(48, 48, 3)], **common)
            cs.load()
            try:
                assert cs.accepted_shapes() == [SHAPE, (48, 48, 3)]
                for shape in (SHAPE, (48, 48, 3)):
                    out = cs.predict(np.zeros((2, *shape), np.float32), [])
                    assert out.shape == (2, NUM_CLASSES) and np.isfinite(out).all()
            finally:
                cs.unload()
            return
        with pytest.raises(MicroserviceError, match=name) as err:
            CudaServer(device="cpu", **{name: "x"})
        assert err.value.reason == ("BAD_QUANTIZE" if name in ("quantize", "precision") else "BAD_PARAMETER")

    def test_seeded_random_init_is_deterministic_with_live_residual_branches(self):
        """Without variables the weights come from the seed alone, and no
        block's last BatchNorm scale is zero (flax's init zeroes it)."""
        x = _images(2, seed=10)
        outs = []
        for _ in range(2):
            cs = CudaServer(device="cpu", model="resnet_tiny", num_classes=3, max_batch_size=2,
                            normalize=True, warmup=False, seed=3)
            cs.load()
            try:
                for b in cs.module.blocks:
                    assert bool((getattr(b, f"bn{b.n_convs - 1}").weight != 0).all())
                outs.append(cs.predict(x, []))
            finally:
                cs.unload()
        assert np.isfinite(outs[0]).all()
        np.testing.assert_array_equal(outs[0], outs[1])

    def test_warmup_covers_every_bucket_and_dtype(self, monkeypatch):
        seen = []
        cs = CudaServer(device="cpu", model="resnet_tiny", num_classes=3, max_batch_size=4, normalize=True)
        real = cs.device_call
        monkeypatch.setattr(cs, "device_call", lambda b: seen.append((b.shape[0], b.dtype.name)) or real(b))
        cs.load()
        cs.unload()
        assert sorted(seen) == sorted((b, d) for b in (1, 2, 4) for d in ("float32", "uint8"))


class TestCli:
    @pytest.mark.parametrize("api", ["GRPC", "BOTH"])
    def test_cli_serves_grpc_on_the_cpu(self, api):
        import grpc

        from seldon_core_tpu_torch.proto import services
        from seldon_core_tpu_torch.runtime import grpc_server

        ports = []
        for _ in range(2):
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                ports.append(s.getsockname()[1])
        http_port, grpc_port = ports
        params = [{"name": "model", "value": "resnet_tiny", "type": "STRING"},
                  {"name": "num_classes", "value": "4", "type": "INT"},
                  {"name": "normalize", "value": "true", "type": "BOOL"},
                  {"name": "max_batch_size", "value": "2", "type": "INT"},
                  {"name": "device", "value": "cpu", "type": "STRING"}]
        proc = subprocess.Popen(
            [sys.executable, "-m", "seldon_core_tpu_torch.runtime.microservice",
             "seldon_core_tpu_torch.models.cudaserver.CudaServer", "--api", api, "--host", "127.0.0.1",
             "--http-port", str(http_port), "--grpc-port", str(grpc_port), "--parameters", json.dumps(params)],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        channel = grpc.insecure_channel(f"127.0.0.1:{grpc_port}", options=grpc_server.message_size_options())
        try:
            deadline = time.time() + 120
            while True:
                assert proc.poll() is None, proc.stdout.read().decode()
                try:
                    grpc.channel_ready_future(channel).result(timeout=1)
                    break
                except grpc.FutureTimeoutError:
                    assert time.time() < deadline, "CLI did not start serving gRPC"
            req = pb.SeldonMessage()
            images = _images(2, 7)
            req.data.rawTensor.shape.extend(images.shape)
            req.data.rawTensor.dtype = "uint8"
            req.data.rawTensor.data = images.tobytes()
            resp = services.unary_callable(channel, "Model", "Predict")(req, timeout=60)
            r = resp.data.rawTensor
            out = np.frombuffer(r.data, dtype=np.dtype(r.dtype)).reshape(tuple(r.shape))
            assert out.shape == (2, 4) and np.isfinite(out).all()
            rest_up = True
            try:
                urllib.request.urlopen(f"http://127.0.0.1:{http_port}/health/ping", timeout=2).read()
            except OSError:
                rest_up = False
            assert rest_up == (api == "BOTH")
        finally:
            channel.close()
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=60) == 0

    def test_cli_serves_rest_on_the_cpu(self):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        params = [{"name": "model", "value": "resnet_tiny", "type": "STRING"},
                  {"name": "num_classes", "value": "4", "type": "INT"},
                  {"name": "normalize", "value": "true", "type": "BOOL"},
                  {"name": "max_batch_size", "value": "2", "type": "INT"},
                  {"name": "device", "value": "cpu", "type": "STRING"}]
        proc = subprocess.Popen(
            [sys.executable, "-m", "seldon_core_tpu_torch.runtime.microservice",
             "seldon_core_tpu_torch.models.cudaserver.CudaServer", "--api", "REST", "--host", "127.0.0.1",
             "--http-port", str(port), "--parameters", json.dumps(params)],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        try:
            base = f"http://127.0.0.1:{port}"
            deadline = time.time() + 120
            while True:
                assert proc.poll() is None, proc.stdout.read().decode()
                try:
                    urllib.request.urlopen(base + "/health/ping", timeout=2).read()
                    break
                except OSError:
                    assert time.time() < deadline, "CLI did not start serving"
                    time.sleep(0.3)
            req = urllib.request.Request(base + "/predict", data=json.dumps(_raw_body(_images(2, 7))).encode(),
                                         headers={"Content-Type": "application/json"})
            body = json.loads(urllib.request.urlopen(req, timeout=30).read())
            out = _decode(body)
            assert out.shape == (2, 4) and np.isfinite(out).all()
        finally:
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=30) == 0


@pytest.mark.parametrize("batcher_cls", [JaxDynamicBatcher, DynamicBatcher], ids=["jax", "torch_port"])
class TestDynamicBatcherParity:
    """The port's batcher keeps the JAX package's contract."""

    def test_concurrent_requests_coalesce_and_rows_return_in_order(self, batcher_cls):
        calls = []
        release = threading.Event()

        def fn(batch):
            calls.append(batch.shape[0])
            return batch + 1

        b = batcher_cls(fn, max_batch_size=32, max_wait_ms=20.0)
        b.start()
        results = {}

        def worker(i):
            release.wait()
            results[i] = b.submit(np.full((1, 4), float(i)))

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        release.set()
        for t in threads:
            t.join()
        b.stop()
        for i in range(8):
            np.testing.assert_array_equal(results[i], np.full((1, 4), float(i) + 1))
        assert sum(calls) >= 8 and len(calls) < 8

    def test_padding_to_bucket_never_leaks(self, batcher_cls):
        shapes = []

        def fn(batch):
            shapes.append(batch.shape)
            assert not batch[3:].any()  # padding rows are zero
            return batch.sum(axis=1, keepdims=True)

        with batcher_cls(fn, max_batch_size=8, max_wait_ms=0.5) as b:
            out = b.submit(np.ones((3, 2)))
        assert shapes == [(4, 2)] and out.shape == (3, 1)
        np.testing.assert_array_equal(out, np.full((3, 1), 2.0))

    def test_error_propagates_to_caller(self, batcher_cls):
        def fn(batch):
            raise RuntimeError("device on fire")

        with batcher_cls(fn, max_batch_size=4, max_wait_ms=0.5) as b:
            with pytest.raises(RuntimeError, match="device on fire"):
                b.submit(np.ones((1, 2)))


class TestPortBatcherAndCodec:
    def test_torch_outputs_are_read_back(self):
        with DynamicBatcher(lambda batch: torch.from_numpy(batch) * 2, max_batch_size=4, max_wait_ms=0.5) as b:
            out = b.submit(np.ones((3, 2), np.float32))
        assert isinstance(out, np.ndarray)
        np.testing.assert_array_equal(out, np.full((3, 2), 2.0, np.float32))
        assert normalize_buckets(None, 4) == [1, 2, 4] and bucket_for(3, [1, 2, 4]) == 4
        assert isinstance(from_device_async(torch.ones(2)), np.ndarray)  # host data converts at once

    def test_proto_round_trip_and_tftensor_refusal(self):
        arr = _images(1, seed=8)
        msg = InternalMessage(payload=arr, kind="rawTensor", names=["a"])
        proto = msg.to_proto()
        assert proto.data.rawTensor.dtype == "uint8"
        back = InternalMessage.from_proto(pb.SeldonMessage.FromString(proto.SerializeToString()))
        np.testing.assert_array_equal(back.payload, arr)
        # the tftensor message this test once saw refused now decodes
        # (codec/tftensor.py): DT_FLOAT with no shape and no values is a
        # float32 scalar 0, answered as a tftensor
        tf = pb.SeldonMessage()
        tf.data.tftensor.dtype = 1
        msg = InternalMessage.from_proto(tf)
        assert msg.kind == "tftensor" and msg.payload.dtype == np.float32 and msg.payload.shape == ()
        assert float(msg.payload) == 0.0
        assert msg.to_proto().data.tftensor.dtype == 1
        with pytest.raises(PayloadError, match="tftensor|no tensor"):
            InternalMessage.from_json({"data": {"tftensor": {"dtype": "DT_FLOAT"}}})

    def test_proto_messages_are_shared_with_the_jax_package(self):
        from seldon_core_tpu.proto import pb as jax_pb

        assert jax_pb.SeldonMessage is pb.SeldonMessage
