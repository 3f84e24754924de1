"""The port's native ingress against the JAX package's.

The port builds its own copy of the C++ library from ``native/``
(``seldon_core_tpu_torch/native``, g++ here); a failed build leaves every
lane but the native ingress serving.  Then ResNetTiny on ``CudaServer(device="cpu")`` behind the port's
``serve_native_ingress`` and on ``JaxServer`` behind the JAX package's,
with the same f32 parameters, answer the same requests on every lane
(gRPC ``Predict`` with uint8 ``rawTensor`` flat rows through the C++
fast lane, an HTTP SRT1 frame, a multi-frame container through
``raw_batch_views``, ``Seldon/PredictRaw``): logits agree within
``rtol = atol = 1e-4`` (batch shapes differ between the lanes, so never
bit-equality), and each against the in-process model.  The fallback
lane (JSON, ``SendFeedback``, a two-node graph), the zero-copy knob and
``GenerateStream``'s answer to a predictor that cannot stream are held
against JAX's answers.
"""

import asyncio
import base64
import json
import os
import socket
import sys
import threading
import time

import grpc
import jax
import numpy as np
import pytest

from seldon_core_tpu import native as jax_native
from seldon_core_tpu.engine import PredictorService as JaxPredictorService
from seldon_core_tpu.engine import UnitSpec as JaxUnitSpec
from seldon_core_tpu.engine.native_ingress import serve_native_ingress as jax_serve_native_ingress
from seldon_core_tpu.engine.server import Gateway as JaxGateway
from seldon_core_tpu.models.jaxserver import JaxServer
from seldon_core_tpu.models.resnet import ResNetTiny as FlaxResNetTiny
from seldon_core_tpu_torch import codec, native
from seldon_core_tpu_torch.batching import DynamicBatcher
from seldon_core_tpu_torch.engine import PredictorService, UnitSpec, fast_lane_for, serve_native_ingress
from seldon_core_tpu_torch.engine.server import Gateway
from seldon_core_tpu_torch.models.cudaserver import CudaServer
from seldon_core_tpu_torch.native import frontserver
from seldon_core_tpu_torch.proto import pb, services
from seldon_core_tpu_torch.runtime import grpc_server

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
FLAT = int(np.prod(SHAPE))
# f32 servers, same weights: rtol = atol = 1e-4 (summation order only)
TOL = dict(rtol=1e-4, atol=1e-4)
PREDICT = "/api/v0.1/predictions"
RAW_CT = "application/x-seldon-raw"


# ---------------------------------------------------------------------------
# the port's build of the library, and what does not need it
# ---------------------------------------------------------------------------


def test_library_is_the_ports_own_build():
    lib = native.get_lib()
    assert lib is not None and lib.native_abi_version() == native.ABI_VERSION == 4
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert native.SOURCE_DIR.name == "native" and native.BUILD_DIR.name == "_build"
    assert frontserver.available()


@pytest.fixture
def unbuilt(monkeypatch, tmp_path):
    """The binding as a fresh process sees it: nothing loaded or tried yet,
    no prebuilt library named, and an empty build directory."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.delenv("SELDON_TPU_NATIVE_SO", raising=False)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    return monkeypatch, tmp_path


@pytest.mark.parametrize("fault", ["build_dir_not_writable", "cxx_missing", "cxx_fails"])
def test_a_failed_build_is_logged_and_only_the_ingress_refuses(unbuilt, fault, caplog):
    monkeypatch, tmp_path = unbuilt
    if fault == "build_dir_not_writable":  # a path under a regular file: mkdir raises an OSError, even as root
        (tmp_path / "file").write_text("")
        monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "file" / "_build")
    elif fault == "cxx_missing":  # subprocess.run raises FileNotFoundError
        monkeypatch.setenv("CXX", str(tmp_path / "no-such-g++"))
    else:
        monkeypatch.setenv("CXX", "false")
    with caplog.at_level("WARNING", logger=native.__name__):
        assert native.get_lib() is None and not native.available() and not frontserver.available()
    assert "native ingress cannot start" in caplog.text
    with pytest.raises(RuntimeError, match="library unavailable"):
        frontserver.NativeFrontServer(stub=True, out_dim=2, feature_dim=4, host="127.0.0.1")
    assert not any(tmp_path.rglob("*.so"))


def test_the_batcher_and_the_codec_never_build_the_library(unbuilt):
    monkeypatch, tmp_path = unbuilt
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-g++"))
    arr = np.arange(12, dtype=np.uint8).reshape(3, 4)
    body = codec.build_json_payload(arr, None, "rawTensor")
    np.testing.assert_array_equal(codec.extract_json_payload(body)[0], arr)
    with DynamicBatcher(lambda b: b * 2, max_batch_size=4, max_wait_ms=1.0) as b:
        np.testing.assert_array_equal(b.submit_future(np.ones((1, 3))).result(timeout=30), np.full((1, 3), 2.0))
    assert native._TRIED is False and not native.BUILD_DIR.exists()


@pytest.mark.parametrize("n", [0, 1, 2, 3, 4, 5, 100, 3000])
def test_rawtensor_json_matches_jax_byte_for_byte(n):
    """stdlib base64 on the port's JSON lane; JAX's runs through its native
    binding: the bodies and the decoded arrays are equal."""
    from seldon_core_tpu.codec import jsonpath as jax_jsonpath

    arr = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    body = codec.build_json_payload(arr, None, "rawTensor")
    assert json.dumps(body, sort_keys=True) == json.dumps(
        jax_jsonpath.build_json_payload(arr, None, "rawTensor"), sort_keys=True)
    got, want = codec.extract_json_payload(body)[0], jax_jsonpath.extract_json_payload(body)[0]
    assert got.dtype == np.asarray(want).dtype == np.uint8
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("data", ["ab*d", "abc", "YWJj\nZA=="])
def test_malformed_base64_rawtensor_is_refused_as_jax_does(data):
    """Both codecs refuse it as a bad request (a ValueError: 400); the
    port's stdlib decoder names the field."""
    from seldon_core_tpu.codec import jsonpath as jax_jsonpath

    body = {"data": {"rawTensor": {"shape": [3], "dtype": "uint8", "data": data}}}
    with pytest.raises(ValueError):
        jax_jsonpath.extract_json_payload(body)
    with pytest.raises(codec.PayloadError, match="rawTensor data is not valid base64"):
        codec.extract_json_payload(body)


def test_batcher_pads_a_coalesced_batch():
    with DynamicBatcher(lambda b: b * 2, max_batch_size=4, max_wait_ms=50.0) as b:
        futures = [b.submit_future(np.full((1, 3), i, np.float32)) for i in range(3)]
        outs = [f.result(timeout=30) for f in futures]
    for i, out in enumerate(outs):
        np.testing.assert_array_equal(out, np.full((1, 3), 2 * i, np.float32))
    assert b.stats.padded_rows == 1 and b.stats.batches == 1


def test_batcher_stop_fails_requests_it_never_launched():
    started, release = threading.Event(), threading.Event()

    def slow(batch):
        started.set()
        release.wait(timeout=30)
        return batch

    b = DynamicBatcher(slow, max_batch_size=1, max_wait_ms=0.1)
    b.start()
    first = b.submit_future(np.ones((1, 2)))
    assert started.wait(timeout=30)
    queued = [b.submit_future(np.ones((1, 2))) for _ in range(3)]
    stopper = threading.Thread(target=b.stop)
    stopper.start()
    release.set()
    stopper.join(timeout=30)
    assert not stopper.is_alive()
    np.testing.assert_array_equal(first.result(timeout=30), np.ones((1, 2)))
    for f in queued:  # never launched: failed, not left hanging
        with pytest.raises(RuntimeError, match="stopped"):
            f.result(timeout=30)


# ---------------------------------------------------------------------------
# the native front server alone
# ---------------------------------------------------------------------------


def _http(port: int, method: str, path: str, body: bytes = b"", ctype: str = "application/json"):
    head = f"{method} {path} HTTP/1.1\r\nHost: t\r\nContent-Type: {ctype}\r\nContent-Length: {len(body)}\r\n\r\n"
    with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
        s.sendall(head.encode() + body)
        status, payload, _ = frontserver.read_http_response(s, b"", timeout_s=60)
    return status, payload


def test_stub_mode_serves_in_cpp():
    with frontserver.NativeFrontServer(stub=True, out_dim=3, feature_dim=4, host="127.0.0.1") as srv:
        body = json.dumps({"data": {"tensor": {"shape": [2, 4], "values": list(range(8))}}}).encode()
        status, payload = _http(srv.port, "POST", PREDICT, body)
        assert status == 200
        out = json.loads(payload)["data"]["tensor"]
        assert out["shape"] == [2, 3]
        np.testing.assert_allclose(np.reshape(out["values"], (2, 3)), [[0.9, 0.05, 0.05]] * 2, rtol=1e-6)
        frame = codec.pack_frame(np.zeros((3, 4), np.float32))
        status, payload = _http(srv.port, "POST", PREDICT, frame, RAW_CT)
        assert status == 200 and codec.unpack_frame(payload).shape == (3, 3)
        assert _http(srv.port, "GET", "/ping")[0] == 200
        stats = srv.stats()
    assert stats["fast_requests"] == 2 and stats["batches"] == 2 and stats["failures"] == 0
    assert srv.stats()["requests"] == 0  # a stopped server reads zeros, never a freed handle


def test_http_blob_drives_the_cpp_load_client():
    with frontserver.NativeFrontServer(stub=True, out_dim=2, feature_dim=4, host="127.0.0.1") as srv:
        blob = frontserver.build_http_blob(PREDICT, codec.pack_frame(np.ones((1, 4), np.float32)), RAW_CT)
        out = frontserver.native_load(srv.port, blob, seconds=0.5, connections=2, depth=2)
        msg = pb.SeldonMessage()
        msg.data.tensor.shape.extend([1, 4])
        msg.data.tensor.values.extend([1.0] * 4)
        grpc_out = frontserver.native_load_grpc(srv.port, "/seldon.protos.Seldon/Predict", msg.SerializeToString(),
                                                seconds=0.5, connections=2, depth=2)
    assert out["ok"] > 0 and out["non2xx"] == 0 and out["errors"] == 0
    assert grpc_out["ok"] > 0 and grpc_out["non2xx"] == 0 and grpc_out["errors"] == 0


# ---------------------------------------------------------------------------
# ResNetTiny behind both packages' native ingress
# ---------------------------------------------------------------------------


class _Loop:
    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()

    def run(self, coro, timeout: float = 300.0):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def close(self):
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=10)


class _Identity:
    def transform_input(self, X, names, meta=None):
        return np.asarray(X)


def _graph(unit_cls, component, two_node: bool):
    model = unit_cls(name="m", type="MODEL", component=component)
    if not two_node:
        return model
    return unit_cls(name="pre", type="TRANSFORMER", component=_Identity(), children=[model])


@pytest.fixture(scope="module")
def deployments():
    """Per package: the one-MODEL and the two-node deployment behind a
    native ingress, and the model in-process."""
    assert native.available() and jax_native.available(), "both native libraries must build here"
    variables = random_variables(FlaxResNetTiny(num_classes=NUM_CLASSES), SHAPE, seed=31)
    common = dict(model="resnet_tiny", num_classes=NUM_CLASSES, dtype="float32", normalize=True,
                  max_batch_size=8, max_wait_ms=1.0, warmup=False)
    js = JaxServer(**common)
    js.load()
    js.variables = jax.device_put(variables)
    cs = CudaServer(device="cpu", variables=variables, **common)
    cs.load()
    packages = {
        "jax": (js, JaxPredictorService, JaxUnitSpec, JaxGateway, jax_serve_native_ingress),
        "torch_port": (cs, PredictorService, UnitSpec, Gateway, serve_native_ingress),
    }
    loop = _Loop()
    out, handles, gateways = {}, [], []
    try:
        for name, (component, svc_cls, unit_cls, gw_cls, serve) in packages.items():
            for two_node in (False, True):
                gateway = gw_cls([(svc_cls(_graph(unit_cls, component, two_node), name="p"), 1.0)])
                gateways.append(gateway)
                handle = loop.run(serve(gateway, host="127.0.0.1", http_port=0))
                handles.append(handle)
                out[name, two_node] = {"port": handle.port, "handle": handle, "gateway": gateway,
                                       "component": component}
        deadline = time.time() + 60
        while time.time() < deadline and any(_http(d["port"], "GET", "/ready")[0] != 200 for d in out.values()):
            time.sleep(0.2)
        yield out
    finally:
        for handle in handles:
            loop.run(handle.stop())
        loop.close()
        cs.unload()
        js.unload()


def _images(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, FLAT), dtype=np.uint8)


def _grpc(port: int):
    return grpc.insecure_channel(f"127.0.0.1:{port}", options=grpc_server.message_size_options())


def _grpc_predict(port: int, images: np.ndarray):
    req = pb.SeldonMessage()
    req.data.rawTensor.dtype = "uint8"
    req.data.rawTensor.shape.extend(images.shape)
    req.data.rawTensor.data = images.tobytes()
    with _grpc(port) as channel:
        resp = services.unary_callable(channel, "Seldon", "Predict")(req, timeout=120)
    r = resp.data.rawTensor
    return np.frombuffer(r.data, dtype=r.dtype).reshape(tuple(r.shape)), resp


def _predict_raw(port: int, body: bytes) -> bytes:
    with _grpc(port) as channel:
        call = channel.unary_unary("/seldon.protos.Seldon/PredictRaw", request_serializer=lambda b: b,
                                   response_deserializer=lambda b: b)
        return call(body, timeout=120)


def _local(deployments, images: np.ndarray) -> np.ndarray:
    cs = deployments["torch_port", False]["component"]
    return np.asarray(cs.predict(images.reshape(-1, *SHAPE), []))


def _lanes(port: int, images: np.ndarray):
    """Every fast-lane-eligible lane's answer for the same images."""
    rows = [1, 2, len(images) - 3]
    parts = np.split(images, np.cumsum(rows)[:-1])
    grpc_rows, resp = _grpc_predict(port, images)
    status, frame = _http(port, "POST", PREDICT, codec.pack_frame(images), RAW_CT)
    assert status == 200
    status, container = _http(port, "POST", PREDICT, codec.pack_frames(parts), RAW_CT)
    assert status == 200
    raw = codec.unpack_frame(_predict_raw(port, codec.pack_frame(images))).array()
    return {
        "grpc_predict": grpc_rows,
        "http_frame": codec.unpack_frame(frame).array(),
        "multi_frame": np.concatenate([v.array() for v in codec.unpack_frames(container)]),
        "predict_raw": raw,
    }, resp


def test_fast_lane_eligibility(deployments):
    lane = fast_lane_for(deployments["torch_port", False]["gateway"])
    assert lane == {"feature_dim": FLAT, "out_dim": NUM_CLASSES, "names": [f"t:{i}" for i in range(NUM_CLASSES)],
                    "model_name": "m", "max_batch": 8, "buckets": [1, 2, 4, 8]}
    assert fast_lane_for(deployments["torch_port", True]["gateway"]) is None  # two nodes: the fallback lane


@pytest.mark.parametrize("two_node", [False, True], ids=["one_model", "two_node"])
def test_every_lane_agrees_with_jax_and_in_process(deployments, two_node):
    images = _images(7, seed=int(two_node))
    port = deployments["torch_port", two_node]["port"]
    before = deployments["torch_port", two_node]["handle"].stats()
    if two_node:
        grpc_rows, _ = _grpc_predict(port, images)
        status, frame = _http(port, "POST", PREDICT, codec.pack_frame(images), RAW_CT)
        got = {"grpc_predict": grpc_rows, "http_frame": codec.unpack_frame(frame).array()}
        assert status == 200
        want = {"grpc_predict": _grpc_predict(deployments["jax", True]["port"], images)[0],
                "http_frame": codec.unpack_frame(_http(deployments["jax", True]["port"], "POST", PREDICT,
                                                       codec.pack_frame(images), RAW_CT)[1]).array()}
    else:
        got, resp = _lanes(port, images)
        want, jax_resp = _lanes(deployments["jax", False]["port"], images)
        assert resp.meta.requestPath == jax_resp.meta.requestPath == {"m": "native"}
        assert list(resp.data.names) == list(jax_resp.data.names)
    local = _local(deployments, images)
    for lane, rows in got.items():
        assert rows.dtype == np.float32 and rows.shape == (7, NUM_CLASSES), lane
        np.testing.assert_allclose(rows, want[lane], **TOL, err_msg=lane)
        np.testing.assert_allclose(rows, local, **TOL, err_msg=lane)
    after = deployments["torch_port", two_node]["handle"].stats()
    assert after["failures"] == before["failures"]
    fast = after["fast_requests"] - before["fast_requests"]
    assert fast == (0 if two_node else 2)  # gRPC Predict and the single frame; the rest is the fallback lane
    if two_node:  # the batched container needs one in-process MODEL: both packages refuse it alike
        bad = codec.pack_frames([images[:1], images[1:]])
        for pkg in ("torch_port", "jax"):
            status, body = _http(deployments[pkg, True]["port"], "POST", PREDICT, bad, RAW_CT)
            assert status == 400 and "single-local-MODEL" in json.loads(body)["status"]["info"]


def test_a_message_larger_than_one_h2_frame(deployments):
    images = _images(8 * 48, seed=5)[:8]  # 8 rows: 24 KB; pad the message past 1 MiB with names
    req = pb.SeldonMessage()
    req.data.names.extend(["n" * 1024] * 1100)
    req.data.rawTensor.dtype = "uint8"
    req.data.rawTensor.shape.extend(images.shape)
    req.data.rawTensor.data = images.tobytes()
    assert req.ByteSize() > 1 << 20
    with _grpc(deployments["torch_port", False]["port"]) as channel:
        resp = services.unary_callable(channel, "Seldon", "Predict")(req, timeout=120)
    r = resp.data.rawTensor
    rows = np.frombuffer(r.data, dtype=r.dtype).reshape(tuple(r.shape))
    np.testing.assert_allclose(rows, _local(deployments, images), **TOL)


def test_fallback_lane_json_and_feedback_match_jax(deployments):
    x = _images(2, seed=9).reshape(2, *SHAPE).astype(np.float64)
    body = json.dumps({"data": {"ndarray": x.tolist()}}).encode()
    answers = {}
    for pkg in ("torch_port", "jax"):
        port = deployments[pkg, False]["port"]
        status, payload = _http(port, "POST", PREDICT, body)
        assert status == 200
        answers[pkg] = json.loads(payload)
        # feedback on the answer, over gRPC and over HTTP
        fb = pb.Feedback(reward=1.0)
        fb.response.meta.tags["predictor"].string_value = "p"
        with _grpc(port) as channel:
            out = services.unary_callable(channel, "Seldon", "SendFeedback")(fb, timeout=60)
        assert out.status.status == pb.Status.SUCCESS, (pkg, out.status)
        status, payload = _http(port, "POST", "/api/v0.1/feedback",
                                json.dumps({"reward": 0.5, "response": answers[pkg]}).encode())
        assert status == 200, (pkg, payload)
    got, want = answers["torch_port"], answers["jax"]
    assert got["meta"]["tags"]["predictor"] == want["meta"]["tags"]["predictor"] == "p"
    np.testing.assert_allclose(np.asarray(got["data"]["ndarray"]), np.asarray(want["data"]["ndarray"]), **TOL)
    assert deployments["torch_port", False]["gateway"].predictors[0].stats["feedback"] >= 2


def test_metrics_and_openapi_on_the_native_port(deployments):
    port = deployments["torch_port", False]["port"]
    status, text = _http(port, "GET", "/metrics")
    assert status == 200 and b'cudaserver_batches_total{predictor="p",unit="m"}' in text
    status, spec = _http(port, "GET", "/seldon.json")
    assert status == 200 and "paths" in json.loads(spec)
    assert _http(port, "GET", "/ready")[0] == 200
    # bridged to the predictor's explain, as in JAX: neither predictor has an explainer
    body = json.dumps({"data": {"ndarray": [[1.0]]}}).encode()
    for pkg in ("torch_port", "jax"):
        status, answer = _http(deployments[pkg, False]["port"], "POST", "/api/v0.1/explanations", body)
        assert status == 404 and json.loads(answer)["status"]["reason"] == "NO_EXPLAINER", (pkg, answer)


def test_generate_stream_is_unimplemented_naming_its_item(deployments):
    # a ResNet predictor cannot stream: both packages answer UNIMPLEMENTED
    # in the same words, naming what would serve it
    errors = {}
    for pkg in ("torch_port", "jax"):
        with _grpc(deployments[pkg, False]["port"]) as channel:
            call = channel.unary_stream("/seldon.protos.Seldon/GenerateStream", request_serializer=lambda b: b,
                                        response_deserializer=lambda b: b)
            with pytest.raises(grpc.RpcError) as e:
                list(call(pb.SeldonMessage().SerializeToString(), timeout=60))
        errors[pkg] = e.value
    got, want = errors["torch_port"], errors["jax"]
    assert got.code() == want.code() == grpc.StatusCode.UNIMPLEMENTED
    assert got.details() == want.details() and "predict_stream" in got.details()


def test_zero_copy_off_refuses_frames_as_jax_does(deployments, monkeypatch):
    monkeypatch.setenv("SELDON_TPU_ZERO_COPY", "0")
    frame = codec.pack_frame(np.ones((1, FLAT), np.int8))  # int8: not a fast-lane dtype, so Python sees it
    answers = {}
    for pkg in ("torch_port", "jax"):
        port = deployments[pkg, False]["port"]
        status, body = _http(port, "POST", PREDICT, frame, RAW_CT)
        with _grpc(port) as channel:
            call = channel.unary_unary("/seldon.protos.Seldon/PredictRaw", request_serializer=lambda b: b,
                                       response_deserializer=lambda b: b)
            with pytest.raises(grpc.RpcError) as e:
                call(frame, timeout=60)
        answers[pkg] = (status, json.loads(body), e.value.code(), e.value.details())
    assert answers["torch_port"] == answers["jax"]
    assert answers["torch_port"][0] == 400 and answers["torch_port"][2] == grpc.StatusCode.UNIMPLEMENTED
    assert "SELDON_TPU_ZERO_COPY" in answers["torch_port"][1]["status"]["info"]


def test_concurrent_fast_lane_clients_get_their_own_rows(deployments):
    port = deployments["torch_port", False]["port"]
    images = _images(24, seed=13)
    local = _local(deployments, images)
    errors = []

    def client(k):
        for i in range(k, 24, 6):
            try:
                rows, _ = _grpc_predict(port, images[i:i + 1])
                np.testing.assert_allclose(rows[0], local[i], **TOL)
            except Exception as e:  # noqa: BLE001 — gathered and reported below
                errors.append(e)

    threads = [threading.Thread(target=client, args=(k,)) for k in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors, errors


def test_raw_batch_views_match_per_request_predict(deployments):
    cs = deployments["torch_port", False]["component"]
    arrays = [_images(r, seed=r) for r in (1, 3, 2)]
    views = [codec.BufferView.from_array(a) for a in arrays]
    outs = cs.raw_batch_views(views)
    assert [o.shape for o in outs] == [(1, NUM_CLASSES), (3, NUM_CLASSES), (2, NUM_CLASSES)]
    for a, o in zip(arrays, outs):
        np.testing.assert_allclose(o, np.asarray(cs.predict(a.reshape(-1, *SHAPE), [])), **TOL)
    # a mixed-dtype wave stacks at the canonical dtype (float32 here)
    mixed = cs.raw_batch_views([arrays[0].astype(np.float32), arrays[0], arrays[0].astype(np.float64)])
    np.testing.assert_allclose(mixed[0], mixed[2], **TOL)
    assert cs.flat_feature_dim() == FLAT and cs.flat_out_dim() == NUM_CLASSES
