"""The port's ``grpc.aio`` gateway front end against the JAX package's.

The same requests go through the JAX package's ``add_seldon_service``
(``serve_gateway(..., grpc_mode="aio")``) and the port's, each on an aio
server of its own in one test:

* ``GenerateStream`` of a tiny float32 ``StreamingLM`` whose weights are
  one flax msgpack file, read by each package's own loader: the chunks
  joined are equal ids (greedy decoding; the JAX component serves bf16
  only, so its engine is built in float32 through the module's
  ``PagedEngine`` name);
* ``Predict`` of a ResNetTiny ``JaxServer`` and ``CudaServer(device="cpu")``
  with the same f32 parameters: logits within ``rtol = atol = 1e-4``, the
  tolerance of ``tests/test_torch_port_server.py``.

Then the port alone: its aio and sync front ends answer the same bytes
for ``Predict``, ``SendFeedback`` and ``PredictStream`` (a spent budget
included), refuse a missing bearer token with UNAUTHENTICATED, an
oversized ``PredictStream`` with RESOURCE_EXHAUSTED and a predictor
that cannot stream with UNIMPLEMENTED, map a component's 4xx to
INVALID_ARGUMENT, free a cancelled stream's slot and pages, and refuse an
unknown ``grpc_mode``.
"""

import asyncio
import os
import socket
import sys
import tempfile
import time
from contextlib import contextmanager

import grpc
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from seldon_core_tpu.engine import PredictorService as JaxPredictorService
from seldon_core_tpu.engine import UnitSpec as JaxUnitSpec
from seldon_core_tpu.engine import server as jax_server
from seldon_core_tpu.models import paged as jax_paged
from seldon_core_tpu.models.jaxserver import JaxServer
from seldon_core_tpu.models.resnet import ResNetTiny as FlaxResNetTiny
from seldon_core_tpu.models.transformer import TransformerLM as FlaxTransformerLM
from seldon_core_tpu_torch.engine import PredictorService, UnitSpec
from seldon_core_tpu_torch.engine import server
from seldon_core_tpu_torch.engine.sync_server import GENERATE_STREAM_UNSUPPORTED
from seldon_core_tpu_torch.engine.transport import CircuitBreaker
from seldon_core_tpu_torch.models.cudaserver import CudaServer
from seldon_core_tpu_torch.models.paged import StreamingLM
from seldon_core_tpu_torch.proto import pb, services
from seldon_core_tpu_torch.runtime import grpc_server
from seldon_core_tpu_torch.runtime.message import InternalMessage
from seldon_core_tpu_torch.utils.auth import OAuthConfig
from seldon_core_tpu_torch.utils.serialization import to_bytes

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_resnet import random_variables  # noqa: E402

NUM_CLASSES = 10
SHAPE = (32, 32, 3)
# f32 servers, same weights: rtol = atol = 1e-4 (summation order only)
TOL = dict(rtol=1e-4, atol=1e-4)
LM_CFG = dict(vocab_size=64, d_model=32, num_layers=1, num_heads=2, max_len=128)
LM_ENGINE = dict(page_size=8, max_slots=2, steps_per_call=2)
LM_NEW = 6
PROMPTS = ([5, 9, 13], [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11])
# the JAX component's words for a multi-row stream (paged.py:7379-7383)
MULTI_ROW = "token streaming serves one prompt per stream; send rows separately (predict() batches them)"
KNOBS = ("SELDON_TPU_CHUNK_IMPL", "SELDON_TPU_PAGED_KERNEL", "SELDON_TPU_KV_DTYPE")

PACKAGES = {
    "jax": (jax_server, JaxPredictorService, JaxUnitSpec),
    "torch_port": (server, PredictorService, UnitSpec),
}


@pytest.fixture(autouse=True)
def fresh_breakers():
    CircuitBreaker.reset_all()
    yield
    CircuitBreaker.reset_all()


@contextmanager
def no_env(*names):
    before = {k: os.environ.pop(k, None) for k in names}
    try:
        yield
    finally:
        for k, v in before.items():
            if v is not None:
                os.environ[k] = v


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def raw_request(x: np.ndarray, puid: str = "") -> pb.SeldonMessage:
    msg = pb.SeldonMessage()
    msg.data.rawTensor.shape.extend(x.shape)
    msg.data.rawTensor.dtype = x.dtype.name
    msg.data.rawTensor.data = x.tobytes()
    msg.meta.puid = puid
    return msg


def from_proto(msg: pb.SeldonMessage) -> np.ndarray:
    r = msg.data.rawTensor
    return np.frombuffer(r.data, dtype=np.dtype(r.dtype)).reshape(tuple(r.shape))


def prompt_request(prompt, **tags) -> pb.SeldonMessage:
    msg = InternalMessage(payload=np.asarray([prompt], np.int32), kind="ndarray")
    msg.meta.puid = "g-1"
    msg.meta.tags.update(tags)
    return msg.to_proto()


def tokens(msg: pb.SeldonMessage) -> list:
    return np.asarray(InternalMessage.from_proto(msg).host_payload()).reshape(-1).astype(int).tolist()


async def serve(pkg, gateway, mode="aio", **kw):
    """``serve_gateway`` of the package in ``mode``; returns the handles
    and the gRPC port."""
    grpc_port = free_port()
    runner, handle = await PACKAGES[pkg][0].serve_gateway(gateway, host="127.0.0.1", http_port=free_port(),
                                                          grpc_port=grpc_port, grpc_mode=mode, **kw)
    return runner, handle, grpc_port


async def stop(runner, handle):
    await handle.stop(None)
    await runner.cleanup()


def gateway_of(pkg, component, name="main"):
    mod, Service, Spec = PACKAGES[pkg]
    return mod.Gateway([(Service(Spec(name="m", type="MODEL", component=component), name=name), 1.0)])


# ---------------------------------------------------------------- the JAX package beside the port

@pytest.fixture(scope="module")
def lm_uri():
    lm = FlaxTransformerLM(dtype=jnp.float32, **LM_CFG)
    params = lm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    fd, path = tempfile.mkstemp(suffix=".msgpack")
    with os.fdopen(fd, "wb") as f:
        f.write(to_bytes(jax.tree_util.tree_map(np.asarray, params)))
    yield f"file://{path}"
    os.unlink(path)


async def generate(port, prompt, **tags):
    async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as channel:
        call = services.unary_stream_callable(channel, "Seldon", "GenerateStream")
        return [msg async for msg in call(prompt_request(prompt, **tags), timeout=60)]


def test_generate_stream_ids_equal_the_jax_aio_gateways(lm_uri, monkeypatch):
    jax_engine = jax_paged.PagedEngine
    # the JAX component builds a bf16 engine; f32 on both sides makes greedy ids comparable
    monkeypatch.setattr(jax_paged, "PagedEngine",
                        lambda params, dtype=None, **kw: jax_engine(params, dtype=jnp.float32, **kw))
    with no_env(*KNOBS):
        components = {
            "jax": jax_paged.StreamingLM(model_uri=lm_uri, max_new_tokens=LM_NEW, **LM_CFG, **LM_ENGINE),
            "torch_port": StreamingLM(model_uri=lm_uri, device="cpu", dtype="float32", max_new_tokens=LM_NEW,
                                      **LM_CFG, **LM_ENGINE),
        }
        for c in components.values():
            c.load()

    async def go(pkg):
        runner, handle, port = await serve(pkg, gateway_of(pkg, components[pkg]))
        try:
            return [await generate(port, p) for p in PROMPTS]
        finally:
            await stop(runner, handle)

    try:
        got = {pkg: asyncio.run(go(pkg)) for pkg in PACKAGES}
    finally:
        components["jax"].shutdown()
        components["torch_port"].unload()
    for jax_chunks, port_chunks in zip(got["jax"], got["torch_port"]):
        joined = [t for m in port_chunks for t in tokens(m)]
        assert len(joined) == LM_NEW and all(m.meta.puid == "g-1" for m in port_chunks)
        assert joined == [t for m in jax_chunks for t in tokens(m)]


@pytest.fixture(scope="module")
def resnets():
    """A JaxServer and a CPU CudaServer with the same f32 parameters."""
    variables = random_variables(FlaxResNetTiny(num_classes=NUM_CLASSES), SHAPE, seed=31)
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


def test_predict_logits_match_the_jax_aio_gateways(resnets):
    rng = np.random.default_rng(5)
    batches = [rng.integers(0, 256, (n, *SHAPE), dtype=np.uint8) for n in (1, 3)]

    async def go(pkg):
        runner, handle, port = await serve(pkg, gateway_of(pkg, resnets[pkg]))
        try:
            async with grpc.aio.insecure_channel(f"127.0.0.1:{port}",
                                                 options=grpc_server.message_size_options()) as channel:
                predict = services.unary_callable(channel, "Seldon", "Predict")
                return [await predict(raw_request(x), timeout=60) for x in batches]
        finally:
            await stop(runner, handle)

    got = {pkg: asyncio.run(go(pkg)) for pkg in PACKAGES}
    for x, a, b in zip(batches, got["jax"], got["torch_port"]):
        assert b.meta.tags["predictor"].string_value == "main"
        assert from_proto(b).shape == (len(x), NUM_CLASSES)
        np.testing.assert_allclose(from_proto(b), from_proto(a), **TOL)


# ---------------------------------------------------------------- the port's two front ends

class Affine:
    """``2 x + 1``, and the rewards it was sent."""

    def __init__(self):
        self.rewards = []

    def predict(self, X, names, meta=None):
        return np.asarray(X) * 2.0 + 1.0

    def send_feedback(self, features, feature_names, reward, truth, routing=None):
        self.rewards.append(float(reward))


def both_front_ends(component, work, **serve_kw):
    """``work(port)`` (a coroutine on a grpc.aio client) against one
    gateway served by the sync and by the aio front end."""

    async def go():
        gw = gateway_of("torch_port", component)
        out = {}
        for mode in ("sync", "aio"):
            runner, handle, port = await serve("torch_port", gw, mode=mode, **serve_kw)
            try:
                out[mode] = await work(port)
            finally:
                await stop(runner, handle)
        return out

    return asyncio.run(go())


def test_aio_and_sync_answer_the_same_bytes():
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    model = Affine()

    async def work(port):
        async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as channel:
            predict = services.unary_callable(channel, "Seldon", "Predict")
            out = await predict(raw_request(x, puid="p-1"), timeout=30)
            spent = await predict(raw_request(x, puid="p-2"), timeout=30,
                                  metadata=(("x-seldon-deadline-ms", "0"),))
            fb = pb.Feedback(reward=0.5)
            fb.request.CopyFrom(raw_request(x, puid="p-1"))
            fb.response.CopyFrom(out)
            ack = await services.unary_callable(channel, "Seldon", "SendFeedback")(fb, timeout=30)
            stream = services.stream_callable(channel, "Seldon", "PredictStream")
            chunks = [c async for c in stream(services.chunk_message(raw_request(x, puid="p-3"), chunk_bytes=7),
                                              timeout=30)]
        return out, spent, ack, b"".join(c.data for c in chunks)

    got = both_front_ends(model, work)
    for a, b in zip(got["sync"][:3], got["aio"][:3]):
        assert a.SerializeToString(deterministic=True) == b.SerializeToString(deterministic=True)
    assert got["sync"][3] == got["aio"][3]
    out, spent, ack, streamed = got["aio"]
    np.testing.assert_array_equal(from_proto(out), x * 2.0 + 1.0)
    assert out.meta.puid == "p-1" and out.meta.tags["predictor"].string_value == "main"
    assert spent.status.code == 504 and spent.status.reason == "DEADLINE_EXCEEDED"
    assert ack.status.status == pb.Status.SUCCESS and model.rewards == [0.5, 0.5]
    np.testing.assert_array_equal(from_proto(pb.SeldonMessage.FromString(streamed)), x * 2.0 + 1.0)


def blocking_predict_stream(port, request, **kw):
    """``PredictStream`` from a blocking client: its sender thread stops at
    the server's status (an aio client still writing when the server
    aborts sees its own write fail instead); the RpcError's code."""
    with grpc.insecure_channel(f"127.0.0.1:{port}") as channel:
        stream = services.stream_callable(channel, "Seldon", "PredictStream")
        with pytest.raises(grpc.RpcError) as err:
            list(stream(services.chunk_message(request, **kw), timeout=30))
    return err.value.code(), err.value.details()


def test_aio_refusals_carry_the_sync_servers_codes(monkeypatch):
    x = np.ones((1, 4), np.float32)
    monkeypatch.setattr(services, "STREAM_MAX_BYTES", 64)

    async def work(port):
        big = raw_request(np.ones((1, 64), np.float32))
        codes = {"oversized": await asyncio.to_thread(blocking_predict_stream, port, big, chunk_bytes=16)}
        async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as channel:
            gen = services.unary_stream_callable(channel, "Seldon", "GenerateStream")
            with pytest.raises(grpc.aio.AioRpcError) as err:
                [c async for c in gen(raw_request(x), timeout=30)]
            codes["cannot_stream"] = (err.value.code(), err.value.details())
        return codes

    got = both_front_ends(Affine(), work)
    assert got["aio"] == got["sync"]
    assert got["aio"]["oversized"] == (grpc.StatusCode.RESOURCE_EXHAUSTED, "stream exceeds 64 bytes")
    assert got["aio"]["cannot_stream"] == (grpc.StatusCode.UNIMPLEMENTED, GENERATE_STREAM_UNSUPPORTED)


def test_aio_needs_a_bearer_token_on_every_method():
    x = np.ones((1, 4), np.float32)

    async def work(port):
        codes = []
        async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as channel:
            calls = (
                lambda: services.unary_callable(channel, "Seldon", "Predict")(raw_request(x), timeout=30),
                lambda: services.unary_callable(channel, "Seldon", "SendFeedback")(pb.Feedback(reward=1.0),
                                                                                  timeout=30),
                lambda: _consume(services.unary_stream_callable(channel, "Seldon", "GenerateStream")(
                    raw_request(x), timeout=30)),
            )
            for call in calls:
                with pytest.raises(grpc.aio.AioRpcError) as err:
                    await call()
                codes.append(err.value.code())
        codes.append((await asyncio.to_thread(blocking_predict_stream, port, raw_request(x)))[0])
        return codes

    got = both_front_ends(Affine(), work, auth=OAuthConfig("k", "s"))
    assert got["aio"] == got["sync"] == [grpc.StatusCode.UNAUTHENTICATED] * 4


async def _consume(call):
    return [c async for c in call]


def test_unknown_grpc_mode_raises_before_anything_listens():
    http_port = free_port()

    async def go():
        with pytest.raises(ValueError, match="grpc_mode"):
            await server.serve_gateway(gateway_of("torch_port", Affine()), host="127.0.0.1", http_port=http_port,
                                       grpc_port=free_port(), grpc_mode="threads")

    asyncio.run(go())
    with socket.socket() as s:
        s.bind(("127.0.0.1", http_port))  # still free: the REST server never started


# ---------------------------------------------------------------- GenerateStream on the port's aio front end

@pytest.fixture(scope="module")
def lm():
    with no_env(*KNOBS):
        comp = StreamingLM(device="cpu", dtype="float32", max_new_tokens=LM_NEW, max_slots=4, page_size=8,
                           steps_per_call=2, prefix_cache=False, **LM_CFG)
        comp.load()
    yield comp
    comp.unload()


def test_aio_generate_stream_equals_unary_and_maps_errors(lm):
    async def work(port):
        chunks = await generate(port, PROMPTS[1], max_new_tokens=5)
        async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as channel:
            gen = services.unary_stream_callable(channel, "Seldon", "GenerateStream")
            bad = InternalMessage(payload=np.ones((2, 3), np.int32), kind="ndarray").to_proto()
            with pytest.raises(grpc.aio.AioRpcError) as err:
                await _consume(gen(bad, timeout=30))
            refused = [(err.value.code(), err.value.details())]
            with pytest.raises(grpc.aio.AioRpcError) as err:
                await _consume(gen(prompt_request(PROMPTS[0]), timeout=30, metadata=(("x-seldon-deadline-ms", "0"),)))
            refused.append((err.value.code(), err.value.details()))
        return chunks, refused

    got = both_front_ends(lm, work)
    want = lm.predict(np.asarray([PROMPTS[1]], np.int32), [], meta={"tags": {"max_new_tokens": 5}})[0]
    chunks, refused = got["aio"]
    assert len(chunks) >= 2 and all(m.meta.puid == "g-1" for m in chunks)
    assert [t for m in chunks for t in tokens(m)] == want.tolist()
    assert refused == got["sync"][1]
    assert refused[0][0] == grpc.StatusCode.INVALID_ARGUMENT and MULTI_ROW in refused[0][1]
    assert refused[1][0] == grpc.StatusCode.INTERNAL and "DEADLINE" in refused[1][1].upper()


def test_aio_cancelled_stream_frees_its_slot_and_pages(lm):
    total = lm.engine.engine_stats()["pool_pages_total"]
    tokens0 = lm.engine.engine_stats()["tokens"]

    async def go():
        runner, handle, port = await serve("torch_port", gateway_of("torch_port", lm))
        try:
            async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as channel:
                call = services.unary_stream_callable(channel, "Seldon", "GenerateStream")(
                    prompt_request(PROMPTS[0], max_new_tokens=100), timeout=60)
                first = await call.read()
                call.cancel()
            deadline = time.monotonic() + 20
            while time.monotonic() < deadline:
                stats = lm.engine.engine_stats()
                if stats["active"] == 0 and stats["queued"] == 0 and stats["free_pages"] == total:
                    break
                await asyncio.sleep(0.05)
            return first
        finally:
            await stop(runner, handle)

    first = asyncio.run(go())
    assert len(tokens(first)) >= 1
    stats = lm.engine.engine_stats()
    assert stats["active"] == 0 and stats["queued"] == 0 and stats["free_pages"] == total
    assert stats["tokens"] - tokens0 < 90  # far fewer than the abandoned budget
