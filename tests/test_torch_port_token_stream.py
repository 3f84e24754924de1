"""Token streaming in the port: the engine's token queues,
``StreamingLM.predict_stream``, and the gateway's three streaming lanes.

The port versions of ``tests/test_paged.py``'s ``TestTokenStreaming`` and
of ``tests/test_native_grpc.py``'s ``GenerateStream`` cases.  The engine's
streams are held against the JAX engine's on the same float32 weights
and requests (greedy, the ring chunk both engines pick on the CPU, and a
shrunk pool that evicts): the same chunks, in the same order.  Then the
port's own contract: the chunks joined equal the unary result cut at eos
and the budget, a multi-row request is JAX's 400, an abandoned generator
frees its slot and pages, a cancelled queued stream ends at once, an
evicted stream repeats no token (greedy or sampled), and REST SSE, sync
gRPC and the native ingress's ``GenerateStream`` each deliver the unary
row, with errors answered before any 200 (a bad prompt, a spent
deadline, a shed) and the bearer token required under OAuth.
"""

import asyncio
import json
import os
import queue
import threading
import time
from contextlib import contextmanager

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from seldon_core_tpu.models import paged as jax_paged
from seldon_core_tpu.models.transformer import TransformerLM as FlaxTransformerLM
from seldon_core_tpu_torch.engine import PredictorService, UnitSpec
from seldon_core_tpu_torch.engine.server import Gateway, build_gateway_app
from seldon_core_tpu_torch.models.convert import lm_params_from_flax
from seldon_core_tpu_torch.models.paged import PagedEngine, StreamingLM
from seldon_core_tpu_torch.proto import pb
from seldon_core_tpu_torch.runtime.component import MicroserviceError
from seldon_core_tpu_torch.runtime.message import InternalMessage

CFG = dict(vocab_size=64, d_model=32, num_layers=1, num_heads=2, max_len=128)
ENGINE = dict(page_size=8, max_slots=4, steps_per_call=2, prefix_cache=False)
PROMPT = np.array([5, 9, 13, 2, 30], np.int32)
MAX_NEW = 8
# the JAX component's words for a multi-row stream (paged.py:7379-7383)
MULTI_ROW = "token streaming serves one prompt per stream; send rows separately (predict() batches them)"


@contextmanager
def _no_env(*names):
    before = {k: os.environ.pop(k, None) for k in names}
    try:
        yield
    finally:
        for k, v in before.items():
            if v is not None:
                os.environ[k] = v


def _drain(stream, timeout=30):
    """A stream's chunks until its end marker."""
    chunks = []
    while True:
        got = stream.token_queue.get(timeout=timeout)
        if got is None:
            return chunks
        chunks.append(got)


def _prompts():
    rng = np.random.default_rng(2)
    return [rng.integers(0, CFG["vocab_size"], size=(n,)).astype(np.int32) for n in (13, 15, 14, 14)]


def _stream_all(eng, prompts, **kw):
    """Submit streamed requests, run the engine on a thread, and return
    each stream's chunks and its result."""
    streams = [eng.submit(p, max_new_tokens=MAX_NEW, stream_tokens=True, **kw) for p in prompts]
    runner = threading.Thread(target=eng.run)
    runner.start()
    chunks = [_drain(s) for s in streams]
    runner.join(timeout=60)
    return chunks, [s.result for s in streams]


@pytest.fixture(scope="module")
def flax_params():
    lm = FlaxTransformerLM(dtype=jnp.float32, **CFG)
    return lm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]


@pytest.fixture(scope="module")
def params(flax_params):
    return lm_params_from_flax(flax_params)


@pytest.fixture(scope="module")
def jax_streams(flax_params):
    """JAX's streamed chunks on a full pool and on a 9-page pool."""
    out = {}
    with _no_env("SELDON_TPU_CHUNK_IMPL", "SELDON_TPU_PAGED_KERNEL", "SELDON_TPU_KV_DTYPE"):
        for name, kw in (("full", {}), ("tight", {"num_pages": 9})):
            eng = jax_paged.PagedEngine(flax_params, dtype=jnp.float32, **CFG, **{**ENGINE, **kw})
            out[name] = _stream_all(eng, _prompts())[0], eng.engine_stats()["evictions"]
            eng.close()
    return out


def _port_engine(params, **kw):
    with _no_env("SELDON_TPU_CHUNK_IMPL", "SELDON_TPU_PAGED_KERNEL", "SELDON_TPU_KV_DTYPE"):
        return PagedEngine(params, dtype="float32", device="cpu", **CFG, **{**ENGINE, **kw})


@pytest.mark.parametrize("pool", ["full", "tight"])
def test_streamed_chunks_equal_the_jax_engines(params, jax_streams, pool):
    eng = _port_engine(params, **({"num_pages": 9} if pool == "tight" else {}))
    chunks, results = _stream_all(eng, _prompts())
    want, want_evictions = jax_streams[pool]
    assert chunks == want
    assert eng.engine_stats()["evictions"] == want_evictions
    assert (want_evictions > 0) == (pool == "tight")
    for c, r in zip(chunks, results):
        assert [t for part in c for t in part] == r.tolist()  # no eos: the whole budget


def test_streamed_tokens_equal_batch_result(params):
    eng = _port_engine(params)
    want = eng.generate(PROMPT, max_new_tokens=MAX_NEW)
    chunks, results = _stream_all(eng, [PROMPT])
    assert len(chunks[0]) >= 2  # incremental: one chunk a decode chunk
    assert [t for c in chunks[0] for t in c] == want.tolist()
    np.testing.assert_array_equal(results[0], want)


def test_streaming_clamps_at_eos_and_budget(params):
    eng = _port_engine(params, steps_per_call=4)
    full = eng.generate(PROMPT, max_new_tokens=6)
    eos = int(full[2])
    cut = full.tolist().index(eos) + 1
    s = eng.submit(PROMPT, max_new_tokens=6, eos_id=eos, stream_tokens=True)
    eng.run()
    streamed = [t for c in _drain(s, timeout=1) for t in c]
    assert streamed == full[:cut].tolist()  # ends at eos, inclusive, as the result is cut
    # a budget smaller than a chunk: the chunk's extra steps are never pushed
    s = eng.submit(PROMPT, max_new_tokens=3, stream_tokens=True)
    eng.run()
    assert [t for c in _drain(s, timeout=1) for t in c] == full[:3].tolist()


def test_cancel_queued_stream_resolves_immediately(params):
    eng = _port_engine(params)
    s = eng.submit(np.array([1, 2, 3], np.int32), max_new_tokens=4, stream_tokens=True)
    eng.cancel(s)  # never stepped: still queued
    assert s.event.is_set() and s.token_queue.get(timeout=1) is None
    assert not eng.has_work()


def test_failure_and_shed_end_the_stream(params):
    eng = _port_engine(params, max_slots=1, max_queue=1)
    running = eng.submit(PROMPT, max_new_tokens=MAX_NEW, stream_tokens=True)
    eng.step()  # admits it; one chunk
    queued = eng.submit(PROMPT, max_new_tokens=MAX_NEW, stream_tokens=True)
    urgent = eng.submit(PROMPT, max_new_tokens=MAX_NEW, stream_tokens=True, priority=2)  # sheds the queued one
    assert _drain(queued, timeout=1) == [] and queued.error.reason == "SHED"
    eng.fail_all(MicroserviceError("boom", status_code=500))
    assert [t for c in _drain(running, timeout=1) for t in c] == running.tokens[: ENGINE["steps_per_call"]]
    assert _drain(urgent, timeout=1) == [] and urgent.error is not None


@pytest.mark.parametrize("temperature", [0.0, 1.0], ids=["greedy", "sampled"])
def test_an_evicted_stream_repeats_no_token(params, temperature):
    kw = dict(temperature=temperature, seed=23)
    want = [_port_engine(params).generate(p, max_new_tokens=MAX_NEW, **kw) for p in _prompts()]
    eng = _port_engine(params, num_pages=9)
    chunks, results = _stream_all(eng, _prompts(), **kw)
    assert eng.engine_stats()["evictions"] > 0
    for c, r, w in zip(chunks, results, want):
        assert [t for part in c for t in part] == w.tolist()  # every token once, in order
        np.testing.assert_array_equal(r, w)


# ---- the component ----------------------------------------------------------

@pytest.fixture(scope="module")
def lm():
    with _no_env("SELDON_TPU_CHUNK_IMPL", "SELDON_TPU_PAGED_KERNEL", "SELDON_TPU_KV_DTYPE"):
        comp = StreamingLM(device="cpu", dtype="float32", max_new_tokens=MAX_NEW, **CFG, **ENGINE)
        comp.load()
    yield comp
    comp.unload()


def test_predict_stream_equals_predict(lm):
    X = PROMPT[None]
    want = lm.predict(X, [])[0]
    chunks = list(lm.predict_stream(X, []))
    assert len(chunks) >= 2 and all(c.dtype == np.int32 for c in chunks)
    np.testing.assert_array_equal(np.concatenate(chunks), want)
    # the same tags, seed rule and sampler: a sampled request streams its unary row
    meta = {"tags": {"temperature": 1.0, "max_new_tokens": 5}, "puid": "p-1"}
    np.testing.assert_array_equal(np.concatenate(list(lm.predict_stream(X, [], meta=meta))),
                                  lm.predict(X, [], meta=meta)[0])


def test_predict_stream_refuses_several_rows_with_jaxs_400(lm):
    with pytest.raises(MicroserviceError) as err:
        list(lm.predict_stream(np.ones((2, 3), np.int32), []))
    assert err.value.status_code == 400 and err.value.reason == "BAD_REQUEST"
    assert err.value.message == MULTI_ROW


def test_abandoned_stream_frees_slot(lm):
    total = lm.engine.engine_stats()["pool_pages_total"]
    tokens0 = lm.engine.engine_stats()["tokens"]
    gen = lm.predict_stream(np.array([[5, 9, 13]], np.int32), [], meta={"tags": {"max_new_tokens": 100}})
    assert len(next(gen)) >= 1
    gen.close()  # the consumer walks away
    deadline = time.time() + 20
    while time.time() < deadline:
        stats = lm.engine.engine_stats()
        if stats["active"] == 0 and stats["queued"] == 0:
            break
        time.sleep(0.05)
    stats = lm.engine.engine_stats()
    assert stats["active"] == 0 and stats["queued"] == 0
    assert stats["pool_pages_used"] == 0 and stats["free_pages"] == total
    assert stats["tokens"] - tokens0 < 90  # far fewer than the abandoned budget
    assert lm.predict(np.array([[1, 2]], np.int32), [], meta={"tags": {"max_new_tokens": 4}}).shape == (1, 4)


def test_concurrent_streams_and_abandons_keep_the_allocator_whole(lm):
    """Consumers on many threads, each reading a stream whole or walking
    away after its first chunk, against the decode loop: every stream
    ends, the whole ones equal their unary rows, and every slot and page
    comes back."""
    import sys

    total = lm.engine.engine_stats()["pool_pages_total"]
    prompts = _prompts()
    want = [lm.predict(p[None], [])[0].tolist() for p in prompts]
    errors = []

    def consumer(i):
        try:
            for j in range(3):
                k = (i + j) % len(prompts)
                gen = lm.predict_stream(prompts[k][None], [])
                if (i + j) % 2:
                    assert len(next(gen)) >= 1
                    gen.close()
                else:
                    assert [t for c in gen for t in c.tolist()] == want[k]
        except AssertionError as e:  # re-raised below, on the test's thread
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    threads = [threading.Thread(target=consumer, args=(i,)) for i in range(8)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    deadline = time.time() + 20
    while time.time() < deadline and lm.engine.engine_stats()["free_pages"] != total:
        time.sleep(0.05)
    stats = lm.engine.engine_stats()
    assert stats["active"] == 0 and stats["queued"] == 0 and stats["free_pages"] == total


# ---- the gateway's lanes ------------------------------------------------------

def _gateway(component):
    return Gateway([(PredictorService(UnitSpec(name="lm", type="MODEL", component=component), name="main"), 1.0)])


def _parse_sse(text: str):
    """(token chunks, end payload, error payload) of an SSE body."""
    chunks, end, error = [], None, None
    for event in text.strip().split("\n\n"):
        lines = dict(line.split(": ", 1) for line in event.split("\n") if ": " in line)
        if lines.get("event") == "end":
            end = json.loads(lines["data"])
        elif lines.get("event") == "error":
            error = json.loads(lines["data"])
        else:
            chunks.append(json.loads(lines["data"])["tokens"])
    return chunks, end, error


def _sse(app, body, headers=None):
    """POST the streaming route; -> (status, content type, text)."""
    from aiohttp.test_utils import TestClient, TestServer

    async def go():
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            resp = await client.post("/api/v0.1/generate/stream", json=body, headers=headers or {})
            return resp.status, resp.headers.get("Content-Type", ""), await resp.text()
        finally:
            await client.close()

    return asyncio.run(go())


def _body(prompt, **tags):
    out = {"data": {"ndarray": [[int(t) for t in prompt]]}, "meta": {"puid": "sse-1"}}
    if tags:
        out["meta"]["tags"] = tags
    return out


def test_rest_sse_generate_stream_end_to_end(lm):
    status, ctype, text = _sse(build_gateway_app(_gateway(lm)), _body(PROMPT, max_new_tokens=6))
    assert status == 200 and ctype.startswith("text/event-stream")
    chunks, end, error = _parse_sse(text)
    assert error is None and end == {"puid": "sse-1"} and len(chunks) >= 2
    want = lm.predict(PROMPT[None], [], meta={"tags": {"max_new_tokens": 6}})[0]
    assert [t for c in chunks for t in c] == want.tolist()


def test_rest_sse_bad_prompt_is_http_error_not_stream(lm):
    status, _, text = _sse(build_gateway_app(_gateway(lm)), {"data": {"ndarray": [[1, 2], [3, 4]]}})
    body = json.loads(text)
    assert status == 400 and body["status"]["status"] == "FAILURE" and body["status"]["info"] == MULTI_ROW


def test_rest_sse_spent_deadline_and_shed_are_http_errors(lm):
    app = build_gateway_app(_gateway(lm))
    status, _, text = _sse(app, _body(PROMPT), headers={"X-Seldon-Deadline-Ms": "0"})
    assert status == 504 and json.loads(text)["status"]["reason"] == "DEADLINE_EXCEEDED"
    # a full bounded queue sheds a newcomer of equal priority: 503, not a stream
    with _no_env("SELDON_TPU_CHUNK_IMPL", "SELDON_TPU_PAGED_KERNEL"):
        small = StreamingLM(device="cpu", dtype="float32", max_new_tokens=4, max_queue=1,
                            **CFG, **{**ENGINE, "max_slots": 1})
        small.load()
    try:
        with small.engine._step_lock:  # the decode loop waits: the queue stays as filled
            held = small.engine.submit(PROMPT, max_new_tokens=4)
            status, _, text = _sse(build_gateway_app(_gateway(small)), _body(PROMPT),
                                   headers={"X-Seldon-Priority": "0"})
        assert status == 503 and json.loads(text)["status"]["reason"] == "SHED"
        assert held.event.wait(30) and held.result.shape == (4,)
    finally:
        small.unload()


def test_rest_sse_not_implemented_for_non_generation():
    status, _, text = _sse(build_gateway_app(Gateway([(PredictorService(
        UnitSpec(name="stub", type="MODEL", implementation="SIMPLE_MODEL"), name="main"), 1.0)])), _body([1, 2]))
    body = json.loads(text)
    assert status == 501 and body["status"]["reason"] == "NOT_IMPLEMENTED"
    assert "predict_stream" in body["status"]["info"]


def test_rest_sse_needs_a_bearer_token_under_oauth(lm):
    from seldon_core_tpu_torch.utils.auth import OAuthConfig

    status, _, text = _sse(build_gateway_app(_gateway(lm), auth=OAuthConfig("k", "s")), _body(PROMPT))
    assert status == 401 and json.loads(text)["status"]["reason"] == "UNAUTHORIZED"


def _serve_grpc(component, client_work):
    """Run ``client_work(port)`` against the sync gRPC server of a gateway
    over ``component``."""
    from seldon_core_tpu_torch.engine.sync_server import build_sync_seldon_server

    async def scenario():
        server = build_sync_seldon_server(_gateway(component), asyncio.get_running_loop())
        port = server.add_insecure_port("127.0.0.1:0")
        server.start()
        try:
            return await asyncio.to_thread(client_work, port)
        finally:
            await asyncio.to_thread(server.stop(0).wait)

    return asyncio.run(scenario())


def _request(prompt, **tags):
    msg = InternalMessage(payload=np.asarray([prompt], np.int32), kind="ndarray")
    msg.meta.puid = "g-1"
    msg.meta.tags.update(tags)
    return msg.to_proto()


def _generate_stream(channel):
    return channel.unary_stream("/seldon.protos.Seldon/GenerateStream",
                                request_serializer=pb.SeldonMessage.SerializeToString,
                                response_deserializer=pb.SeldonMessage.FromString)


def _tokens(msg) -> list:
    return np.asarray(InternalMessage.from_proto(msg).host_payload()).reshape(-1).astype(int).tolist()


def test_grpc_generate_stream_end_to_end(lm):
    import grpc

    def client_work(port):
        with grpc.insecure_channel(f"127.0.0.1:{port}") as channel:
            chunks = list(_generate_stream(channel)(_request(PROMPT, max_new_tokens=6), timeout=60))
            with pytest.raises(grpc.RpcError) as err:
                list(_generate_stream(channel)(
                    InternalMessage(payload=np.ones((2, 3), np.int32), kind="ndarray").to_proto(), timeout=60))
        return chunks, err.value

    chunks, err = _serve_grpc(lm, client_work)
    want = lm.predict(PROMPT[None], [], meta={"tags": {"max_new_tokens": 6}})[0]
    assert len(chunks) >= 2 and all(m.meta.puid == "g-1" for m in chunks)
    assert [t for m in chunks for t in _tokens(m)] == want.tolist()
    assert err.code().name == "INVALID_ARGUMENT" and MULTI_ROW in err.details()


# ---- the native ingress -------------------------------------------------------

@pytest.fixture(scope="module")
def frontserver():
    from seldon_core_tpu_torch.native import frontserver as fs

    assert fs.available(), "the native library must build here"
    return fs


def _streaming_server(fs, produce):
    holder = {}

    def handler(path, body, handle):
        assert path == "/seldon.protos.Seldon/GenerateStream"
        threading.Thread(target=produce, args=(holder["srv"], body, handle), daemon=True).start()
        return 0

    holder["srv"] = fs.NativeFrontServer(stub=True, feature_dim=4, out_dim=3, grpc_stream_handler=handler)
    return holder["srv"]


def _channel(port):
    import grpc

    return grpc.insecure_channel(f"127.0.0.1:{port}")


def test_native_chunks_arrive_in_order_then_ok(frontserver):
    def produce(srv, body, handle):
        req = pb.SeldonMessage.FromString(body)
        for i in range(3):
            out = pb.SeldonMessage()
            out.data.ndarray.values.add().number_value = float(i)
            out.meta.puid = req.meta.puid
            assert srv.stream_push(handle, out.SerializeToString()) == 0
        srv.stream_close(handle, 0, "")

    with _streaming_server(frontserver, produce) as srv:
        req = pb.SeldonMessage()
        req.meta.puid = "gen-1"
        with _channel(srv.port) as ch:
            got = list(_generate_stream(ch)(req, timeout=15))
    assert [m.data.ndarray.values[0].number_value for m in got] == [0.0, 1.0, 2.0]
    assert all(m.meta.puid == "gen-1" for m in got)


def test_native_error_close_maps_to_grpc_status(frontserver):
    import grpc

    def produce(srv, body, handle):
        srv.stream_close(handle, 3, "prompt too long")

    with _streaming_server(frontserver, produce) as srv:
        with _channel(srv.port) as ch:
            with pytest.raises(grpc.RpcError) as exc:
                list(_generate_stream(ch)(pb.SeldonMessage(), timeout=15))
    assert exc.value.code() == grpc.StatusCode.INVALID_ARGUMENT and "prompt too long" in exc.value.details()


def test_native_push_after_client_cancel_reports_dead(frontserver):
    saw = queue.Queue()
    release = threading.Event()

    def produce(srv, body, handle):
        out = pb.SeldonMessage()
        out.strData = "x"
        assert srv.stream_push(handle, out.SerializeToString()) == 0
        release.wait(timeout=10)  # until the client cancelled
        for _ in range(100):
            rc = srv.stream_push(handle, out.SerializeToString())
            if rc < 0:
                break
            time.sleep(0.05)
        srv.stream_close(handle, 1, "client cancelled")  # closing a dead stream is safe
        saw.put(rc)

    with _streaming_server(frontserver, produce) as srv:
        ch = _channel(srv.port)
        it = _generate_stream(ch)(pb.SeldonMessage(), timeout=15)
        next(it)
        it.cancel()
        ch.close()
        release.set()
        assert saw.get(timeout=10) == -1


def test_native_generate_stream_through_the_gateway(frontserver, lm):
    import grpc

    from seldon_core_tpu_torch.engine.native_ingress import serve_native_ingress

    async def scenario():
        handle = await serve_native_ingress(_gateway(lm), host="127.0.0.1", http_port=0)

        def client():
            with _channel(handle.port) as ch:
                unary = ch.unary_unary("/seldon.protos.Seldon/Predict",
                                       request_serializer=pb.SeldonMessage.SerializeToString,
                                       response_deserializer=pb.SeldonMessage.FromString)(_request(PROMPT), timeout=60)
                streamed = list(_generate_stream(ch)(_request(PROMPT), timeout=60))
                with pytest.raises(grpc.RpcError) as err:
                    list(_generate_stream(ch)(
                        InternalMessage(payload=np.ones((2, 3), np.int32), kind="ndarray").to_proto(), timeout=60))
            return unary, streamed, err.value

        try:
            return await asyncio.to_thread(client)
        finally:
            await handle.stop()

    unary, streamed, err = asyncio.run(scenario())
    assert len(streamed) >= 2 and all(m.meta.puid == "g-1" for m in streamed)
    assert [t for m in streamed for t in _tokens(m)] == _tokens(unary)
    assert err.code() == grpc.StatusCode.INVALID_ARGUMENT and MULTI_ROW in err.details()
    # every stream was closed: the connection holds no stream, the engine no slot
    assert lm.engine.engine_stats()["active"] == 0
