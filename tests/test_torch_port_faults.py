"""The port's fault injector and its points against the JAX package's.

* ``utils/faults.py``: the same points, a spec parses to the same
  points with the same budgets, the same malformed specs raise, and
  ``fire`` / ``delay_s`` / ``fire_k`` / ``corrupt_bytes`` / ``stats``
  spend their budgets alike.
* ``paged.nan`` on the port's ``PagedEngine`` and the JAX engine (float32,
  one flax init): one injection retires the same stream with 500
  ``NUMERIC_POISON`` in both, and the other streams' tokens equal the JAX
  engine's (which equal an uninjected run's).  With
  ``SELDON_TPU_NAN_GUARD=0`` nothing is screened.
* ``paged.chunk``: only the faulted chunk's streams fail (503
  ``ENGINE_CHUNK_FAULT``), the queued ones serve on and the allocator
  audit stays clean; ``paged.alloc:times=3`` stalls growth and leaves
  the tokens equal.
* ``transport.drop`` / ``transport.delay`` on the port's REST client (the
  gRPC client's attempts pass the same hook): a dropped attempt is
  retried as a transient failure;
  ``transport.corrupt`` at ``StreamingLM``'s migration ingress is 400
  ``BAD_MIGRATION_PAYLOAD`` naming the CRC32C, with nothing imported.
"""

import asyncio
import contextlib
import os
import random
import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from seldon_core_tpu.models import paged as jax_paged
from seldon_core_tpu.models.transformer import TransformerLM as FlaxTransformerLM
from seldon_core_tpu.utils import faults as jax_faults
from seldon_core_tpu_torch.codec.bufview import pack_kv_migration
from seldon_core_tpu_torch.models.convert import lm_params_from_flax
from seldon_core_tpu_torch.models.paged import PagedEngine, StreamingLM
from seldon_core_tpu_torch.runtime.component import MicroserviceError
from seldon_core_tpu_torch.utils import faults

CFG = dict(vocab_size=64, d_model=32, num_layers=2, num_heads=2, max_len=128)
ENGINE = dict(page_size=8, max_slots=4, steps_per_call=4)
NEW = 12


@contextlib.contextmanager
def _env(**kv):
    before = {k: os.environ.get(k) for k in kv}
    for k, v in kv.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.fixture(autouse=True)
def _disarmed():
    faults.clear()
    jax_faults.clear()
    yield
    faults.clear()
    jax_faults.clear()


def _prompts(n=4, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG["vocab_size"], size=(9 + 3 * i,)).astype(np.int32) for i in range(n)]


# ---------------------------------------------------------------------------
# the injector
# ---------------------------------------------------------------------------

def _parsed(mod, spec):
    return {p: (f.times, f.prob, f.delay_ms, f.k) for p, f in mod._parse(spec).items()}


@pytest.mark.parametrize("spec", [
    "paged.alloc:times=3",
    "transport.drop:times=2;transport.delay:ms=50",
    "paged.chunk:prob=0.1,times=5",
    "paged.nan",
    "transport.corrupt:k=4,times=inf;transport.slow:ms=375,prob=0.25",
    " ; paged.alloc ; ",
])
def test_spec_parses_to_the_jax_points(spec):
    assert faults.KNOWN_POINTS == jax_faults.KNOWN_POINTS
    assert _parsed(faults, spec) == _parsed(jax_faults, spec)


@pytest.mark.parametrize("spec", [
    "paged.nope", "paged.alloc;paged.alloc", "paged.alloc:times", "paged.alloc:times=x",
    "paged.alloc:prob=2", "paged.alloc:ms=-1", "paged.alloc:k=0", "paged.alloc:times=-1", "paged.alloc:zz=1",
])
def test_malformed_specs_raise_as_in_jax(spec):
    with pytest.raises(ValueError) as mine:
        faults._parse(spec)
    with pytest.raises(ValueError) as theirs:
        jax_faults._parse(spec)
    assert str(mine.value) == str(theirs.value)


def test_budgets_are_spent_alike():
    for mod in (faults, jax_faults):
        mod.configure("paged.alloc:times=2;transport.delay:ms=40,times=1;transport.corrupt:k=3")
    for mod in (faults, jax_faults):
        assert [mod.fire("paged.alloc") for _ in range(3)] == [True, True, False]
        assert [mod.delay_s("transport.delay") for _ in range(2)] == [0.04, 0.0]
    blob = bytes(range(64))
    random.seed(11)
    mine = faults.corrupt_bytes("transport.corrupt", blob)
    random.seed(11)
    theirs = jax_faults.corrupt_bytes("transport.corrupt", blob)
    assert mine == theirs and mine != blob and sum(a != b for a, b in zip(mine, blob)) <= 3
    assert faults.corrupt_bytes("transport.corrupt", blob) == blob  # spent
    faults.configure("0")
    assert not faults.enabled() and not faults.fire("paged.alloc")


# ---------------------------------------------------------------------------
# the engine's points
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def flax_params():
    return FlaxTransformerLM(dtype=jnp.float32, **CFG).init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]


@pytest.fixture(scope="module")
def params(flax_params):
    return lm_params_from_flax(flax_params)


def _run(eng, prompts, new=NEW):
    streams = [eng.submit(p, max_new_tokens=new, seed=i) for i, p in enumerate(prompts)]
    eng.run()
    return streams


@pytest.fixture(scope="module")
def nan_runs(params, flax_params):
    out = {}
    port = PagedEngine(params, dtype="float32", device="cpu", **CFG, **ENGINE)
    out["port_plain"] = [s.result for s in _run(port, _prompts())]
    faults.configure("paged.nan:times=1")
    out["port"] = (_run(port, _prompts()), port.engine_stats())
    faults.clear()
    jax_eng = jax_paged.PagedEngine(flax_params, dtype=jnp.float32, **CFG, **ENGINE)
    jax_faults.configure("paged.nan:times=1")
    out["jax"] = (_run(jax_eng, _prompts()), jax_eng.engine_stats())
    jax_faults.clear()
    return out


def test_paged_nan_retires_the_stream_the_jax_engine_retires(nan_runs):
    (mine, mstats), (theirs, jstats) = nan_runs["port"], nan_runs["jax"]
    hit = [i for i, s in enumerate(mine) if s.error is not None]
    assert hit == [i for i, s in enumerate(theirs) if s.error is not None] and len(hit) == 1
    assert mine[hit[0]].error.reason == theirs[hit[0]].error.reason == "NUMERIC_POISON"
    assert mine[hit[0]].error.status_code == 500
    assert mstats["quarantined"] == jstats["quarantined"] == 1
    for i, (m, t) in enumerate(zip(mine, theirs)):
        if i not in hit:
            np.testing.assert_array_equal(m.result, t.result)
            np.testing.assert_array_equal(m.result, nan_runs["port_plain"][i])


def test_nan_guard_off_screens_nothing(params):
    with _env(SELDON_TPU_NAN_GUARD="0"):
        eng = PagedEngine(params, dtype="float32", device="cpu", **CFG, **ENGINE)
    faults.configure("paged.nan:times=1")
    streams = _run(eng, _prompts())
    assert faults.stats()["paged.nan"] >= 1
    assert all(s.error is None for s in streams) and eng.engine_stats()["quarantined"] == 0


def test_paged_chunk_fails_only_that_chunks_streams(params):
    with _env(SELDON_TPU_PAGED_DEBUG="1"):
        eng = PagedEngine(params, dtype="float32", device="cpu", **CFG, **ENGINE)
        ref = PagedEngine(params, dtype="float32", device="cpu", **CFG, **ENGINE)
    prompts = _prompts(6)
    want = [s.result for s in _run(ref, prompts)]
    faults.configure("paged.chunk:times=1")
    streams = _run(eng, prompts)
    failed = [i for i, s in enumerate(streams) if s.error is not None]
    assert failed == [0, 1, 2, 3]  # the four slots of the first chunk; the two queued serve on
    assert {streams[i].error.reason for i in failed} == {"ENGINE_CHUNK_FAULT"}
    for i in (4, 5):
        np.testing.assert_array_equal(streams[i].result, want[i])
    stats = eng.engine_stats(detail=True)
    assert stats["chunk_faults"] == 1 and stats["pool_pages_used"] == 0 and stats["watchdog"]["faults"] == 1
    assert [s.result for s in _run(eng, prompts[:2])][0].tolist() == want[0].tolist()  # it serves on


def test_paged_alloc_stalls_and_keeps_the_tokens(params, flax_params):
    eng = PagedEngine(params, dtype="float32", device="cpu", **CFG, **ENGINE)
    ref = PagedEngine(params, dtype="float32", device="cpu", **CFG, **ENGINE)
    prompts = _prompts()
    want = [s.result for s in _run(ref, prompts, new=24)]
    streams = [eng.submit(p, max_new_tokens=24, seed=i) for i, p in enumerate(prompts)]
    eng.step()  # admitted and decoding: the armed point hits growth
    faults.configure("paged.alloc:times=3")
    eng.run()
    assert faults.stats()["paged.alloc"] >= 3 and eng.engine_stats()["stalls"] >= 3
    for s, w in zip(streams, want):
        np.testing.assert_array_equal(s.result, w)


# ---------------------------------------------------------------------------
# the transport's points
# ---------------------------------------------------------------------------

def _rest_echo_server():
    from aiohttp import web

    async def predict(request):
        body = await request.json()
        return web.json_response(body)

    app = web.Application()
    app.router.add_post("/predict", predict)
    return app


def test_transport_drop_and_delay_on_the_rest_client():
    from aiohttp import web

    from seldon_core_tpu_torch.engine.graph import Endpoint, UnitSpec
    from seldon_core_tpu_torch.engine.transport import CircuitBreaker, RestClient
    from seldon_core_tpu_torch.runtime.message import InternalMessage

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]

    async def main():
        runner = web.AppRunner(_rest_echo_server())
        await runner.setup()
        await web.TCPSite(runner, "127.0.0.1", port).start()
        client = RestClient(UnitSpec(name="echo", type="MODEL",
                                     endpoint=Endpoint(host="127.0.0.1", port=port, transport="REST")), retries=3)
        try:
            faults.configure("transport.drop:times=1;transport.delay:ms=30,times=1")
            t0 = asyncio.get_running_loop().time()
            out = await client.transform_input(InternalMessage.from_json({"data": {"ndarray": [[1.0, 2.0]]}}))
            elapsed = asyncio.get_running_loop().time() - t0
        finally:
            await client.close()
            await runner.cleanup()
        return out, elapsed

    try:
        out, elapsed = asyncio.run(main())
    finally:
        CircuitBreaker.reset_all()
    assert np.asarray(out.host_payload()).tolist() == [[1.0, 2.0]]
    assert faults.stats()["transport.drop"] >= 1 and faults.stats()["transport.delay"] >= 1
    assert elapsed >= 0.03


def test_transport_corrupt_at_the_migration_ingress(params, tmp_path):
    src = PagedEngine(params, dtype="float32", device="cpu", **CFG, **ENGINE)
    src.submit(_prompts(1)[0], max_new_tokens=NEW, seed=0)
    src.step()
    (payload, _stream), = src.migrate_export()
    blob = pack_kv_migration(payload)
    lm = StreamingLM(device="cpu", dtype="float32", seed=0, **CFG, **ENGINE)
    lm.load()
    try:
        before = lm.engine.engine_stats()
        faults.configure("transport.corrupt:times=1")
        with pytest.raises(MicroserviceError) as err:
            lm.predict(np.frombuffer(blob, np.uint8)[None, :], [], meta={"tags": {"kv_migration": 1}})
        assert err.value.reason == "BAD_MIGRATION_PAYLOAD" and "CRC32C" in str(err.value)
        after = lm.engine.engine_stats()
        assert after["migrated_in"] == before["migrated_in"] and after["pool_pages_used"] == 0
        # the same container, unflipped, is taken (imported at the loop's next admission)
        lm.predict(np.frombuffer(blob, np.uint8)[None, :], [], meta={"tags": {"kv_migration": 1}})
        deadline = time.monotonic() + 30
        while lm.engine.engine_stats()["migrated_in"] == before["migrated_in"] and time.monotonic() < deadline:
            time.sleep(0.05)
        assert lm.engine.engine_stats()["migrated_in"] == before["migrated_in"] + 1
    finally:
        lm.unload()
