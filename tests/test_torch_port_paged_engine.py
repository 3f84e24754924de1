"""The port's ``PagedEngine`` against the JAX package's, end to end.

Both engines run the same flax ``TransformerLM`` init in float32 with
the kernel lane forced (``SELDON_TPU_PAGED_KERNEL=force``: JAX's Pallas
kernel in interpret mode, the port's plain version), the pool chunk and
no prefix cache, on the config of ``tests/test_paged_kernel_lane.py``:
six ragged prompts across page boundaries, four slots (so two prompts
queue), ten new tokens.  Greedy tokens must be equal, exactly.

The port's own contract: eos padding, cancel, the two lanes agreeing,
``top_k=1`` equal to greedy, a seed reproducing its sample, and every
option of the JAX engine that this slice does not run raising.
"""

import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from seldon_core_tpu.models.paged import PagedEngine as JaxPagedEngine
from seldon_core_tpu.models.transformer import TransformerLM as FlaxTransformerLM
from seldon_core_tpu_torch.models.convert import lm_params_from_flax
from seldon_core_tpu_torch.models.paged import PagedEngine, StreamingLM
from seldon_core_tpu_torch.runtime.component import MicroserviceError

CFG = dict(vocab_size=64, d_model=32, num_layers=1, num_heads=2, max_len=256)
ENGINE = dict(page_size=8, max_slots=4, steps_per_call=4)
MAX_NEW = 10


def _prompts():
    rng = np.random.default_rng(5)
    return [rng.integers(0, CFG["vocab_size"], size=(n,)).astype(np.int32) for n in (14, 7, 25, 8, 17, 33)]


@pytest.fixture(scope="module")
def flax_params():
    lm = FlaxTransformerLM(dtype=jnp.float32, **CFG)
    return lm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]


@pytest.fixture(scope="module")
def params(flax_params):
    return lm_params_from_flax(flax_params)


@pytest.fixture(scope="module")
def jax_tokens(flax_params):
    import os

    env = {"SELDON_TPU_PAGED_KERNEL": "force", "SELDON_TPU_CHUNK_IMPL": "pool"}
    before = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        eng = JaxPagedEngine(flax_params, dtype=jnp.float32, prefix_cache=False, **CFG, **ENGINE)
        assert eng._kernel_active
        streams = [eng.submit(p, max_new_tokens=MAX_NEW) for p in _prompts()]
        eng.run()
        eng.close()
    finally:
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return np.stack([s.result for s in streams])


def _engine(params, monkeypatch, lane="force", **kw):
    monkeypatch.setenv("SELDON_TPU_PAGED_KERNEL", lane)
    return PagedEngine(params, dtype="float32", device="cpu", **CFG, **{**ENGINE, **kw})


def _decode(eng, prompts, **kw):
    streams = [eng.submit(p, **{"max_new_tokens": MAX_NEW, **kw}) for p in prompts]
    eng.run()
    return np.stack([s.result for s in streams])


@pytest.fixture(scope="module")
def port_tokens(params):
    mp = pytest.MonkeyPatch()
    try:
        eng = _engine(params, mp)
        assert eng._kernel_active
        return _decode(eng, _prompts())
    finally:
        mp.undo()


def test_greedy_tokens_equal_the_jax_engine(jax_tokens, port_tokens):
    assert port_tokens.shape == (6, MAX_NEW)
    np.testing.assert_array_equal(port_tokens, jax_tokens)


def test_kernel_and_gather_lanes_give_the_same_tokens(params, port_tokens, monkeypatch):
    eng = _engine(params, monkeypatch, lane="0")
    assert not eng._kernel_active
    np.testing.assert_array_equal(_decode(eng, _prompts()), port_tokens)


def test_eos_cuts_and_pads(params, port_tokens, monkeypatch):
    row = port_tokens[0]
    eos = int(row[3])
    cut = list(row).index(eos) + 1
    eng = _engine(params, monkeypatch)
    got = _decode(eng, _prompts()[:1], eos_id=eos)[0]
    np.testing.assert_array_equal(got[:cut], row[:cut])
    assert (got[cut:] == eos).all()
    assert eng.engine_stats()["tokens"] < MAX_NEW or cut == MAX_NEW


def test_cancel_queued_and_running(params, monkeypatch):
    eng = _engine(params, monkeypatch, max_slots=1)
    full = eng.engine_stats()["free_pages"]
    running, queued = (eng.submit(p, max_new_tokens=MAX_NEW, eos_id=-1) for p in _prompts()[:2])
    eng.step()  # admits the first, one chunk
    assert eng.engine_stats()["active"] == 1 and eng.engine_stats()["queued"] == 1
    eng.cancel(queued)
    assert queued.event.is_set() and (queued.result == -1).all()
    eng.cancel(running)
    assert running.result is None  # flagged; retired at the next step, never mid-chunk
    eng.step()
    assert running.event.is_set() and running.result.shape == (MAX_NEW,)
    got = ENGINE["steps_per_call"]
    assert (running.result[got:] == -1).all() and (running.result[:got] >= 0).all()
    assert eng.engine_stats()["free_pages"] == full and not eng.has_work()


def test_top_k_one_is_greedy_and_a_seed_reproduces_its_sample(params, port_tokens, monkeypatch):
    eng = _engine(params, monkeypatch)
    prompts = _prompts()[:3]
    np.testing.assert_array_equal(_decode(eng, prompts, temperature=0.7, top_k=1, seed=11), port_tokens[:3])
    a = _decode(eng, prompts, temperature=1.0, seed=7)
    b = _decode(eng, prompts[::-1], temperature=1.0, seed=7)[::-1]  # other co-scheduling, other slots
    c = _decode(eng, prompts, temperature=1.0, seed=8)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert ((a >= 0) & (a < CFG["vocab_size"])).all()


def test_admission_reserves_pages_and_queues(params, monkeypatch):
    # 5 usable pages: a 25-token prompt + 10 new needs all 5, so the next
    # prompt waits for its pages instead of stalling mid-decode
    eng = _engine(params, monkeypatch, num_pages=6)
    first, second = (eng.submit(p, max_new_tokens=MAX_NEW) for p in (_prompts()[2], _prompts()[0]))
    eng.step()
    assert eng.engine_stats()["active"] == 1 and eng.engine_stats()["queued"] == 1
    eng.run()
    assert first.result.shape == second.result.shape == (MAX_NEW,)
    with pytest.raises(MicroserviceError, match="pages but the pool holds") as err:
        eng.submit(np.zeros(40, np.int32), max_new_tokens=10)
    assert err.value.reason == "SEQUENCE_TOO_LONG"


def test_concurrent_submit_and_cancel_keep_the_allocator_whole(params, monkeypatch):
    """Submitters and cancellers on many threads against one stepping
    thread: every stream resolves, and every page returns to the pool."""
    eng = _engine(params, monkeypatch, lane="0", max_slots=2)
    full = eng.engine_stats()["free_pages"]
    stop = threading.Event()

    def loop():
        while not stop.is_set():
            if not eng.step():
                time.sleep(0.001)

    errors = []

    def client(i):
        try:
            for j in range(3):
                stream = eng.submit(_prompts()[(i + j) % 6], max_new_tokens=3)
                if (i + j) % 3 == 0:
                    eng.cancel(stream)
                assert stream.event.wait(timeout=60), "a stream never resolved"
                assert stream.result.shape == (3,) and stream.error is None
        except AssertionError as e:  # re-raised below, on the test's thread
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    stepper = threading.Thread(target=loop)
    clients = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    try:
        stepper.start()
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in clients)
    finally:
        stop.set()
        stepper.join(timeout=60)
        sys.setswitchinterval(interval)
    assert not stepper.is_alive() and not errors, errors
    assert eng.engine_stats()["free_pages"] == full and not eng.has_work()


@pytest.mark.parametrize("lane,expect", [("auto", False), ("1", False), ("force", True), ("0", False)])
def test_lane_resolution_on_the_cpu(params, monkeypatch, lane, expect):
    monkeypatch.setenv("SELDON_TPU_PAGED_KERNEL", lane)
    eng = PagedEngine(params, dtype="float32", device="cpu", **CFG, **ENGINE)
    assert eng._kernel_active is expect and eng.engine_stats()["kernel_active"] == int(expect)


UNPORTED = [
    ("prefix_cache", dict(prefix_cache=True)),
    ("chunk_token_budget", dict(chunk_token_budget=64)),
    ("max_steps_per_call", dict(max_steps_per_call=16)),
    ("speculative", dict(speculative={"draft": "ngram", "draft_k": 2})),
    ("max_adapters", dict(max_adapters=2)),
    ("quantize", dict(quantize="int8")),
    ("precision", dict(precision="w8a8")),
    ("tp/dp/mesh", dict(tp=2)),
    ("tp/dp/mesh", dict(dp=2)),
    ("max_queue", dict(max_queue=4)),
]


@pytest.mark.parametrize("option,kw", UNPORTED, ids=[f"{o}-{next(iter(k))}" for o, k in UNPORTED])
def test_unported_options_raise_naming_the_slice(params, option, kw):
    with pytest.raises(MicroserviceError, match="ROADMAP.md") as err:
        PagedEngine(params, dtype="float32", device="cpu", **CFG, **{**ENGINE, **kw})
    assert option in str(err.value) and err.value.reason == "BAD_PARAMETER"
    with pytest.raises(MicroserviceError, match=option):
        StreamingLM(device="cpu", **CFG, **kw)


@pytest.mark.parametrize("env,value", [("SELDON_TPU_KV_DTYPE", "int8"), ("SELDON_TPU_CHUNK_IMPL", "ring"),
                                       ("SELDON_TPU_PREFIX_CACHE", "1")])
def test_unported_knobs_raise(params, monkeypatch, env, value):
    monkeypatch.setenv(env, value)
    with pytest.raises(MicroserviceError, match="ROADMAP.md"):
        PagedEngine(params, dtype="float32", device="cpu", **CFG, **ENGINE)


def test_unknown_knob_values_raise_as_in_jax(params, monkeypatch):
    monkeypatch.setenv("SELDON_TPU_KV_DTYPE", "fp4")
    with pytest.raises(ValueError, match="SELDON_TPU_KV_DTYPE"):
        PagedEngine(params, dtype="float32", device="cpu", **CFG, **ENGINE)


def test_component_refusals():
    lm = StreamingLM(device="cpu", **CFG)
    for call in (lambda: lm.predict_stream(np.zeros((1, 4))), lambda: lm.drain()):
        with pytest.raises(MicroserviceError, match="ROADMAP.md"):
            call()
    with pytest.raises(MicroserviceError, match="adapters"):
        StreamingLM(device="cpu", adapters={"a": {"seed": 1}}, **CFG)
    with pytest.raises(MicroserviceError, match="model_uri") as err:
        StreamingLM(device="cpu", model_uri="file:///x.msgpack", **CFG).load()
    assert "item 5" in str(err.value)
