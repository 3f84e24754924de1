"""The port's ``PagedEngine`` against the JAX package's, end to end.

Both engines run the same flax ``TransformerLM`` init in float32 with
the kernel lane forced (``SELDON_TPU_PAGED_KERNEL=force``: JAX's Pallas
kernel in interpret mode, the port's plain version), the pool chunk and
no prefix cache, on the config of ``tests/test_paged_kernel_lane.py``:
six ragged prompts across page boundaries, four slots (so two prompts
queue), ten new tokens.  Greedy tokens must be equal, exactly.

The port's own contract: eos padding, cancel, the two lanes of the pool
chunk agreeing, ``top_k=1`` equal to greedy, a seed reproducing its
sample, admission with the prompt's pages and growth a chunk at a time,
every option of the JAX engine that the port does not run yet raising,
and an unknown knob value raising.
"""

import logging
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.models.paged import PagedEngine as JaxPagedEngine
from seldon_core_tpu.models.transformer import TransformerLM as FlaxTransformerLM
from seldon_core_tpu_torch.models.convert import lm_params_from_flax
from seldon_core_tpu_torch.models.paged import PagedEngine, StreamingLM
from seldon_core_tpu_torch.parallel import create_mesh
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
    # the pool chunk on either lane: with the kernel off the engine would
    # pick the ring chunk (tests/test_torch_port_ring_chunk.py)
    monkeypatch.setenv("SELDON_TPU_PAGED_KERNEL", lane)
    monkeypatch.setenv("SELDON_TPU_CHUNK_IMPL", "pool")
    return PagedEngine(params, dtype="float32", device="cpu", **CFG, **{**ENGINE, "prefix_cache": False, **kw})


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


def test_admission_takes_the_prompt_pages_and_grows_per_chunk(params, port_tokens, monkeypatch):
    # as the JAX engine admits: the prompt's pages at admission (14 and 17
    # tokens fill the 5 usable pages of 8), then each chunk's pages as it
    # comes, stalling and evicting when the pool runs dry; the tokens are
    # those of the full pool
    eng = _engine(params, monkeypatch, num_pages=6)
    first, second = (eng.submit(_prompts()[i], max_new_tokens=MAX_NEW) for i in (0, 4))
    with eng._lock:
        admitted = eng._admit_locked()
    assert [s for s, _ in admitted] == [first, second]
    assert len(first.pages) == 2 and len(second.pages) == 3
    eng._prefill_streams([first, second])
    eng.run()
    np.testing.assert_array_equal(np.stack([first.result, second.result]), port_tokens[[0, 4]])
    assert eng.engine_stats()["stalls"] > 0
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


MESH_OPTIONS = [
    ("tp/dp/mesh", dict(tp=2)),
    ("tp/dp/mesh", dict(dp=2)),
]


@pytest.mark.parametrize("option,kw", MESH_OPTIONS, ids=[f"{o}-{next(iter(k))}" for o, k in MESH_OPTIONS])
def test_tp_dp_degrade_without_cards_and_run_sharded_on_cpu_positions(params, jax_tokens, option, kw, caplog,
                                                                     monkeypatch):
    """tp / dp once raised naming the later slice; they landed (ROADMAP
    A12).  The degree counts distinct CUDA devices, so on a host without
    enough of them ``tp=2`` / ``dp=2`` degrade to one device with the JAX
    package's WARN and the engine reports degree 1; the same degree over
    an explicit mesh of two CPU positions runs sharded.  Both decode the
    JAX engine's greedy tokens."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with caplog.at_level(logging.WARNING, logger="seldon_core_tpu_torch.parallel.mesh"):
        eng = PagedEngine(params, dtype="float32", device="cpu", prefix_cache=False, **CFG, **{**ENGINE, **kw})
    assert "degrading to single-chip" in caplog.text
    assert (eng.tp_degree, eng.dp_degree) == (1, 1) and eng.engine_stats()["tp_degree"] == 1
    np.testing.assert_array_equal(_decode(eng, _prompts()), jax_tokens)
    axis = "model" if "tp" in kw else "data"
    sharded = PagedEngine(params, dtype="float32", mesh=create_mesh({axis: 2}, devices=["cpu"] * 2),
                          prefix_cache=False, shard_min_weight_size=0, **CFG, **ENGINE)
    assert sharded.engine_stats()["tp_degree" if axis == "model" else "dp_degree"] == 2
    np.testing.assert_array_equal(_decode(sharded, _prompts()), jax_tokens)
    StreamingLM(device="cpu", **CFG, **kw)  # the component takes the option as it is


def test_speculative_engine_on_a_2x2_mesh_decodes_greedy(params, monkeypatch):
    """A speculative engine once refused tp naming A12; it landed.  Over a
    {"data": 2, "model": 2} mesh of CPU positions the verify rounds run
    on the gather lane and decode the one-device speculative engine's
    greedy tokens, which are plain greedy decoding's."""
    spec = dict(speculative={"draft": "ngram", "draft_k": 2})
    one = PagedEngine(params, dtype="float32", device="cpu", prefix_cache=False, **CFG, **{**ENGINE, **spec})
    mesh = create_mesh({"data": 2, "model": 2}, devices=["cpu"] * 4)
    sharded = PagedEngine(params, dtype="float32", mesh=mesh, prefix_cache=False, shard_min_weight_size=0,
                          **CFG, **{**ENGINE, **spec})
    assert (sharded.tp_degree, sharded.dp_degree) == (2, 2) and not sharded._kernel_active
    prompts = _prompts()[:3]
    np.testing.assert_array_equal(_decode(sharded, prompts), _decode(one, prompts))
    assert sharded.engine_stats()["spec_drafted"] > 0
    StreamingLM(device="cpu", mesh_axes={"model": 2}, **CFG, **spec)


@pytest.mark.parametrize("env,value", [("SELDON_TPU_CHUNK_IMPL", "lanes")])
def test_unported_knobs_raise(params, monkeypatch, env, value):
    # the ring chunk landed; a value that is neither chunk raises naming
    # the knob (the JAX engine would run the ring body for it)
    monkeypatch.setenv(env, value)
    with pytest.raises(ValueError, match=env):
        PagedEngine(params, dtype="float32", device="cpu", **CFG, **ENGINE)
    with pytest.raises(ValueError, match=env):
        StreamingLM(device="cpu", **CFG).load()  # the component refuses as it builds its engine


def test_unknown_knob_values_raise_as_in_jax(params, monkeypatch):
    monkeypatch.setenv("SELDON_TPU_KV_DTYPE", "fp4")
    with pytest.raises(ValueError, match="SELDON_TPU_KV_DTYPE"):
        PagedEngine(params, dtype="float32", device="cpu", **CFG, **ENGINE)


def test_component_refusals(flax_params, params, tmp_path):
    # drain landed (ROADMAP A8.10): a never-loaded component has nothing to
    # journal and returns [], as the JAX component does
    lm = StreamingLM(device="cpu", **CFG)
    assert lm.drain() == []
    # model_uri and {"uri": ...} adapters landed (ROADMAP A5): a flax
    # msgpack checkpoint is served, its weights exactly the converted tree's
    from flax import serialization

    path = tmp_path / "lm.msgpack"
    path.write_bytes(serialization.to_bytes(flax_params))
    StreamingLM(device="cpu", adapters={"a": {"uri": "file:///a.msgpack"}}, **CFG)
    served = StreamingLM(device="cpu", dtype="float32", model_uri=f"file://{path}", **CFG, **ENGINE)
    served.load()
    try:
        got = served.engine.module.state_dict()
        for k, v in params.items():
            np.testing.assert_array_equal(got[k].numpy(), v.numpy())
    finally:
        served.unload()
