"""The length-bucketed split of a decode chunk against the JAX engine's.

``SELDON_TPU_CTX_BUCKETS=2`` (the default) sorts a chunk's lanes into two
halves: the shorter half of the running lanes attends at its own table
width (the ring chunk: its gathered context; the pool chunk: its per-step
tables, one kernel call per bucket on the kernel lane).  The port
versions of ``tests/test_paged_buckets.py``'s engine cases, on the same
float32 weights and submission order as the JAX engine: bimodal traffic
gives JAX's tokens and ``bucketed_chunks`` on both chunks, with ``1`` and
``2``; uniform traffic degenerates to one bucket; partial occupancy
splits the live lanes, not the idle ones; a lane's output does not depend
on its co-batch's bucket; a bad value raises.  Around them: one kernel
call a layer-step a bucket on the kernel lane, sampled streams drawing
the same tokens under either split, and the ``paged_bucketed_chunks``
gauge.

The default follows the engine's device (``ROADMAP.md`` C19): unset, one
bucket on a CUDA device and two elsewhere; an explicit value wins on
either.  The parity cases above set the knob, so they hold the JAX
engine's default wherever they run.
"""

import contextlib
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.models import paged as jax_paged
from seldon_core_tpu.models.transformer import TransformerLM as FlaxTransformerLM
from seldon_core_tpu_torch.models import paged
from seldon_core_tpu_torch.models.convert import lm_params_from_flax
from seldon_core_tpu_torch.models.paged import PagedEngine, StreamingLM, paged_ctx_buckets
from seldon_core_tpu_torch.ops import kernels

CFG = dict(vocab_size=64, d_model=32, num_layers=2, num_heads=4, max_len=128)
ENGINE = dict(page_size=8, steps_per_call=4, prefix_cache=False)
MAX_NEW = 10
# the port's lanes -> (SELDON_TPU_CHUNK_IMPL, SELDON_TPU_PAGED_KERNEL) and
# the JAX chunk each is held against
LANES = {"ring": ("ring", "0"), "pool-kernel": ("pool", "force"), "pool-gather": ("pool", "0")}
JAX_LANE = {"ring": "ring", "pool-kernel": "pool", "pool-gather": "pool"}


@contextlib.contextmanager
def _env(**kv):
    before = {k: os.environ.get(k) for k in kv}
    os.environ.update(kv)
    try:
        yield
    finally:
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _bimodal_prompts(short, long, n, vocab=64):
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, size=(short if i % 2 == 0 else long,)).astype(np.int32) for i in range(n)]


def _uniform_prompts(n=4):
    rng = np.random.default_rng(3)
    return [rng.integers(0, CFG["vocab_size"], size=(9,)).astype(np.int32) for _ in range(n)]


def _port(params, lane, buckets, n_slots=4, **kw):
    impl, kernel = LANES[lane]
    with _env(SELDON_TPU_CHUNK_IMPL=impl, SELDON_TPU_PAGED_KERNEL=kernel, SELDON_TPU_CTX_BUCKETS=buckets):
        return PagedEngine(params, dtype="float32", device="cpu", max_slots=n_slots, **CFG, **{**ENGINE, **kw})


def _serve(eng, prompts, max_new=MAX_NEW, **kw):
    streams = [eng.submit(p, max_new_tokens=max_new, **kw) for p in prompts]
    eng.run()
    return np.stack([s.result for s in streams])


@pytest.fixture(scope="module")
def flax_params():
    lm = FlaxTransformerLM(dtype=jnp.float32, **CFG)
    return lm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]


@pytest.fixture(scope="module")
def params(flax_params):
    return lm_params_from_flax(flax_params)


@pytest.fixture(scope="module")
def jax_bimodal(flax_params):
    """JAX's tokens and bucketed_chunks on the bimodal batch, per chunk
    and bucket count (the kernel lane off: its gather lane)."""
    out = {}
    for impl in ("ring", "pool"):
        for buckets in ("1", "2"):
            with _env(SELDON_TPU_CHUNK_IMPL=impl, SELDON_TPU_PAGED_KERNEL="0", SELDON_TPU_CTX_BUCKETS=buckets):
                eng = jax_paged.PagedEngine(flax_params, dtype=jnp.float32, max_slots=4, **CFG, **ENGINE)
                assert eng._chunk_impl == impl
                toks = _serve(eng, _bimodal_prompts(4, 40, 4))
                out[impl, buckets] = (toks, eng.engine_stats()["bucketed_chunks"])
                eng.close()
    return out


@pytest.mark.parametrize("buckets", ["1", "2"])
@pytest.mark.parametrize("lane", list(LANES))
def test_bimodal_tokens_and_bucketed_chunks_equal_jax(params, jax_bimodal, lane, buckets):
    eng = _port(params, lane, buckets)
    assert eng._chunk_impl == JAX_LANE[lane] and eng._ctx_buckets == int(buckets)
    toks = _serve(eng, _bimodal_prompts(4, 40, 4))
    want_toks, want_bucketed = jax_bimodal[JAX_LANE[lane], buckets]
    np.testing.assert_array_equal(toks, want_toks)
    assert eng.engine_stats()["bucketed_chunks"] == want_bucketed
    assert (want_bucketed > 0) == (buckets == "2")


def test_bimodal_parity_across_chunks_and_bucket_counts(jax_bimodal):
    ref = jax_bimodal["ring", "1"][0]
    for key, (toks, _) in jax_bimodal.items():
        np.testing.assert_array_equal(toks, ref, err_msg=str(key))


@pytest.mark.parametrize("lane", ["ring", "pool-kernel"])
def test_uniform_traffic_degenerates_to_one_bucket(params, lane):
    eng2, eng1 = _port(params, lane, "2"), _port(params, lane, "1")
    bi2, bi1 = _serve(eng2, _bimodal_prompts(4, 40, 4)), _serve(eng1, _bimodal_prompts(4, 40, 4))
    np.testing.assert_array_equal(bi2, bi1)
    marker = eng2.engine_stats()["bucketed_chunks"]
    assert marker > 0 and eng1.engine_stats()["bucketed_chunks"] == 0
    un2, un1 = _serve(eng2, _uniform_prompts()), _serve(eng1, _uniform_prompts())
    assert eng2.engine_stats()["bucketed_chunks"] == marker  # equal widths: one bucket
    np.testing.assert_array_equal(un2, un1)


@pytest.mark.parametrize("lane,short_pages", [("ring", 1), ("pool-kernel", 2)])
def test_partial_occupancy_splits_live_lanes_not_idle(params, lane, short_pages):
    """With most slots idle, the live streams split at their own midpoint:
    idle lanes fill, they never push a short live stream into the long
    bucket (JAX ``tests/test_paged_buckets.py:120-150``)."""
    eng = _port(params, lane, "2", n_slots=16)
    live = {1: 6, 5: 7, 9: 60, 13: 58}
    for slot, length in live.items():
        eng._lengths[slot] = length
    buckets, perm = eng._plan_buckets([SimpleNamespace(slot=s) for s in live], steps=4, pages_h=16)
    assert len(buckets) == 2
    (b0, h0), (b1, h1) = buckets
    assert b0 + b1 == 16 and h0 < h1
    short_bucket = set(perm[:b0].tolist())
    assert {1, 5} <= short_bucket and not ({9, 13} & short_bucket)
    # the short bucket covers the short lanes only: 7 tokens at pages of 8
    # (the pool chunk adds this chunk's 4 steps of growth)
    assert h0 == short_pages
    assert sorted(perm.tolist()) == list(range(16))
    # fewer than two running lanes: one bucket, the identity
    one, ident = eng._plan_buckets([SimpleNamespace(slot=9)], steps=4, pages_h=16)
    assert len(one) == 1 and ident.tolist() == list(range(16))


@pytest.mark.parametrize("lane", ["ring", "pool-kernel"])
def test_lane_output_independent_of_co_batch_bucket(params, lane):
    short = np.arange(6, dtype=np.int32) % 64
    eng = _port(params, lane, "2", n_slots=2)
    alone = _serve(eng, [short, short + 1], max_new=12)
    assert eng.engine_stats()["bucketed_chunks"] == 0
    longp = (np.arange(40, dtype=np.int32) * 5) % 64
    mixed = _serve(eng, [short, longp], max_new=12)
    assert eng.engine_stats()["bucketed_chunks"] > 0
    np.testing.assert_array_equal(alone[0], mixed[0])


@pytest.mark.parametrize("value", ["3", "0", "two"])
def test_invalid_buckets_env_rejected(params, monkeypatch, value):
    monkeypatch.setenv("SELDON_TPU_CTX_BUCKETS", value)
    with pytest.raises(ValueError, match="SELDON_TPU_CTX_BUCKETS"):
        PagedEngine(params, dtype="float32", device="cpu", max_slots=2, **CFG, **ENGINE)
    with pytest.raises(ValueError, match="SELDON_TPU_CTX_BUCKETS"):
        StreamingLM(device="cpu", **CFG).load()  # the component refuses as it builds its engine


def test_the_kernel_lane_calls_the_kernel_once_a_bucket(params, monkeypatch):
    calls = []
    real = kernels.paged_attention_decode
    monkeypatch.setattr(kernels, "paged_attention_decode",
                        lambda q, *a, **k: calls.append(q.shape[0]) or real(q, *a, **k))
    eng = _port(params, "pool-kernel", "2")
    _serve(eng, _bimodal_prompts(4, 40, 4))
    s = eng.engine_stats()
    steps = sum(k * v for k, v in s["chunk_steps"].items())
    # every chunk of this batch splits: one call a bucket of two lanes
    assert s["bucketed_chunks"] == s["chunks"] > 0 and s["bucketed_steps"] == steps
    assert len(calls) == CFG["num_layers"] * (steps + s["bucketed_steps"])
    assert set(calls) == {2}


@pytest.mark.parametrize("lane", ["ring", "pool-kernel"])
def test_sampled_streams_draw_the_same_tokens_under_either_split(params, lane):
    prompts = _bimodal_prompts(4, 40, 4)
    runs = [_serve(_port(params, lane, b), prompts, temperature=1.0, seed=17) for b in ("1", "2")]
    np.testing.assert_array_equal(runs[0], runs[1])
    other = _serve(_port(params, "ring" if lane != "ring" else "pool-kernel", "2"), prompts, temperature=1.0,
                   seed=17)
    np.testing.assert_array_equal(runs[0], other)  # and on the other chunk: one draw a step on either


def test_streaminglm_reports_bucketed_chunks(monkeypatch):
    monkeypatch.delenv("SELDON_TPU_CTX_BUCKETS", raising=False)
    lm = StreamingLM(device="cpu", dtype="float32", max_new_tokens=6, max_slots=4, **CFG, **ENGINE)
    lm.load()
    try:
        # a short and a long stream in one chunk, as two callers send them
        streams = [lm.engine.submit(p, max_new_tokens=6) for p in _bimodal_prompts(4, 40, 2)]
        lm._wake.set()
        assert all(s.event.wait(60) and s.result.shape == (6,) for s in streams)
        gauges = {m["key"]: m["value"] for m in lm.metrics() if not m.get("tags")}
        assert gauges["paged_bucketed_chunks"] == lm.engine.engine_stats()["bucketed_chunks"] > 0
    finally:
        lm.unload()


# ---------------------------------------------------------------- C19: the default per device


@pytest.mark.parametrize("device,value,want", [
    ("cuda", None, 1), ("cpu", None, 2),  # unset: one bucket on CUDA, JAX's two elsewhere
    ("cuda", "2", 2), ("cuda", "1", 1), ("cpu", "1", 1), ("cpu", "2", 2),  # an explicit value wins
])
def test_the_default_follows_the_device(monkeypatch, device, value, want):
    if value is None:
        monkeypatch.delenv("SELDON_TPU_CTX_BUCKETS", raising=False)
    else:
        monkeypatch.setenv("SELDON_TPU_CTX_BUCKETS", value)
    assert paged_ctx_buckets(torch.device(device)) == want  # a device object needs no card


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_a_bad_value_raises_on_either_device(monkeypatch, device):
    monkeypatch.setenv("SELDON_TPU_CTX_BUCKETS", "3")
    with pytest.raises(ValueError, match="SELDON_TPU_CTX_BUCKETS='3'"):
        paged_ctx_buckets(torch.device(device))


def test_the_cpu_engine_keeps_two_buckets_unset(params, monkeypatch):
    monkeypatch.delenv("SELDON_TPU_CTX_BUCKETS", raising=False)
    eng = PagedEngine(params, dtype="float32", device="cpu", max_slots=4, **CFG, **ENGINE)
    _serve(eng, _bimodal_prompts(4, 40, 4))
    assert eng.engine_stats()["ctx_buckets"] == 2 and eng.engine_stats()["bucketed_chunks"] > 0


def _as_if_cuda(monkeypatch):
    """The engine asks the rule with its own device; on this host the rule
    is asked as for a CUDA engine, and the devices it was asked with are
    returned for the test to read."""
    asked = []
    real = paged.paged_ctx_buckets
    monkeypatch.setattr(paged, "paged_ctx_buckets", lambda device: asked.append(device) or real(torch.device("cuda")))
    return asked


@pytest.mark.parametrize("lane", ["ring", "pool-kernel"])
def test_an_engine_run_as_on_cuda_runs_one_bucket(params, monkeypatch, lane):
    monkeypatch.delenv("SELDON_TPU_CTX_BUCKETS", raising=False)
    asked = _as_if_cuda(monkeypatch)
    impl, kernel = LANES[lane]
    with _env(SELDON_TPU_CHUNK_IMPL=impl, SELDON_TPU_PAGED_KERNEL=kernel):
        eng = PagedEngine(params, dtype="float32", device="cpu", max_slots=4, **CFG, **ENGINE)
    assert asked == [eng.device]
    toks = _serve(eng, _bimodal_prompts(4, 40, 4))
    s = eng.engine_stats()
    assert s["ctx_buckets"] == 1 and s["bucketed_chunks"] == 0 and s["chunks"] > 0
    np.testing.assert_array_equal(toks, _serve(_port(params, lane, "1"), _bimodal_prompts(4, 40, 4)))


def test_a_streaminglm_run_as_on_cuda_reports_one_bucket(monkeypatch):
    monkeypatch.delenv("SELDON_TPU_CTX_BUCKETS", raising=False)
    asked = _as_if_cuda(monkeypatch)
    lm = StreamingLM(device="cpu", dtype="float32", max_new_tokens=6, max_slots=4, **CFG, **ENGINE)
    lm.load()
    try:
        streams = [lm.engine.submit(p, max_new_tokens=6) for p in _bimodal_prompts(4, 40, 2)]
        lm._wake.set()
        assert all(s.event.wait(60) and s.result.shape == (6,) for s in streams)
        health = lm.health_status()["engine"]
        assert asked == [lm.device] and health["ctx_buckets"] == 1 and health["bucketed_chunks"] == 0
        gauges = {m["key"]: m["value"] for m in lm.metrics() if not m.get("tags")}
        assert gauges["paged_bucketed_chunks"] == 0
    finally:
        lm.unload()
