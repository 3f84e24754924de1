"""The port's ring decode chunk against the JAX engine's.

Both engines run the same flax ``TransformerLM`` init in float32 with
``SELDON_TPU_CHUNK_IMPL=ring`` (the JAX engine's ``_chunk_fn`` with its
``ChunkTransformerLM``, the port's ``PagedEngine._chunk_ring`` with
``PagedTransformerLM.forward_ring`` on the same weights), on one
submission order per case: plain, two adapters, ``precision="w8a8"``, a
prefix-cache hit, and a shrunk pool that stalls and evicts.  Greedy
tokens must be equal, exactly; the logits after the prefill wave and
after the first chunk within 1e-5 of the largest; and each stream's pool
contents after that chunk equal below its length (the ring's write-back
put the chunk's accepted tokens where the JAX engine put them).

Around them, the port's own contract: ring tokens equal the pool chunk's,
the chunk selection for every ``SELDON_TPU_PAGED_KERNEL`` value on the
CPU is JAX's (``tests/test_paged_kernel.py:156-169``), an int8 pool under
the ring degrades to the native pool with JAX's WARN, the ring launches
no paged-decode kernel call, and the allocator audit stays clean with
the cache on.
"""

import contextlib
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from seldon_core_tpu.models import paged as jax_paged
from seldon_core_tpu.models import registry as jax_registry
from seldon_core_tpu.models.transformer import TransformerLM as FlaxTransformerLM
from seldon_core_tpu_torch.models import registry
from seldon_core_tpu_torch.models.convert import lm_params_from_flax
from seldon_core_tpu_torch.models.paged import PagedEngine
from seldon_core_tpu_torch.ops import kernels, lora

CFG = dict(vocab_size=64, d_model=64, num_layers=2, num_heads=2, max_len=128)
ENGINE = dict(page_size=8, max_slots=4, steps_per_call=4)
RANK = 2
MAX_NEW = 8
SIZES = (14, 7, 12, 9)
LOGITS_REL = 1e-5


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


def _prompts(case):
    rng = np.random.default_rng(21)
    if case == "prefix":
        # a two-page shared prefix: the third and fourth prompts hit it
        shared = rng.integers(0, CFG["vocab_size"], size=(16,)).astype(np.int32)
        return [np.concatenate([shared, rng.integers(0, CFG["vocab_size"], size=(n,)).astype(np.int32)])
                for n in (3, 5, 2, 6)]
    if case == "tight":
        return [rng.integers(0, CFG["vocab_size"], size=(n,)).astype(np.int32) for n in (13, 15, 14, 14)]
    return [rng.integers(0, CFG["vocab_size"], size=(n,)).astype(np.int32) for n in SIZES]


def _adapters():
    return {f"t{i}": lora.make_lora_params(300 + i, num_layers=CFG["num_layers"], d_model=CFG["d_model"], rank=RANK)
            for i in range(2)}


def _registry(mod):
    reg = mod.WeightRegistry(budget_bytes=0)
    for name, ad in _adapters().items():
        reg.register(name, (lambda a=ad: a), bytes_hint=lora.adapter_bytes(ad))
    return reg


# case -> (engine options, adapter mix)
CASES = {
    "plain": ({}, None),
    "adapters": ({"max_adapters": 2, "lora_rank": RANK}, ["t1", None, "t0", "t1"]),
    "w8a8": ({"precision": "w8a8"}, None),
    "prefix": ({"prefix_cache": True}, None),
    # 8 usable pages: four 2-page prompts admit and fill the pool, each
    # stalls for its third page in the first chunk, and one is evicted
    "tight": ({"num_pages": 9}, None),
}


def _engine_kw(case, mod):
    kw, mix = CASES[case]
    kw = {"prefix_cache": False, **kw}
    if "max_adapters" in kw:
        kw["weight_registry"] = _registry(mod)
    return kw, mix or [None] * 4


def _flat_pages(pool, n_layers):
    """A pool as (layers, pages, page_size, d_model) numpy."""
    a = np.asarray(pool, np.float32)
    return a.reshape(n_layers, a.shape[1], a.shape[2], -1)


def _contents(eng, streams, pk, pv):
    """Each stream's pooled K and V below its length, (layers, len, d)."""
    out = []
    for s in streams:
        n = int(eng._lengths[s.slot])
        pages = np.asarray(eng._block_tables[s.slot, : -(-n // ENGINE["page_size"])])
        k = pk[:, pages].reshape(CFG["num_layers"], -1, pk.shape[-1])[:, :n]
        v = pv[:, pages].reshape(CFG["num_layers"], -1, pv.shape[-1])[:, :n]
        out.append((k, v))
    return out


def _drive(eng, case, mix, logits_of, pools_of):
    """Prefill logits, the first chunk's logits and pool contents, greedy
    tokens, and the engine's counters."""
    if case == "prefix":
        # one stream publishes the shared pages first: every prompt after
        # it maps them
        eng.submit(_prompts(case)[0], max_new_tokens=MAX_NEW)
        eng.run()
    streams = [eng.submit(p, max_new_tokens=MAX_NEW, adapter=a) for p, a in zip(_prompts(case), mix)]
    with eng._lock:
        admitted = [s for s, _ in eng._admit_locked()]
    eng._prefill_streams(admitted)
    live = [s for s in streams if s.slot is not None]
    prefill = logits_of(eng)[[s.slot for s in live]]
    eng.step()
    live = [s for s in live if s.slot is not None]
    chunk = logits_of(eng)[[s.slot for s in live]]
    contents = _contents(eng, live, *pools_of(eng))
    eng.run()
    return {"tokens": np.stack([s.result for s in streams]), "prefill": prefill, "chunk": chunk,
            "contents": contents, "stats": eng.engine_stats()}


@pytest.fixture(scope="module")
def flax_params():
    lm = FlaxTransformerLM(dtype=jnp.float32, **CFG)
    return lm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]


@pytest.fixture(scope="module")
def params(flax_params):
    return lm_params_from_flax(flax_params)


@pytest.fixture(scope="module")
def jax_runs(flax_params):
    out = {}
    with _env(SELDON_TPU_CHUNK_IMPL="ring", SELDON_TPU_PAGED_KERNEL=None, SELDON_TPU_KV_DTYPE=None):
        for case in CASES:
            kw, mix = _engine_kw(case, jax_registry)
            eng = jax_paged.PagedEngine(flax_params, dtype=jnp.float32, **CFG, **{**ENGINE, **kw})
            assert eng._chunk_impl == "ring" and not eng._kernel_active
            out[case] = _drive(eng, case, mix, lambda e: np.asarray(e._logits),
                               lambda e: [_flat_pages(p, CFG["num_layers"]) for p in (e.pages_k, e.pages_v)])
            eng.close()
    return out


def _port(params, case, **env):
    kw, mix = _engine_kw(case, registry)
    with _env(**{"SELDON_TPU_CHUNK_IMPL": "ring", "SELDON_TPU_PAGED_KERNEL": None, **env}):
        eng = PagedEngine(params, dtype="float32", device="cpu", **CFG, **{**ENGINE, **kw})
    return eng, mix


def _port_run(params, case, **env):
    eng, mix = _port(params, case, **env)
    return eng, _drive(eng, case, mix, lambda e: e._logits.numpy(),
                       lambda e: [_flat_pages(p, CFG["num_layers"]) for p in (e.pages_k, e.pages_v)])


@pytest.fixture(scope="module")
def port_runs(params):
    return {case: _port_run(params, case)[1] for case in CASES}


@pytest.mark.parametrize("case", list(CASES))
def test_ring_engine_equals_the_jax_ring_engine(jax_runs, port_runs, case):
    got, want = port_runs[case], jax_runs[case]
    for key in ("prefill", "chunk"):
        np.testing.assert_allclose(got[key], want[key], rtol=LOGITS_REL,
                                   atol=LOGITS_REL * np.abs(want[key]).max(), err_msg=key)
    assert len(got["contents"]) == len(want["contents"])
    for (gk, gv), (wk, wv) in zip(got["contents"], want["contents"]):
        assert gk.shape == wk.shape
        np.testing.assert_allclose(gk, wk, rtol=LOGITS_REL, atol=LOGITS_REL * np.abs(wk).max())
        np.testing.assert_allclose(gv, wv, rtol=LOGITS_REL, atol=LOGITS_REL * np.abs(wv).max())
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    for key in ("tokens", "chunks", "stalls", "evictions", "prefix_hits", "prefix_tokens_saved"):
        assert got["stats"][key] == want["stats"][key], key


def test_the_cases_reach_their_paths(port_runs):
    assert port_runs["prefix"]["stats"]["prefix_hits"] == 4
    assert port_runs["tight"]["stats"]["stalls"] > 0 and port_runs["tight"]["stats"]["evictions"] > 0
    assert not np.array_equal(port_runs["adapters"]["tokens"], port_runs["plain"]["tokens"])
    assert not np.array_equal(port_runs["w8a8"]["prefill"], port_runs["plain"]["prefill"])


@pytest.mark.parametrize("case", ["plain", "adapters", "tight"])
def test_ring_tokens_equal_the_pool_chunk(params, port_runs, case):
    eng, mix = _port(params, case, SELDON_TPU_CHUNK_IMPL="pool", SELDON_TPU_PAGED_KERNEL="force")
    assert eng._chunk_impl == "pool" and eng._kernel_active
    got = _drive(eng, case, mix, lambda e: e._logits.numpy(),
                 lambda e: [_flat_pages(p, CFG["num_layers"]) for p in (e.pages_k, e.pages_v)])
    np.testing.assert_array_equal(got["tokens"], port_runs[case]["tokens"])


def test_the_ring_launches_no_paged_decode_call(params, monkeypatch):
    calls = []
    real = kernels.paged_attention_decode
    monkeypatch.setattr(kernels, "paged_attention_decode", lambda *a, **k: calls.append(1) or real(*a, **k))
    eng, _ = _port(params, "plain", SELDON_TPU_PAGED_KERNEL="force")
    assert eng._chunk_impl == "ring" and not eng._kernel_active
    eng.generate(_prompts("plain")[0], max_new_tokens=MAX_NEW)
    assert calls == [] and eng.engine_stats()["chunks"] > 0


@pytest.mark.parametrize("kernel", ["auto", "1", "force", "0"])
@pytest.mark.parametrize("chunk", [None, "ring", "pool"])
def test_chunk_selection_is_jaxs(params, flax_params, kernel, chunk):
    env = dict(SELDON_TPU_PAGED_KERNEL=kernel, SELDON_TPU_CHUNK_IMPL=chunk, SELDON_TPU_KV_DTYPE=None)
    with _env(**env):
        want = jax_paged.PagedEngine(flax_params, dtype=jnp.float32, **CFG, **ENGINE)
        got = PagedEngine(params, dtype="float32", device="cpu", **CFG, **ENGINE)
    assert got._chunk_impl == want._chunk_impl
    assert got._kernel_active == want._kernel_active
    assert got.engine_stats()["chunk_impl"] == want._chunk_impl
    want.close()


@pytest.mark.parametrize("kernel", ["auto", "1", "force", "0"])
@pytest.mark.parametrize("chunk", [None, "ring", "pool"])
def test_the_chunk_warns_where_jaxs_does(params, flax_params, caplog, kernel, chunk):
    # an explicit kernel opt-in that the chosen chunk never reaches WARNs
    env = dict(SELDON_TPU_PAGED_KERNEL=kernel, SELDON_TPU_CHUNK_IMPL=chunk, SELDON_TPU_KV_DTYPE=None)
    warned = {}
    for name, build in (("jax", lambda: jax_paged.PagedEngine(flax_params, dtype=jnp.float32, **CFG, **ENGINE)),
                        ("port", lambda: PagedEngine(params, dtype="float32", device="cpu", **CFG, **ENGINE))):
        caplog.clear()
        with caplog.at_level(logging.WARNING), _env(**env):
            eng = build()
        warned[name] = [r.getMessage() for r in caplog.records
                        if r.levelno == logging.WARNING and "SELDON_TPU_PAGED_KERNEL" in r.getMessage()]
        if name == "jax":
            eng.close()
    if chunk == "pool":
        # the JAX engine says nothing here; the port names the gather lane
        # an explicit "1" falls back to on the CPU
        assert warned["jax"] == []
        assert [("gather lane" in m) for m in warned["port"]] == ([True] if kernel == "1" else []), warned
        return
    assert len(warned["port"]) == len(warned["jax"]), warned
    assert all(("ring" in m) == ("ring" in w) for m, w in zip(warned["port"], warned["jax"])), warned


def test_an_int8_pool_under_the_ring_degrades_with_a_warn(params, caplog):
    with caplog.at_level(logging.WARNING), _env(SELDON_TPU_KV_DTYPE="int8"):
        eng, _ = _port(params, "plain")
    assert eng._kv_int8 is False and eng.scales_k is None
    assert eng.pages_k.dtype == eng.dtype
    assert "keeping the native pool dtype" in caplog.text
    assert eng.engine_stats()["kv_dtype_int8"] == 0


def test_the_audit_stays_clean_under_the_ring_with_the_cache(params):
    eng, _ = _port(params, "prefix", SELDON_TPU_PAGED_DEBUG="1")
    assert eng._debug_invariants and eng._prefix_cache_enabled
    streams = [eng.submit(p, max_new_tokens=MAX_NEW) for p in _prompts("prefix") * 2]
    eng.run()  # the audit runs at every chunk boundary and raises on a fault
    assert all(s.result is not None for s in streams)
    assert eng.engine_stats()["prefix_hits"] >= 4
    assert eng.engine_stats()["free_pages"] + eng.engine_stats()["prefix_pages_cached"] == eng.num_pages - 1
