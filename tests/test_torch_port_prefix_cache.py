"""The port's prefix cache against the JAX engine's.

The port versions of ``tests/test_prefix_cache.py``'s engine cases, each
run on the same submission order through the JAX engine (float32, the
pool chunk, the kernel lane forced: JAX's Pallas kernel in interpret
mode) and the port's: greedy tokens equal, and the hit, miss and
saved-token counters equal.  Around them, the allocator's own contract:
pages shared by refcount (the same physical pages in both block
tables), the last prompt page kept private, LRU reclaim of cached pages
under pressure, colliding keys compared by their tokens, one chain root
per adapter, the ``SELDON_TPU_PAGED_DEBUG`` audit clean under a workload
and catching an injected corruption, and cache on giving the tokens of
cache off.
"""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from seldon_core_tpu.models import paged as jax_paged
from seldon_core_tpu.models import registry as jax_registry
from seldon_core_tpu.models.transformer import TransformerLM as FlaxTransformerLM
from seldon_core_tpu_torch.models import paged, registry
from seldon_core_tpu_torch.models.convert import lm_params_from_flax
from seldon_core_tpu_torch.models.paged import PagedEngine, StreamingLM
from seldon_core_tpu_torch.ops import lora
from seldon_core_tpu_torch.runtime.component import MicroserviceError

CFG = dict(vocab_size=64, d_model=32, num_layers=1, num_heads=2, max_len=128)
ENGINE = dict(page_size=8, max_slots=2, steps_per_call=4)
COUNTERS = ("prefix_hits", "prefix_misses", "prefix_tokens_saved")
JAX_ENV = dict(SELDON_TPU_PAGED_KERNEL="force", SELDON_TPU_CHUNK_IMPL="pool", SELDON_TPU_PAGED_KERNEL_IMPL="stream")


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


def _shared_prompts(n=3, shared_tokens=16, seed=0):
    """``n`` prompts sharing a ``shared_tokens`` system prefix (two pages
    of 8) with distinct suffixes."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, CFG["vocab_size"], size=(shared_tokens,)).astype(np.int32)
    return [np.concatenate([shared, rng.integers(0, CFG["vocab_size"], size=(3 + i,)).astype(np.int32)])
            for i in range(n)]


ALIGNED = np.arange(16, dtype=np.int32) % CFG["vocab_size"]  # exactly two pages
P1 = (np.arange(20, dtype=np.int32) * 5) % CFG["vocab_size"]
P2 = (np.arange(20, dtype=np.int32) * 11 + 3) % CFG["vocab_size"]
ADAPTER_MIX = ["t0", "t1", "t0", None, "t1"]


def _adapters():
    return {f"t{i}": lora.make_lora_params(300 + i, num_layers=CFG["num_layers"], d_model=CFG["d_model"], rank=2)
            for i in range(2)}


def _registry(mod):
    reg = mod.WeightRegistry(budget_bytes=0)
    for name, ad in _adapters().items():
        reg.register(name, (lambda a=ad: a), bytes_hint=lora.adapter_bytes(ad))
    return reg


def _counters(eng):
    s = eng.engine_stats()
    return {k: s[k] for k in COUNTERS}


# the scenarios, each a function of an engine factory; each returns what
# the two engines must agree on

def _sequential(make):
    """Shared-prefix prompts one after another, then a page-aligned
    prompt twice (its last page stays private)."""
    eng = make()
    out = {"tokens": [eng.generate(p, max_new_tokens=6).tolist() for p in _shared_prompts()]}
    out["after_shared"] = _counters(eng)
    out["tokens"] += [eng.generate(ALIGNED.copy(), max_new_tokens=4).tolist() for _ in range(2)]
    out["after_aligned"] = _counters(eng)
    return out


def _concurrent(make):
    """A follower admitted while the publisher still decodes."""
    eng = make()
    prompts = _shared_prompts(n=2)
    a = eng.submit(prompts[0], max_new_tokens=20)
    eng.step()
    b = eng.submit(prompts[1], max_new_tokens=12)
    eng.step()
    shared = (list(a.pages[:2]), list(b.pages[:2]), b.cached_len,
              [int(eng._page_ref[p]) for p in a.pages[:2]])
    eng.run()
    return {"tokens": [a.result.tolist(), b.result.tolist()], "counters": _counters(eng), "shared": shared,
            "after": [(int(eng._page_ref[p]), p in eng._lru) for p in shared[0]]}


def _collisions(make):
    """Every chain key colliding: different prompts stay private,
    identical ones still share."""
    eng = make()
    tokens = [eng.generate(p, max_new_tokens=6).tolist() for p in (P1, P2)]
    mid = _counters(eng)
    tokens.append(eng.generate(P1.copy(), max_new_tokens=6).tolist())
    return {"tokens": tokens, "mid": mid, "end": _counters(eng)}


def _adapter_roots(make):
    """One system prompt under two adapters and the base model: sharing
    only within a weight set."""
    eng = make(max_adapters=2, lora_rank=2)
    prompts = _shared_prompts(n=len(ADAPTER_MIX), seed=4)
    tokens = [eng.generate(p, max_new_tokens=5, adapter=a).tolist() for p, a in zip(prompts, ADAPTER_MIX)]
    return {"tokens": tokens, "counters": _counters(eng)}


def _jax_factory(flax_params, **base):
    def make(**kw):
        if kw.get("max_adapters"):
            kw["weight_registry"] = _registry(jax_registry)
        return jax_paged.PagedEngine(flax_params, dtype=jnp.float32, **CFG, **{**ENGINE, **base, **kw})
    return make


def _port_factory(params, **base):
    def make(**kw):
        if kw.get("max_adapters"):
            kw["weight_registry"] = _registry(registry)
        return PagedEngine(params, dtype="float32", device="cpu", **CFG, **{**ENGINE, **base, **kw})
    return make


@pytest.fixture(scope="module")
def flax_params():
    lm = FlaxTransformerLM(dtype=jnp.float32, **CFG)
    return lm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]


@pytest.fixture(scope="module")
def params(flax_params):
    return lm_params_from_flax(flax_params)


@pytest.fixture(scope="module")
def jax_results(flax_params):
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        with _env(**JAX_ENV):
            make = _jax_factory(flax_params)
            out["sequential"] = _sequential(make)
            out["concurrent"] = _concurrent(make)
            out["adapter_roots"] = _adapter_roots(make)
            mp.setattr(jax_paged, "prefix_chain_key", lambda p, t: 7)
            out["collisions"] = _collisions(make)
    finally:
        mp.undo()
    return out


@pytest.fixture
def port(params, monkeypatch):
    monkeypatch.setenv("SELDON_TPU_PAGED_KERNEL", "force")
    return _port_factory(params)


def test_sequential_shared_prefix_equals_the_jax_engine(port, jax_results):
    got = _sequential(port)
    assert got == jax_results["sequential"]
    # the followers map the two shared pages; the aligned prompt shares one
    assert got["after_shared"] == {"prefix_hits": 2, "prefix_misses": 1, "prefix_tokens_saved": 32}
    assert got["after_aligned"]["prefix_tokens_saved"] - got["after_shared"]["prefix_tokens_saved"] == 8


def test_concurrent_streams_share_pages_by_refcount(port, jax_results):
    got = _concurrent(port)
    want = jax_results["concurrent"]
    assert got["tokens"] == want["tokens"] and got["counters"] == want["counters"]
    a_pages, b_pages, cached_len, refs = got["shared"]
    assert a_pages == b_pages and cached_len == 16 and refs == [2, 2]  # the same physical pages, twice mapped
    assert got["after"] == [(0, True), (0, True)]  # both finished: on the LRU once


def test_colliding_keys_compare_tokens_before_sharing(port, jax_results, monkeypatch):
    monkeypatch.setattr(paged, "prefix_chain_key", lambda p, t: 7)
    got = _collisions(port)
    assert got == jax_results["collisions"]
    assert got["mid"]["prefix_hits"] == 0 and got["end"]["prefix_hits"] == 1
    off = port(prefix_cache=False)
    assert got["tokens"] == [off.generate(p, max_new_tokens=6).tolist() for p in (P1, P2, P1)]


def test_each_adapter_chains_off_its_own_root(port, jax_results):
    got = _adapter_roots(port)
    assert got == jax_results["adapter_roots"]
    # t0 and t1 each hit once (their second prompt); the base model's only one misses
    assert got["counters"] == {"prefix_hits": 2, "prefix_misses": 3, "prefix_tokens_saved": 32}
    eng = port(max_adapters=2, lora_rank=2)
    assert len({eng._prefix_root_for(a) for a in (None, "t0", "t1")}) == 3


def test_cache_on_equals_cache_off(port):
    on, off = port(), port(prefix_cache=False)
    prompts = _shared_prompts(n=6, seed=2)
    for eng in (on, off):
        streams = [eng.submit(p, max_new_tokens=9) for p in prompts]
        eng.run()
        eng.tokens = [s.result.tolist() for s in streams]
    assert on.tokens == off.tokens
    s = on.engine_stats()
    assert s["prefix_hits"] > 0 and s["prefill_tokens"] < off.engine_stats()["prefill_tokens"]
    so = off.engine_stats()
    assert so["prefix_hits"] == so["prefix_misses"] == so["prefix_pages_cached"] == 0


def test_env_knob_disables_and_the_constructor_wins(params, monkeypatch):
    monkeypatch.setenv("SELDON_TPU_PAGED_KERNEL", "force")
    monkeypatch.setenv("SELDON_TPU_PREFIX_CACHE", "0")
    eng = _port_factory(params)()
    for p in _shared_prompts():
        eng.generate(p, max_new_tokens=4)
    s = eng.engine_stats()
    assert s["prefix_hits"] == s["prefix_misses"] == s["prefix_pages_cached"] == 0
    assert len(eng._free_pages) == eng.num_pages - 1  # freed eagerly
    eng = _port_factory(params)(prefix_cache=True)
    assert eng._prefix_cache_enabled
    eng.generate(_shared_prompts()[0], max_new_tokens=4)
    assert eng.engine_stats()["prefix_pages_cached"] > 0
    monkeypatch.delenv("SELDON_TPU_PREFIX_CACHE")
    assert _port_factory(params)()._prefix_cache_enabled  # on by default, as in JAX


def test_alloc_free_refcount_discipline(port):
    eng = port()
    with eng._lock:
        total = eng.num_pages - 1
        got = eng._alloc_locked(3)
        assert len(got) == 3 and len(eng._free_pages) == total - 3
        assert all(int(eng._page_ref[p]) == 1 for p in got)
        assert eng._alloc_locked(total) is None  # over capacity: refused
        eng._free_locked(got)
        assert len(eng._free_pages) == total and all(int(eng._page_ref[p]) == 0 for p in got)


def test_alloc_reclaims_lru_cached_pages(port):
    eng = port()
    eng.generate(_shared_prompts()[0], max_new_tokens=4)
    assert eng.engine_stats()["prefix_pages_cached"] > 0
    with eng._lock:
        got = eng._alloc_locked(eng.num_pages - 1)  # must reclaim every cached page
        assert got is not None and len(got) == eng.num_pages - 1
    s = eng.engine_stats()
    assert s["prefix_pages_cached"] == 0 and s["prefix_evictions"] > 0 and not eng._prefix_index


def test_admitted_after_evicting_cached_pages(port):
    # 6 usable pages; a finished 15-token prompt caches its one full page,
    # and a 40 + 8-token request needs all 6 back
    eng = port(num_pages=7, max_slots=1)
    first = _shared_prompts(n=1)[0][:15]
    out_a = eng.generate(first, max_new_tokens=4)
    assert eng.engine_stats()["prefix_pages_cached"] == 1
    big = (np.arange(40, dtype=np.int32) * 3) % CFG["vocab_size"]
    out_b = eng.generate(big, max_new_tokens=8)
    s = eng.engine_stats()
    assert s["prefix_evictions"] >= 1 and s["completed"] == 2 and s["evictions"] == 0
    off = port(num_pages=7, max_slots=1, prefix_cache=False)
    np.testing.assert_array_equal(out_a, off.generate(first, max_new_tokens=4))
    np.testing.assert_array_equal(out_b, off.generate(big, max_new_tokens=8))
    # the ceiling is the whole pool, cached pages or not
    with pytest.raises(MicroserviceError, match="needs 7 pages") as err:
        eng.submit(np.arange(48, dtype=np.int32) % 64, max_new_tokens=8)
    assert err.value.reason == "SEQUENCE_TOO_LONG"


def test_debug_audit_clean_under_a_workload(port, monkeypatch):
    monkeypatch.setenv("SELDON_TPU_PAGED_DEBUG", "1")
    eng = port(max_adapters=2, lora_rank=2)
    assert eng._debug_invariants
    for p, a in zip(_shared_prompts(n=5, seed=4), ADAPTER_MIX):
        eng.submit(p, max_new_tokens=6, adapter=a)
    eng.run()  # audits every chunk boundary; raises on a violation
    with eng._lock:
        eng._check_invariants_locked()


@pytest.mark.parametrize("corruption", ["free_and_mapped", "refcount", "lru_entry", "adapter_pin"])
def test_the_audit_catches_an_injected_corruption(port, corruption):
    eng = port(max_adapters=2, lora_rank=2)
    prompts = _shared_prompts(n=2)
    eng.generate(prompts[0], max_new_tokens=4, adapter="t0")  # leaves cached prefix pages
    stream = eng.submit(prompts[1], max_new_tokens=20, adapter="t0")
    eng.step()
    assert stream.slot is not None and stream.cached_len == 16
    with eng._lock:
        eng._check_invariants_locked()  # clean before
        if corruption == "free_and_mapped":
            undo = lambda: eng._free_pages.pop()  # noqa: E731
            eng._free_pages.append(stream.pages[-1])
        elif corruption == "refcount":
            page = stream.pages[0]
            eng._page_ref[page] += 1
            undo = lambda: eng._page_ref.__setitem__(page, eng._page_ref[page] - 1)  # noqa: E731
        elif corruption == "lru_entry":
            page = stream.pages[-1]
            eng._lru[page] = eng._page_entry.get(stream.pages[0])
            undo = lambda: eng._lru.pop(page)  # noqa: E731
        else:
            slot = stream.adapter_slot
            eng._adapter_ref[slot] += 1
            undo = lambda: eng._adapter_ref.__setitem__(slot, eng._adapter_ref[slot] - 1)  # noqa: E731
        with pytest.raises(RuntimeError, match="invariant"):
            eng._check_invariants_locked()
        undo()
        eng._check_invariants_locked()  # restored: clean
    eng.run()


def test_registration_is_a_no_op_after_a_fail_all_race(port):
    eng = port()
    stream = eng.submit(_shared_prompts(n=1)[0], max_new_tokens=4)
    with eng._lock:
        admitted = eng._admit_locked()
    assert admitted and admitted[0][0] is stream
    eng.fail_all(RuntimeError("injected"))
    assert stream.pages == [] and stream.slot is not None
    with eng._lock:
        eng._register_prefix_locked(stream)  # must not raise
    assert not eng._prefix_index


def test_streaminglm_reports_the_cache(params, monkeypatch):
    monkeypatch.setenv("SELDON_TPU_PAGED_KERNEL", "force")
    lm = StreamingLM(device="cpu", dtype="float32", max_new_tokens=4, **CFG, **ENGINE)
    lm.load()
    try:
        for p in _shared_prompts():
            lm.predict(p[None], [])
        status = lm.health_status()
        engine = status["engine"]
        assert status["prefix_cache"] is True and engine["prefix_hits"] == 2
        metrics = {m["key"]: m["value"] for m in lm.metrics()}
        # the load's one-token warm-up counts a miss too
        assert metrics["paged_prefix_hit_rate"] == pytest.approx(2 / (2 + engine["prefix_misses"]))
        assert metrics["paged_prefix_tokens_saved"] == 32 and metrics["paged_prefix_pages_cached"] > 0
    finally:
        lm.unload()
    off = StreamingLM(device="cpu", prefix_cache=False, **CFG)
    assert off.health_status()["prefix_cache"] is False
