"""The pool's capacity accounting: the port's functions against the JAX
package's, and the port's real pool bytes against the accounting.

``paged_hbm_accounting``, ``paged_capacity_streams`` and
``paged_max_context`` are pure arithmetic: for every argument swept, one
at a time from a base configuration and in a few combinations, the port
returns exactly what the JAX package returns.  The port's pool is the
split layout with no tile pad, so a ``PagedEngine``'s K/V pools (and the
int8 pool's scale tables) hold the accounting's ``pool_bytes`` at
``flat_pool=False, split_tile_pad=1.0`` plus the trash page 0.
"""

import itertools

import pytest
import torch

from seldon_core_tpu.models import paged as jax_paged
from seldon_core_tpu_torch.models import paged
from seldon_core_tpu_torch.models.generate import load_lm_params

BASE = dict(streams=16, ctx_len=1000, d_model=512, num_layers=8)
SWEEP = {
    "streams": [0, 1, 3, 16, 257],
    "ctx_len": [0, 1, 63, 64, 65, 1024, 32768],
    "d_model": [32, 512, 4096],
    "num_layers": [1, 8, 80],
    "page_size": [8, 16, 64, 128],
    "steps_per_call": [1, 8, 32],
    "dtype_bytes": [1, 2, 4],
    "flat_pool": [True, False],
    "chunk_impl": ["ring", "pool"],
    "donated": [True, False],
    "split_tile_pad": [1.0, 1.25, 2.0],
    "cached_prefix_pages": [0, 5, 100],
    "tp_degree": [1, 2, 4, 8],
    "dp_degree": [1, 2, 4],
    "num_pool_pages": [None, 257, 256, 1001],
    "num_heads": [None, 8, 12, 6],
    "inflight_prefill_tokens": [0, 1, 100, 4096],
    "adapter_bytes": [0, 12345678],
    "reclaimable_weight_bytes": [0, 999],
    "kv_dtype": ["bf16", "int8"],
    "host_tier_gib": [0.0, 0.5, 2.0],
}
CASES = [(name, value) for name, values in SWEEP.items() for value in values]
COMBOS = [
    dict(tp_degree=4, num_heads=8, dp_degree=2, num_pool_pages=258, kv_dtype="int8", chunk_impl="pool"),
    dict(tp_degree=3, num_heads=8, dp_degree=4, num_pool_pages=257, flat_pool=False, donated=False),
    dict(kv_dtype="int8", inflight_prefill_tokens=700, adapter_bytes=1 << 20, cached_prefix_pages=9,
         page_size=16, split_tile_pad=1.0, flat_pool=False),
]


@pytest.mark.parametrize("name,value", CASES, ids=[f"{n}={v}" for n, v in CASES])
def test_hbm_accounting_matches_jax(name, value):
    kw = {**BASE, name: value}
    assert paged.paged_hbm_accounting(**kw) == jax_paged.paged_hbm_accounting(**kw)


@pytest.mark.parametrize("combo", COMBOS)
def test_hbm_accounting_combinations_match_jax(combo):
    kw = {**BASE, **combo}
    assert paged.paged_hbm_accounting(**kw) == jax_paged.paged_hbm_accounting(**kw)


def test_defaults_match_jax():
    import inspect

    for name in ("paged_hbm_accounting", "paged_capacity_streams", "paged_max_context"):
        ours, theirs = inspect.signature(getattr(paged, name)), inspect.signature(getattr(jax_paged, name))
        assert [(p.name, p.default, p.kind) for p in ours.parameters.values()] == \
            [(p.name, p.default, p.kind) for p in theirs.parameters.values()], name


@pytest.mark.parametrize("budget,ctx_len,extra", list(itertools.product(
    [0, 1 << 20, 80 << 30], [1, 512, 4096],
    [{}, dict(kv_dtype="int8"), dict(inflight_prefill_tokens=2048, adapter_bytes=1 << 28),
     dict(donated=False, chunk_impl="pool", tp_degree=2, num_heads=8)])))
def test_capacity_streams_matches_jax(budget, ctx_len, extra):
    kw = dict(d_model=512, num_layers=8, **extra)
    assert paged.paged_capacity_streams(budget, ctx_len, **kw) == jax_paged.paged_capacity_streams(
        budget, ctx_len, **kw)


@pytest.mark.parametrize("budget,extra", list(itertools.product(
    [0, 1 << 16, 1 << 30, 80 << 30],
    [{}, dict(page_size=16), dict(dp_degree=4, num_pool_pages=1024), dict(kv_dtype="int8", chunk_impl="pool"),
     dict(max_len_cap=1 << 12)])))
def test_max_context_matches_jax(budget, extra):
    kw = dict(d_model=512, num_layers=8, **extra)
    assert paged.paged_max_context(budget, **kw) == jax_paged.paged_max_context(budget, **kw)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_engine_pool_bytes_equal_the_accounting(kv_dtype, monkeypatch):
    cfg = dict(vocab_size=64, d_model=32, num_layers=2, num_heads=2, max_len=128)
    slots, ps = 3, 16
    monkeypatch.setenv("SELDON_TPU_CHUNK_IMPL", "pool")  # the int8 pool is a pool-chunk pool
    monkeypatch.setenv("SELDON_TPU_KV_DTYPE", kv_dtype)
    eng = paged.PagedEngine(load_lm_params("", cfg, 0), dtype="bfloat16", device="cpu", page_size=ps,
                            max_slots=slots, **cfg)
    real = sum(t.numel() * t.element_size() for t in (eng.pages_k, eng.pages_v))
    if kv_dtype == "int8":
        real += sum(t.numel() * t.element_size() for t in (eng.scales_k, eng.scales_v))
    acct = paged.paged_hbm_accounting(streams=slots, ctx_len=cfg["max_len"], d_model=cfg["d_model"],
                                      num_layers=cfg["num_layers"], page_size=ps, flat_pool=False,
                                      split_tile_pad=1.0, chunk_impl="pool", kv_dtype=kv_dtype)
    trash = paged.paged_hbm_accounting(streams=1, ctx_len=ps, d_model=cfg["d_model"], num_layers=cfg["num_layers"],
                                       page_size=ps, flat_pool=False, split_tile_pad=1.0, chunk_impl="pool",
                                       kv_dtype=kv_dtype)["pool_bytes"]
    assert eng.num_pages == slots * cfg["max_len"] // ps + 1
    assert real == acct["pool_bytes"] + trash
    assert eng.pages_k.dtype == (torch.int8 if kv_dtype == "int8" else torch.bfloat16)
    eng.close()
