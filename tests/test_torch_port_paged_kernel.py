"""The port's ``paged_attention_decode`` against the JAX package's.

On the CPU the port's wrapper runs its plain version
(``paged_attention_decode_reference``); the JAX package's runs its
Pallas kernels in interpret mode, the stream impl (K4) or the grid impl
(K5) as ``SELDON_TPU_PAGED_KERNEL_IMPL`` selects.  The same numpy inputs
go to both: shuffled page ids, lengths 0, 1, ps, ps + 1, the full table
and one past it (a finished lane's length may exceed the table it is
given; both read only the table's pages).

Tolerance: the largest difference over finite entries, relative to the
largest such entry of the JAX result, is at most 1e-5 in float32 and
1e-3 in bfloat16 (both sides compute in float32 from the same values;
only the order of the sums differs).  ``-inf`` and ``0`` must appear
exactly where the JAX result has them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.ops import kernels as jax_kernels
from seldon_core_tpu_torch.ops import kernels

B, H, HD, PS, P = 7, 2, 16, 8, 5
NUM_PAGES = B * P + 1
LENGTHS = np.array([0, 1, PS, PS + 1, P * PS, 23, P * PS + 3], np.int32)
TOL = {"float32": 1e-5, "bfloat16": 1e-3}


def _inputs(dtype: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, HD)).astype(np.float32) * 0.25
    pk = rng.normal(size=(NUM_PAGES, PS, H, HD)).astype(np.float32)
    pv = rng.normal(size=(NUM_PAGES, PS, H, HD)).astype(np.float32)
    tables = rng.permutation(np.arange(1, NUM_PAGES)).reshape(B, P).astype(np.int32)
    if dtype == "bfloat16":  # both sides start from the same bf16 values
        q, pk, pv = (np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in (q, pk, pv))
    return q, pk, pv, tables, LENGTHS


def _port(dtype, q, pk, pv, tables, lengths):
    dt = getattr(torch, dtype)
    args = [torch.from_numpy(a).to(dt) for a in (q, pk, pv)]
    out = kernels.paged_attention_decode(*args, torch.from_numpy(tables), torch.from_numpy(lengths), page_size=PS)
    return [t.numpy() for t in out]


def _jax(dtype, q, pk, pv, tables, lengths):
    dt = getattr(jnp, dtype)
    out = jax_kernels.paged_attention_decode(jnp.asarray(q, dt), jnp.asarray(pk, dt), jnp.asarray(pv, dt),
                                             jnp.asarray(tables), jnp.asarray(lengths), page_size=PS)
    return [np.asarray(t, np.float32) for t in out]


def assert_flash_state_close(got, ref, tol):
    for name, g, r in zip(("acc", "m", "l"), got, ref):
        assert g.shape == r.shape and g.dtype == np.float32, name
        assert not np.isnan(g).any(), name
        special = np.isinf(r) | (r == 0)
        np.testing.assert_array_equal(g[special], r[special], err_msg=name)
        fin = ~special
        if fin.any():
            err = np.abs(g[fin] - r[fin]).max() / np.abs(r[fin]).max()
            assert err <= tol, f"{name}: relative error {err} > {tol}"


@pytest.fixture(scope="module")
def cases():
    """JAX's result per (impl, dtype): the Pallas interpret runs take seconds."""
    import os

    out = {}
    before = os.environ.get("SELDON_TPU_PAGED_KERNEL_IMPL")
    try:
        for impl in ("stream", "grid"):
            os.environ["SELDON_TPU_PAGED_KERNEL_IMPL"] = impl
            for dtype in ("float32", "bfloat16"):
                inputs = _inputs(dtype)
                out[impl, dtype] = (inputs, _jax(dtype, *inputs))
    finally:
        if before is None:
            os.environ.pop("SELDON_TPU_PAGED_KERNEL_IMPL", None)
        else:
            os.environ["SELDON_TPU_PAGED_KERNEL_IMPL"] = before
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["stream", "grid"])
def test_plain_version_matches_jax_kernel(cases, impl, dtype, monkeypatch):
    monkeypatch.setenv("SELDON_TPU_PAGED_KERNEL_IMPL", impl)
    inputs, ref = cases[impl, dtype]
    got = _port(dtype, *inputs)
    assert_flash_state_close(got, ref, TOL[dtype])


def test_empty_lane_is_the_neutral_state(cases):
    (inputs, _ref) = cases["stream", "float32"]
    acc, m, l = _port("float32", *inputs)
    assert np.isneginf(m[0]).all() and (l[0] == 0).all() and (acc[0] == 0).all()
    assert np.isfinite(m[1:]).all() and (l[1:] > 0).all()


def test_lane_reads_only_its_own_pages(cases):
    """Moving another lane's pages leaves a lane's state unchanged: the
    table, not the page order of the pool, decides what a lane reads."""
    (q, pk, pv, tables, lengths), _ = cases["grid", "float32"]
    base = _port("float32", q, pk, pv, tables, lengths)
    pk2, pv2 = pk.copy(), pv.copy()
    others = tables[3]  # lane 3's pages: scribble over them
    pk2[others] = 7.0
    pv2[others] = -7.0
    moved = _port("float32", q, pk2, pv2, tables, lengths)
    for b, m in zip(base, moved):
        np.testing.assert_array_equal(np.delete(b, 3, axis=0), np.delete(m, 3, axis=0))


def test_cpu_tensors_take_the_plain_version_and_launch_nothing(cases):
    before = kernels.launch_counts()
    (inputs, _ref) = cases["stream", "float32"]
    _port("float32", *inputs)
    assert kernels.launch_counts() == before


def test_impl_knob(monkeypatch):
    monkeypatch.delenv("SELDON_TPU_PAGED_KERNEL_IMPL", raising=False)
    assert kernels.paged_kernel_impl(H, HD) == "stream"
    monkeypatch.setenv("SELDON_TPU_PAGED_KERNEL_IMPL", "grid")
    assert kernels.paged_kernel_impl(H, HD) == "grid"
    monkeypatch.setenv("SELDON_TPU_PAGED_KERNEL_IMPL", "tiled")
    with pytest.raises(ValueError, match="use 'stream' or 'grid'"):
        kernels.paged_kernel_impl(H, HD)


def test_page_size_mismatch_raises():
    q, pk, pv, tables, lengths = _inputs("float32")
    with pytest.raises(ValueError, match="page_size"):
        kernels.paged_attention_decode(torch.from_numpy(q), torch.from_numpy(pk), torch.from_numpy(pv),
                                       torch.from_numpy(tables), torch.from_numpy(lengths), page_size=PS * 2)


# (impl, heads, head_dim, page size, table pages, pool dtype) -> (G, HG)
SPLITS = [
    (("stream", 8, 64, 64, 16, torch.bfloat16), (1, 4)),   # the serving shape: a page and 4 heads a block
    (("grid", 8, 64, 64, 16, torch.bfloat16), (1, 4)),
    (("stream", 8, 64, 64, 16, torch.float32), (1, 2)),    # f32 rows are twice as wide: half the heads
    (("stream", 8, 64, 64, 16, torch.int8), (1, 4)),
    (("stream", 2, 16, 8, 6, torch.float32), (6, 2)),      # pages of 8: up to 64 rows a chunk, capped at P
    (("grid", 2, 16, 8, 6, torch.float32), (1, 2)),
    (("stream", 16, 128, 16, 64, torch.bfloat16), (4, 2)),
    (("stream", 3, 40, 8, 6, torch.int8), (6, 3)),         # head_dim padded to 48 bytes
]


@pytest.mark.parametrize("geometry,split", SPLITS, ids=[f"{g[0]}-h{g[1]}-hd{g[2]}-ps{g[3]}-P{g[4]}-{g[5]}"[:60]
                                                        for g, _ in SPLITS])
def test_split_follows_the_geometry(geometry, split):
    assert kernels.paged_split(*geometry) == split


def test_split_depends_on_the_geometry_alone():
    """How a lane is split across blocks is decided from the geometry
    (heads, head_dim, page size, table pages, pool dtype) and the impl:
    nothing about the batch or the lengths enters, and every choice stays
    inside the kernel's limits."""
    import inspect

    assert list(inspect.signature(kernels.paged_split).parameters) == [
        "impl", "heads", "head_dim", "page_size", "table_pages", "pool_dtype"]
    for impl in ("stream", "grid"):
        for heads in (1, 2, 3, 8, 12, 16, 32):
            for head_dim in (8, 16, 40, 64, 128):
                for ps in (1, 8, 16, 64, 100):
                    for dtype in (torch.float32, torch.bfloat16, torch.int8):
                        G, HG = kernels.paged_split(impl, heads, head_dim, ps, 16, dtype)
                        elt = torch.empty((), dtype=dtype).element_size()
                        padded = -(-head_dim * elt // 16) * 16  # bytes
                        assert 1 <= G <= 16 and (G == 1 or G * ps <= kernels.PAGED_CHUNK_ROWS)
                        assert G == 1 or impl == "stream"
                        assert heads % HG == 0 and HG <= kernels.PAGED_GROUP_HEADS
                        assert HG * padded <= kernels.PAGED_GROUP_BYTES
                        assert HG * padded // elt <= kernels.PAGED_GROUP_ELEMS
