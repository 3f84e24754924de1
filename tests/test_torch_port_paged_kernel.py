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
