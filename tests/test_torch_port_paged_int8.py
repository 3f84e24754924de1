"""The port's int8 KV pool against the JAX package's.

* the plain versions of K4-int8 / K5-int8 against JAX's Pallas kernels in
  interpret mode (``quantized=True``), stream and grid, with q in float32
  and bfloat16: within 1e-5 / 1e-3 of the largest entry, ``-inf`` and
  ``0`` exactly where JAX has them;
* the quantising pool write (prefill and the decode read-modify-write)
  against JAX's ``write_kv`` on ``(pages, scales)`` bundles: scales
  within 1e-6 relative, int8 values equal;
* the int8 engine's greedy tokens against the JAX int8 engine's, on the
  kernel lane (``force``) and the gather lane, in float32, at the tiny
  config of ``test_torch_port_paged_engine.py``.
"""

import contextlib
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.models import paged as jax_paged
from seldon_core_tpu.models.transformer import TransformerLM as FlaxTransformerLM
from seldon_core_tpu.ops import kernels as jax_kernels
from seldon_core_tpu_torch.models import paged
from seldon_core_tpu_torch.models.convert import lm_params_from_flax
from seldon_core_tpu_torch.models.paged import PagedEngine, StreamingLM
from seldon_core_tpu_torch.ops import kernels

from test_torch_port_paged_kernel import assert_flash_state_close

B, H, HD, PS, P = 7, 2, 16, 8, 5
NUM_PAGES = B * P + 1
LENGTHS = np.array([0, 1, PS, PS + 1, P * PS, 23, P * PS + 3], np.int32)
TOL = {"float32": 1e-5, "bfloat16": 1e-3}

CFG = dict(vocab_size=64, d_model=32, num_layers=1, num_heads=2, max_len=256)
ENGINE = dict(page_size=8, max_slots=4, steps_per_call=4)
MAX_NEW = 10


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


# ---------------------------------------------------------------------------
# K4-int8 / K5-int8: plain version vs JAX's Pallas kernels
# ---------------------------------------------------------------------------

def _int8_inputs(dtype: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, HD)).astype(np.float32) * 0.25
    if dtype == "bfloat16":  # both sides start from the same bf16 values
        q = np.array(jnp.asarray(q, jnp.bfloat16).astype(jnp.float32))
    pk = rng.integers(-127, 128, (NUM_PAGES, PS, H, HD), dtype=np.int8)
    pv = rng.integers(-127, 128, (NUM_PAGES, PS, H, HD), dtype=np.int8)
    sk = rng.uniform(0.001, 0.05, NUM_PAGES).astype(np.float32)
    sv = rng.uniform(0.001, 0.05, NUM_PAGES).astype(np.float32)
    tables = rng.permutation(np.arange(1, NUM_PAGES)).reshape(B, P).astype(np.int32)
    return q, pk, pv, sk, sv, tables, LENGTHS


def _port_int8(dtype, q, pk, pv, sk, sv, tables, lengths):
    t = torch.from_numpy
    out = kernels.paged_attention_decode(t(q).to(getattr(torch, dtype)), t(pk), t(pv), t(tables), t(lengths),
                                         page_size=PS, kv_scales=(t(sk), t(sv)))
    return [o.numpy() for o in out]


@pytest.fixture(scope="module")
def jax_int8_cases():
    """JAX's result per (impl, dtype): the Pallas interpret runs take seconds."""
    out = {}
    for impl in ("stream", "grid"):
        with _env(SELDON_TPU_PAGED_KERNEL_IMPL=impl):
            for dtype in ("float32", "bfloat16"):
                q, pk, pv, sk, sv, tables, lengths = inputs = _int8_inputs(dtype)
                res = jax_kernels.paged_attention_decode(
                    jnp.asarray(q, getattr(jnp, dtype)), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(tables),
                    jnp.asarray(lengths), page_size=PS, kv_scales=(jnp.asarray(sk), jnp.asarray(sv)))
                out[impl, dtype] = (inputs, [np.asarray(r, np.float32) for r in res])
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["stream", "grid"])
def test_int8_plain_version_matches_jax_kernel(jax_int8_cases, impl, dtype, monkeypatch):
    monkeypatch.setenv("SELDON_TPU_PAGED_KERNEL_IMPL", impl)
    inputs, ref = jax_int8_cases[impl, dtype]
    assert_flash_state_close(_port_int8(dtype, *inputs), ref, TOL[dtype])


def test_int8_pages_are_the_dequantised_native_pages(jax_int8_cases):
    """An int8 page with scale s reads as the float32 page ``int8 * s``."""
    (q, pk, pv, sk, sv, tables, lengths), _ = jax_int8_cases["stream", "float32"]
    got = _port_int8("float32", q, pk, pv, sk, sv, tables, lengths)
    deq_k = pk.astype(np.float32) * sk[:, None, None, None]
    deq_v = pv.astype(np.float32) * sv[:, None, None, None]
    t = torch.from_numpy
    ref = kernels.paged_attention_decode(t(q), t(deq_k), t(deq_v), t(tables), t(lengths), page_size=PS)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r.numpy())


def test_int8_pages_need_scales_and_only_they_take_them():
    q, pk, pv, sk, sv, tables, lengths = (torch.from_numpy(a) for a in _int8_inputs("float32"))
    with pytest.raises(ValueError, match="kv_scales"):
        kernels.paged_attention_decode(q, pk, pv, tables, lengths, page_size=PS)
    with pytest.raises(ValueError, match="kv_scales"):
        kernels.paged_attention_decode(q, pk.float(), pv.float(), tables, lengths, page_size=PS, kv_scales=(sk, sv))
    with pytest.raises(ValueError, match="one scale per page"):
        kernels.paged_attention_decode(q, pk, pv, tables, lengths, page_size=PS, kv_scales=(sk[:-1], sv))


@pytest.mark.parametrize("impl,fold,name", [("stream", False, "paged_decode_stream"),
                                            ("grid", False, "paged_decode_grid"),
                                            ("stream", True, "paged_decode_stream_lora")])
def test_launch_names(impl, fold, name):
    assert kernels.paged_launch_name(impl, False, fold) == name
    assert kernels.paged_launch_name(impl, True, fold) == name.replace(impl, impl + "_int8")
    assert set(kernels.launch_counts()) >= {name, kernels.paged_launch_name(impl, True, fold)}


# ---------------------------------------------------------------------------
# the quantising pool write vs JAX's write_kv on (pages, scales) bundles
# ---------------------------------------------------------------------------

L, WB, WH, WHD = 2, 3, 2, 4  # layers, rows, heads, head_dim of the write checks
W_PAGES = 12


def _write_case(seed):
    rng = np.random.default_rng(seed)
    tables = np.zeros((WB, 4), np.int32)
    ids = rng.permutation(np.arange(1, W_PAGES))[: WB * 3].reshape(WB, 3)
    tables[:, :3] = ids  # the 4th column unallocated: page 0
    return rng, tables


def _both_write(pool, new_k, new_v, tables, start, valid, from_zero):
    """Write through the port and through JAX from the same pool state."""
    (pk, sk), (pv, sv) = pool
    t = torch.from_numpy
    port_pk, port_sk, port_pv, port_sv = (t(a.copy()) for a in (pk, sk, pv, sv))
    paged.write_kv((port_pk, port_sk), (port_pv, port_sv), t(new_k), t(new_v), t(tables), t(start),
                   None if valid is None else t(valid), page_size=PS, max_len=4 * PS, from_zero=from_zero)
    (jpk, jsk), (jpv, jsv) = jax_paged.write_kv(
        (jnp.asarray(pk), jnp.asarray(sk)), (jnp.asarray(pv), jnp.asarray(sv)), jnp.asarray(new_k),
        jnp.asarray(new_v), jnp.asarray(tables), jnp.asarray(start), None if valid is None else jnp.asarray(valid),
        page_size=PS, max_len=4 * PS, from_zero=from_zero)
    port = [a.numpy() for a in (port_pk, port_sk, port_pv, port_sv)]
    ref = [np.asarray(a) for a in (jpk, jsk, jpv, jsv)]
    return port, ref


def _assert_pools_agree(port, ref, live_pages):
    """Pages and scales of every live page: scales within 1e-6 relative,
    int8 values equal (no f32 tie arises at these seeds: none is allowed).
    Trash page 0 is excluded: which of several writes lands there is
    unspecified."""
    for name, g, r in zip(("pk", "sk", "pv", "sv"), port, ref):
        g, r = g[:, live_pages], r[:, live_pages]
        if g.dtype == np.int8:
            np.testing.assert_array_equal(g, r, err_msg=name)
        else:
            np.testing.assert_allclose(g, r, rtol=1e-6, atol=0, err_msg=name)


def _empty_pool():
    shape = (L, W_PAGES, PS, WH, WHD)
    return ((np.zeros(shape, np.int8), np.zeros((L, W_PAGES), np.float32)),
            (np.zeros(shape, np.int8), np.zeros((L, W_PAGES), np.float32)))


@pytest.mark.parametrize("seg", [PS, 13, 3 * PS])
def test_int8_prefill_write_matches_jax(seg):
    rng, tables = _write_case(seg)
    new_k = rng.normal(size=(L, WB, seg, WH, WHD)).astype(np.float32)
    new_v = rng.normal(size=(L, WB, seg, WH, WHD)).astype(np.float32) * 3.0
    start = np.zeros((WB,), np.int32)
    port, ref = _both_write(_empty_pool(), new_k, new_v, tables, start, None, from_zero=True)
    live = tables[:, : -(-seg // PS)].reshape(-1)
    _assert_pools_agree(port, ref, live)
    # the pad tokens of a partial last page are zero, and its scale is
    # that of the live tokens alone
    if seg % PS:
        last = tables[0, seg // PS]
        assert (port[0][:, last, seg % PS:] == 0).all()
        amax = np.abs(new_k[:, 0, (seg // PS) * PS:]).max(axis=(1, 2, 3))
        np.testing.assert_allclose(port[1][:, last], amax / 127.0, rtol=1e-6)


def test_int8_decode_writes_match_jax_step_by_step():
    """A prefill of 11 tokens, then 14 decode writes per row (crossing a
    page boundary, a row writing the trash page) from the same state: the
    read-modify-write requantisation agrees with JAX's after every step."""
    rng, tables = _write_case(7)
    seg = 11
    pool = _empty_pool()
    # a recycled page: stale values left over in the rows' pages
    (pk, sk), (pv, sv) = pool
    pk[:] = rng.integers(-127, 128, pk.shape, dtype=np.int8)
    pv[:] = rng.integers(-127, 128, pv.shape, dtype=np.int8)
    sk[:] = rng.uniform(0.5, 2.0, sk.shape)
    sv[:] = rng.uniform(0.5, 2.0, sv.shape)
    new = [rng.normal(size=(L, WB, seg, WH, WHD)).astype(np.float32) for _ in range(2)]
    port, ref = _both_write(pool, *new, tables, np.zeros((WB,), np.int32), None, from_zero=True)
    _assert_pools_agree(port, ref, tables[:, :2].reshape(-1))
    start = np.array([seg, seg - 3, seg], np.int32)
    for step in range(14):
        state = ((ref[0], ref[1]), (ref[2], ref[3]))  # both sides continue from JAX's pool
        new = [rng.normal(size=(L, WB, 1, WH, WHD)).astype(np.float32) * (1 + step) for _ in range(2)]
        valid = np.array([[True], [True], [step % 3 != 0]])
        port, ref = _both_write(state, *new, tables, start, valid, from_zero=False)
        _assert_pools_agree(port, ref, tables[:, :3].reshape(-1))
        start = start + 1


def test_kv_split_and_join_round_trip():
    pages, scales = torch.zeros(2, 3, dtype=torch.int8), torch.ones(2)
    assert paged.kv_split(paged.kv_join(pages, scales)) == (pages, scales)
    assert paged.kv_split(paged.kv_join(pages, None)) == (pages, None)


# ---------------------------------------------------------------------------
# the int8 engine against the JAX int8 engine
# ---------------------------------------------------------------------------

def _prompts():
    rng = np.random.default_rng(5)
    return [rng.integers(0, CFG["vocab_size"], size=(n,)).astype(np.int32) for n in (14, 7, 25, 8, 17, 33)]


@pytest.fixture(scope="module")
def flax_params():
    lm = FlaxTransformerLM(dtype=jnp.float32, **CFG)
    return lm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]


@pytest.fixture(scope="module")
def jax_int8_tokens(flax_params):
    out = {}
    for lane in ("force", "0"):
        with _env(SELDON_TPU_PAGED_KERNEL=lane, SELDON_TPU_CHUNK_IMPL="pool", SELDON_TPU_KV_DTYPE="int8"):
            eng = jax_paged.PagedEngine(flax_params, dtype=jnp.float32, prefix_cache=False, **CFG, **ENGINE)
            assert eng._kv_int8 and eng._kernel_active == (lane == "force")
            streams = [eng.submit(p, max_new_tokens=MAX_NEW) for p in _prompts()]
            eng.run()
            eng.close()
        out[lane] = np.stack([s.result for s in streams])
    return out


def _port_engine(flax_params, monkeypatch, lane, **kw):
    monkeypatch.setenv("SELDON_TPU_PAGED_KERNEL", lane)
    monkeypatch.setenv("SELDON_TPU_CHUNK_IMPL", "pool")  # the int8 pool is the pool chunk's, as in JAX
    monkeypatch.setenv("SELDON_TPU_KV_DTYPE", "int8")
    return PagedEngine(lm_params_from_flax(flax_params), dtype="float32", device="cpu", **CFG,
                       **{**ENGINE, "prefix_cache": False, **kw})


@pytest.mark.parametrize("lane", ["force", "0"])
def test_int8_engine_greedy_tokens_equal_the_jax_int8_engine(flax_params, jax_int8_tokens, monkeypatch, lane):
    eng = _port_engine(flax_params, monkeypatch, lane)
    assert eng._kv_int8 and eng._kernel_active == (lane == "force")
    streams = [eng.submit(p, max_new_tokens=MAX_NEW) for p in _prompts()]
    eng.run()
    np.testing.assert_array_equal(np.stack([s.result for s in streams]), jax_int8_tokens[lane])


def test_int8_kernel_and_gather_lanes_agree(jax_int8_tokens):
    """Same quantised pool, two readers (in-register vs after-fetch dequant)."""
    np.testing.assert_array_equal(jax_int8_tokens["force"], jax_int8_tokens["0"])


def test_int8_pool_shapes_and_stats(flax_params, monkeypatch):
    eng = _port_engine(flax_params, monkeypatch, "force")
    assert eng.pages_k.dtype == eng.pages_v.dtype == torch.int8
    assert tuple(eng.scales_k.shape) == tuple(eng.scales_v.shape) == (CFG["num_layers"], eng.num_pages)
    assert eng.scales_k.dtype == torch.float32
    assert eng.engine_stats()["kv_dtype_int8"] == 1
    monkeypatch.setenv("SELDON_TPU_KV_DTYPE", "bf16")
    native = PagedEngine(lm_params_from_flax(flax_params), dtype="bfloat16", device="cpu", **CFG, **ENGINE)
    assert native.pages_k.dtype == torch.bfloat16 and native.scales_k is None
    assert native.engine_stats()["kv_dtype_int8"] == 0
    assert 2 * eng.pages_k.nbytes == native.pages_k.nbytes  # half the pool bytes


def test_int8_pool_warns_and_keeps_the_native_pool_under_a_mesh(monkeypatch, caplog):
    monkeypatch.setenv("SELDON_TPU_KV_DTYPE", "int8")
    with caplog.at_level(logging.WARNING, logger=paged.logger.name):
        assert paged.paged_kv_int8(False, "pool") is False
    assert "keeping the native pool dtype" in caplog.text
    assert paged.paged_kv_int8(True, "pool") is True
    monkeypatch.setenv("SELDON_TPU_KV_DTYPE", "bf16")
    assert paged.paged_kv_int8(True, "pool") is False


def test_streaminglm_serves_an_int8_pool(monkeypatch):
    monkeypatch.setenv("SELDON_TPU_KV_DTYPE", "int8")
    monkeypatch.setenv("SELDON_TPU_PAGED_KERNEL", "force")
    lm = StreamingLM(device="cpu", dtype="float32", **CFG, **ENGINE)
    lm.load()
    try:
        out = lm.predict(np.asarray([_prompts()[0]]), [], meta={"tags": {"max_new_tokens": 4}})
        assert out.shape == (1, 4)
        assert lm.health_status()["kv_dtype"] == "int8"
        metrics = {m["key"]: m["value"] for m in lm.metrics() if not m.get("tags")}
        assert metrics["paged_kv_dtype_int8"] == 1
    finally:
        lm.unload()
