"""The port's multi-LoRA serving against the JAX package's.

* ``lora_delta``, ``make_lora_params``, ``merge_lora``, the weight
  registry and the adapter carriers against their JAX counterparts;
* ``LoraPool.install`` validating every target before its first write;
* the LoRA fold of K4's plain version against JAX's stream kernel with
  ``lora`` in interpret mode, native and int8 pages: acc / m / l within
  1e-5 of the largest entry, the delta within 1e-5 relative, slot-0 lanes'
  delta exactly 0;
* a mixed-adapter engine against the JAX engine with the same adapters
  (float32, greedy tokens equal), against the offline-merged weights
  served with no adapter, and the fold against the einsum lanes;
* the adapter table's status codes (400 / 404 / 409 / 503), its LRU
  reload and its exactly-once release;
* ``StreamingLM`` selecting the adapter by body tag and by the
  ``X-Seldon-Adapter`` header (the body tag wins).

The tiny config of ``test_torch_port_paged_engine.py``, rank 2.
"""

import asyncio
import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.models import paged as jax_paged
from seldon_core_tpu.models import registry as jax_registry
from seldon_core_tpu.models.transformer import TransformerLM as FlaxTransformerLM
from seldon_core_tpu.ops import kernels as jax_kernels
from seldon_core_tpu.ops import lora as jax_lora
from seldon_core_tpu.utils import deadlines as jax_deadlines
from seldon_core_tpu_torch.models import registry
from seldon_core_tpu_torch.models.convert import lm_params_from_flax
from seldon_core_tpu_torch.models.paged import PagedEngine, StreamingLM
from seldon_core_tpu_torch.ops import kernels, lora
from seldon_core_tpu_torch.runtime import rest
from seldon_core_tpu_torch.runtime.component import MicroserviceError
from seldon_core_tpu_torch.utils import deadlines

from test_torch_port_paged_kernel import assert_flash_state_close

CFG = dict(vocab_size=64, d_model=32, num_layers=1, num_heads=2, max_len=256)
ENGINE = dict(page_size=8, max_slots=4, steps_per_call=4)
RANK = 2
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


def _adapters():
    return {f"t{i}": lora.make_lora_params(100 + i, num_layers=CFG["num_layers"], d_model=CFG["d_model"], rank=RANK)
            for i in range(2)}


def _prompts():
    rng = np.random.default_rng(5)
    return [rng.integers(0, CFG["vocab_size"], size=(n,)).astype(np.int32) for n in (14, 7, 25, 8, 17, 33)]


# which adapter each prompt decodes with: a mixed wave, base lanes included
MIX = ["t1", "t0", None, "t1", "t0", None]


# ---------------------------------------------------------------------------
# the module's functions against JAX's
# ---------------------------------------------------------------------------

def test_make_lora_params_equals_jax_bit_for_bit():
    for seed, alpha in ((1, 8.0), (7, 3.0)):
        port = lora.make_lora_params(seed, num_layers=2, d_model=16, rank=4, alpha=alpha)
        ref = jax_lora.make_lora_params(seed, num_layers=2, d_model=16, rank=4, alpha=alpha)
        assert list(port) == list(ref) == list(lora.LORA_TARGETS)
        for t in port:
            for p, r in zip(port[t], ref[t]):
                assert p.dtype == r.dtype == np.float32
                np.testing.assert_array_equal(p, r)
    assert lora.target_dims(32) == jax_lora.target_dims(32)
    assert lora.adapter_bytes(port) == jax_lora.adapter_bytes(ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lora_delta_matches_jax(dtype):
    rng = np.random.default_rng(3)
    slots, d_in, d_out, r = 3, 16, 24, 4
    x = rng.normal(size=(5, 2, d_in)).astype(np.float32)
    a = rng.normal(size=(slots, d_in, r)).astype(np.float32)
    b = rng.normal(size=(slots, r, d_out)).astype(np.float32)
    a[0] = b[0] = 0
    idx = np.array([0, 1, 2, 1, 0], np.int32)
    if dtype == "bfloat16":
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    got = lora.lora_delta(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(a), torch.from_numpy(b),
                          torch.from_numpy(idx))
    ref = jax_lora.lora_delta(jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(a), jnp.asarray(b), jnp.asarray(idx))
    assert got.dtype == getattr(torch, dtype)
    got, ref = got.float().numpy(), np.asarray(ref, np.float32)
    assert (got[idx == 0] == 0).all()
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * np.abs(ref).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lora_delta_of_a_prefill_group_is_each_row_alone(dtype):
    """A row's delta in a multi-row segment is the same bits as the row
    alone, so a stream's prefill does not depend on its group."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(4, 6, 16)).astype(np.float32)).to(getattr(torch, dtype))
    a = torch.from_numpy(rng.normal(size=(3, 16, 4)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(3, 4, 8)).astype(np.float32))
    a[0] = b[0] = 0
    idx = torch.tensor([2, 0, 1, 2], dtype=torch.int32)
    group = lora.lora_delta(x, a, b, idx)
    for i in range(4):
        assert torch.equal(group[i:i + 1], lora.lora_delta(x[i:i + 1], a, b, idx[i:i + 1]))
    assert (group[1] == 0).all()


def test_merge_lora_matches_jax():
    lm = FlaxTransformerLM(dtype=jnp.float32, **CFG)
    flax_params = lm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    adapter = _adapters()["t0"]
    port = lora.merge_lora(lm_params_from_flax(flax_params), adapter, CFG["num_layers"])
    ref = lm_params_from_flax(jax_lora.merge_lora(flax_params, adapter, CFG["num_layers"]))
    assert set(port) == set(ref)
    for key in ref:
        np.testing.assert_allclose(port[key].numpy(), ref[key].numpy(), rtol=1e-6, atol=1e-7, err_msg=key)
    base = lm_params_from_flax(flax_params)
    assert not torch.equal(port["blocks.0.qkv.weight"], base["blocks.0.qkv.weight"])
    assert torch.equal(port["head.weight"], base["head.weight"])


def test_lora_pool_install_validates_before_writing():
    pool = lora.LoraPool(num_layers=1, d_model=CFG["d_model"], max_adapters=2, rank=RANK)
    good = _adapters()["t0"]
    assert pool.slots == 3
    assert pool.hbm_bytes() == 3 * sum(4 * (d_in + d_out) * RANK for d_in, d_out in lora.target_dims(32).values())
    partial = {t: good[t] for t in ("qkv", "attn_proj", "mlp_in")}
    wrong_rank = lora.make_lora_params(1, num_layers=1, d_model=CFG["d_model"], rank=RANK + 1)
    for bad, match in ((partial, "missing factors for target 'mlp_out'"), (wrong_rank, "do not fit")):
        with pytest.raises(ValueError, match=match):
            pool.install(1, bad)
        assert all(bool((f[:, 1] == 0).all()) for ab in pool.buffers.values() for f in ab), "slot written"
    for slot in (0, 3):
        with pytest.raises(ValueError, match="out of range"):
            pool.install(slot, good)
    pool.install(2, good)
    for t, (a, b) in pool.device_args().items():
        np.testing.assert_array_equal(a[:, 2].numpy(), good[t][0])
        np.testing.assert_array_equal(b[:, 2].numpy(), good[t][1])
        assert (a[:, 0] == 0).all() and (b[:, 0] == 0).all() and (a[:, 1] == 0).all()


def _registry_script(mod):
    """One sequence of registry calls; returns what each step reports."""
    reg = mod.WeightRegistry(budget_bytes=3000)
    sizes = {"a": 1000, "b": 1500, "c": 1200}
    for name, n in sizes.items():
        reg.register(name, (lambda n=n: {"w": np.zeros(n // 4, np.float32)}), bytes_hint=n)
    out = [reg.known("a"), reg.known("zz")]
    reg.acquire("a")
    reg.acquire("b")
    reg.release("a")
    reg.acquire("c")  # evicts the cached "a"
    out.append(reg.stats())
    for call in (lambda: reg.acquire("zz"), lambda: reg.unregister("b"), lambda: reg.acquire("a")):
        try:
            call()
            out.append(None)
        except Exception as exc:  # noqa: BLE001 — both sides' errors are compared
            out.append((getattr(exc, "status_code", None), getattr(exc, "reason", None)))
    reg.release("b")
    reg.release("c")
    reg.acquire("a")  # reclaims the oldest cached set
    out.append(reg.stats())
    return out


def test_weight_registry_behaves_as_jax():
    assert _registry_script(registry) == _registry_script(jax_registry)


@pytest.mark.parametrize("carrier", [{"X-Seldon-Adapter": " a1 "}, {"x-seldon-adapter": "a2"},
                                     [("X-SELDON-ADAPTER", "a3")], {"X-Seldon-Adapter": ""}, {}, None,
                                     {"x-seldon-adapter": "n" * 300}])
def test_adapter_carriers_match_jax(carrier):
    assert deadlines.extract_adapter(carrier) == jax_deadlines.extract_adapter(carrier)
    assert deadlines.ADAPTER_HEADER == jax_deadlines.ADAPTER_HEADER
    raw = None if carrier is None or not carrier else (carrier[0][1] if isinstance(carrier, list)
                                                       else next(iter(carrier.values())))
    assert deadlines.normalize_adapter(raw) == jax_deadlines.normalize_adapter(raw)


# ---------------------------------------------------------------------------
# K4-LoRA: the fold of the plain version vs JAX's stream kernel
# ---------------------------------------------------------------------------

B, H, HD, PS, P = 7, 2, 16, 8, 5
NUM_PAGES = B * P + 1
LENGTHS = np.array([0, 1, PS, PS + 1, P * PS, 23, P * PS + 3], np.int32)
SLOTS = 3


def _fold_inputs(quantized: bool, seed: int = 0):
    rng = np.random.default_rng(seed)
    D = H * HD
    q = rng.normal(size=(B, H, HD)).astype(np.float32) * 0.25
    if quantized:
        pk, pv = (rng.integers(-127, 128, (NUM_PAGES, PS, H, HD), dtype=np.int8) for _ in range(2))
        scales = tuple(rng.uniform(0.001, 0.05, NUM_PAGES).astype(np.float32) for _ in range(2))
    else:
        pk, pv = (rng.normal(size=(NUM_PAGES, PS, H, HD)).astype(np.float32) for _ in range(2))
        scales = None
    tables = rng.permutation(np.arange(1, NUM_PAGES)).reshape(B, P).astype(np.int32)
    x = rng.normal(size=(B, D)).astype(np.float32)
    a = (rng.normal(size=(SLOTS, D, RANK)) / np.sqrt(D)).astype(np.float32)
    b = (rng.normal(size=(SLOTS, RANK, 3 * D)) / np.sqrt(RANK)).astype(np.float32)
    a[0] = b[0] = 0  # slot 0: the zero adapter
    idx = np.array([i % SLOTS for i in range(B)], np.int32)
    return q, pk, pv, scales, tables, x, a, b, idx


@pytest.fixture(scope="module")
def jax_fold_cases():
    out = {}
    with _env(SELDON_TPU_PAGED_KERNEL_IMPL="stream"):
        for quantized in (False, True):
            q, pk, pv, scales, tables, x, a, b, idx = inputs = _fold_inputs(quantized)
            res = jax_kernels.paged_attention_decode(
                jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(tables), jnp.asarray(LENGTHS),
                page_size=PS, kv_scales=None if scales is None else tuple(map(jnp.asarray, scales)),
                lora=(jnp.asarray(x), jnp.swapaxes(jnp.asarray(a), -1, -2), jnp.asarray(b), jnp.asarray(idx),
                      HD ** -0.5))
            out[quantized] = (inputs, [np.asarray(r, np.float32) for r in res])
    return out


def _port_fold(q, pk, pv, scales, tables, x, a, b, idx):
    t = torch.from_numpy
    return kernels.paged_attention_decode(
        t(q), t(pk), t(pv), t(tables), t(LENGTHS), page_size=PS,
        kv_scales=None if scales is None else tuple(map(t, scales)), lora=(t(x), t(a), t(b), t(idx), HD ** -0.5))


@pytest.mark.parametrize("quantized", [False, True], ids=["native", "int8"])
def test_fold_plain_version_matches_jax_kernel(jax_fold_cases, quantized, monkeypatch):
    monkeypatch.setenv("SELDON_TPU_PAGED_KERNEL_IMPL", "stream")
    inputs, ref = jax_fold_cases[quantized]
    got = [o.numpy() for o in _port_fold(*inputs)]
    assert len(got) == len(ref) == 4
    assert_flash_state_close(got[:3], ref[:3], 1e-5)
    delta, ref_delta = got[3], ref[3]
    assert delta.shape == (B, 3 * H * HD) and delta.dtype == np.float32
    idx = inputs[-1]
    assert (delta[idx == 0] == 0).all() and (ref_delta[idx == 0] == 0).all()
    live = idx != 0
    assert np.abs(delta[live] - ref_delta[live]).max() <= 1e-5 * np.abs(ref_delta[live]).max()


def test_fold_moves_q_by_its_delta(jax_fold_cases, monkeypatch):
    """The fold scores with ``q + q_scale * delta_q``: the same state as
    the plain call on that query."""
    monkeypatch.setenv("SELDON_TPU_PAGED_KERNEL_IMPL", "stream")
    (q, pk, pv, scales, tables, x, a, b, idx), _ = jax_fold_cases[False]
    acc, m, l, delta = _port_fold(q, pk, pv, scales, tables, x, a, b, idx)
    q2 = torch.from_numpy(q) + HD ** -0.5 * delta[:, : H * HD].reshape(B, H, HD)
    t = torch.from_numpy
    ref = kernels.paged_attention_decode(q2, t(pk), t(pv), t(tables), t(LENGTHS), page_size=PS)
    for g, r in zip((acc, m, l), ref):
        assert torch.equal(g, r)


def test_fold_on_the_grid_impl_raises(monkeypatch):
    monkeypatch.setenv("SELDON_TPU_PAGED_KERNEL_IMPL", "grid")
    with pytest.raises(ValueError, match="stream-impl feature"):
        _port_fold(*_fold_inputs(False))


def test_fold_checks_its_shapes(monkeypatch):
    monkeypatch.setenv("SELDON_TPU_PAGED_KERNEL_IMPL", "stream")
    q, pk, pv, scales, tables, x, a, b, idx = _fold_inputs(False)
    with pytest.raises(ValueError, match="lora x"):
        _port_fold(q, pk, pv, scales, tables, x[:, :-1], a, b, idx)
    with pytest.raises(ValueError, match="lora B"):
        _port_fold(q, pk, pv, scales, tables, x, a, b[:, :, :-1], idx)


# ---------------------------------------------------------------------------
# engines with adapters
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def flax_params():
    lm = FlaxTransformerLM(dtype=jnp.float32, **CFG)
    return lm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]


@pytest.fixture(scope="module")
def params(flax_params):
    return lm_params_from_flax(flax_params)


def _registry(mod, adapters):
    reg = mod.WeightRegistry(budget_bytes=0)
    for name, ad in adapters.items():
        reg.register(name, (lambda a=ad: a), bytes_hint=lora.adapter_bytes(ad))
    return reg


@pytest.fixture(scope="module")
def jax_mixed_tokens(flax_params):
    with _env(SELDON_TPU_PAGED_KERNEL="force", SELDON_TPU_CHUNK_IMPL="pool", SELDON_TPU_PAGED_KERNEL_IMPL="stream"):
        eng = jax_paged.PagedEngine(flax_params, dtype=jnp.float32, prefix_cache=False, max_adapters=2,
                                    lora_rank=RANK, weight_registry=_registry(jax_registry, _adapters()),
                                    **CFG, **ENGINE)
        streams = [eng.submit(p, max_new_tokens=MAX_NEW, adapter=a) for p, a in zip(_prompts(), MIX)]
        eng.run()
        eng.close()
    return np.stack([s.result for s in streams])


def _engine(params, monkeypatch, lane="force", impl="stream", **kw):
    monkeypatch.setenv("SELDON_TPU_PAGED_KERNEL", lane)
    monkeypatch.setenv("SELDON_TPU_CHUNK_IMPL", "pool")  # the JAX engines' chunk, on either lane
    monkeypatch.setenv("SELDON_TPU_PAGED_KERNEL_IMPL", impl)
    kw = {"max_adapters": 2, "lora_rank": RANK, "weight_registry": _registry(registry, _adapters()), **kw}
    return PagedEngine(params, dtype="float32", device="cpu", **CFG, **{**ENGINE, "prefix_cache": False, **kw})


def _mixed(eng, mix=MIX):
    streams = [eng.submit(p, max_new_tokens=MAX_NEW, adapter=a) for p, a in zip(_prompts(), mix)]
    eng.run()
    return np.stack([s.result for s in streams])


@pytest.fixture(scope="module")
def port_mixed_tokens(params):
    mp = pytest.MonkeyPatch()
    try:
        return _mixed(_engine(params, mp))
    finally:
        mp.undo()


def test_mixed_adapter_engine_equals_the_jax_engine(jax_mixed_tokens, port_mixed_tokens):
    np.testing.assert_array_equal(port_mixed_tokens, jax_mixed_tokens)


def test_adapters_change_the_tokens(params, port_mixed_tokens, monkeypatch):
    base = _mixed(_engine(params, monkeypatch), mix=[None] * 6)
    for i, a in enumerate(MIX):
        assert np.array_equal(base[i], port_mixed_tokens[i]) == (a is None), i


@pytest.mark.parametrize("lane,impl", [("0", "stream"), ("force", "grid")], ids=["gather", "grid-einsum"])
def test_fold_and_einsum_lanes_give_the_same_tokens(params, port_mixed_tokens, monkeypatch, lane, impl):
    np.testing.assert_array_equal(_mixed(_engine(params, monkeypatch, lane=lane, impl=impl)), port_mixed_tokens)


def test_the_kernel_lane_folds_the_qkv_delta(params, monkeypatch):
    calls = []
    real = kernels.paged_attention_decode

    def spy(*args, **kw):
        calls.append(kw.get("lora") is not None)
        return real(*args, **kw)

    monkeypatch.setattr(kernels, "paged_attention_decode", spy)
    eng = _engine(params, monkeypatch)
    eng.generate(_prompts()[0], max_new_tokens=3, adapter="t0")
    assert calls and all(calls)


@pytest.mark.parametrize("name", ["t0", "t1"])
def test_adapter_equals_the_merged_weights_served_without_one(params, port_mixed_tokens, monkeypatch, name):
    merged = lora.merge_lora(params, _adapters()[name], CFG["num_layers"])
    eng = _engine(merged, monkeypatch, max_adapters=0, weight_registry=None)
    rows = [i for i, a in enumerate(MIX) if a == name]
    got = np.stack([eng.generate(_prompts()[i], max_new_tokens=MAX_NEW) for i in rows])
    np.testing.assert_array_equal(got, port_mixed_tokens[rows])


def _status(call):
    with pytest.raises(MicroserviceError) as err:
        call()
    return err.value.status_code, err.value.reason


def test_adapter_status_codes(params, monkeypatch):
    off = _engine(params, monkeypatch, max_adapters=0, weight_registry=None)
    assert _status(lambda: off.submit(_prompts()[0], adapter="t0")) == (400, "ADAPTERS_DISABLED")
    eng = _engine(params, monkeypatch, max_adapters=1)
    assert _status(lambda: eng.submit(_prompts()[0], adapter="nope")) == (404, "ADAPTER_UNKNOWN")
    wrong = lora.make_lora_params(1, num_layers=1, d_model=CFG["d_model"], rank=RANK + 1)
    assert _status(lambda: eng.load_adapter("wrong", wrong)) == (400, "ADAPTER_INCOMPATIBLE")
    assert eng.adapter_stats()["resident"] == [] and eng._adapter_free == [1]  # the slot came back untouched
    held = eng.submit(_prompts()[0], max_new_tokens=2, adapter="t0")  # pins the only slot
    assert _status(lambda: eng.unload_adapter("t0")) == (409, "ADAPTER_IN_USE")
    assert _status(lambda: eng.submit(_prompts()[1], adapter="t1")) == (503, "ADAPTERS_EXHAUSTED")
    eng.run()
    assert held.result.shape == (2,)
    eng.unload_adapter("t0")
    assert eng.adapter_stats()["resident"] == []


def test_lru_reload_and_exactly_once_release(params, port_mixed_tokens, monkeypatch):
    eng = _engine(params, monkeypatch, max_adapters=1)
    first = eng.generate(_prompts()[0], max_new_tokens=MAX_NEW, adapter="t1")
    np.testing.assert_array_equal(first, port_mixed_tokens[0])
    eng.generate(_prompts()[1], max_new_tokens=MAX_NEW, adapter="t0")  # evicts the parked t1
    again = eng.generate(_prompts()[0], max_new_tokens=MAX_NEW, adapter="t1")  # reloads it
    np.testing.assert_array_equal(again, first)
    s = eng.engine_stats()
    assert (s["adapter_loads"], s["adapter_misses"], s["adapter_evictions"], s["adapter_hits"]) == (3, 3, 2, 0)
    eng.generate(_prompts()[2], max_new_tokens=2, adapter="t1")
    assert eng.engine_stats()["adapter_hits"] == 1
    # finish, cancel (queued and running) and fail_all each drop the pin once
    a, b = (eng.submit(p, max_new_tokens=MAX_NEW, adapter="t1") for p in _prompts()[:2])
    assert int(eng._adapter_ref[1]) == 2
    eng.cancel(b)
    eng.cancel(b)
    assert int(eng._adapter_ref[1]) == 1
    eng.step()
    eng.cancel(a)
    eng.step()
    assert a.event.is_set() and int(eng._adapter_ref[1]) == 0
    c = eng.submit(_prompts()[3], max_new_tokens=MAX_NEW, adapter="t1")
    eng.step()
    eng.fail_all(RuntimeError("boom"))
    eng.fail_all(RuntimeError("again"))
    assert c.error is not None and int(eng._adapter_ref[1]) == 0
    assert eng.adapter_stats()["resident"] == [{"name": "t1", "slot": 1, "refcount": 0, "cached": True}]


def test_max_adapters_knob(params, monkeypatch):
    monkeypatch.setenv("SELDON_TPU_MAX_ADAPTERS", "3")
    eng = _engine(params, monkeypatch, max_adapters=0)
    assert eng.max_adapters == 3 and eng.adapter_stats()["enabled"]
    monkeypatch.delenv("SELDON_TPU_MAX_ADAPTERS")
    assert _engine(params, monkeypatch, max_adapters=0, weight_registry=None).max_adapters == 0


# ---------------------------------------------------------------------------
# StreamingLM: the adapter catalogue, the tag and the header
# ---------------------------------------------------------------------------

def test_streaminglm_adapter_by_tag_and_header(monkeypatch):
    monkeypatch.setenv("SELDON_TPU_PAGED_KERNEL", "force")
    monkeypatch.setenv("SELDON_TPU_PAGED_KERNEL_IMPL", "stream")
    # names unique to this test: the catalogue registers in the process registry
    lm = StreamingLM(device="cpu", dtype="float32", max_adapters=2, lora_rank=RANK, seed=1,
                     adapters='{"tag-a1": {"seed": 1}, "tag-a2": {"seed": 2, "alpha": 1.0}}', **CFG, **ENGINE)
    lm.load()
    prompt = _prompts()[0].tolist()
    try:
        ref = {name: lm.engine.generate(np.asarray(prompt), max_new_tokens=4, adapter=name).tolist()
               for name in (None, "tag-a1", "tag-a2")}

        async def scenario():
            from aiohttp.test_utils import TestClient, TestServer

            client = TestClient(TestServer(rest.build_app(lm)))
            await client.start_server()
            try:
                out = []
                for tags, headers in (({}, {}), ({"adapter": "tag-a1"}, {}), ({}, {"X-Seldon-Adapter": "tag-a2"}),
                                      ({"adapter": "tag-a1"}, {"X-Seldon-Adapter": "tag-a2"}),
                                      ({}, {"X-Seldon-Adapter": "missing"})):
                    body = {"data": {"ndarray": [prompt]}, "meta": {"tags": {"max_new_tokens": 4, **tags}}}
                    resp = await client.post("/predict", json=body, headers=headers)
                    out.append((resp.status, await resp.json()))
                metrics = await (await client.get("/metrics")).text()
                return out, metrics
            finally:
                await client.close()

        out, metrics = asyncio.run(scenario())
        rows = [body["data"]["ndarray"][0] if status == 200 else (status, body["status"]["reason"])
                for status, body in out]
        assert rows == [ref[None], ref["tag-a1"], ref["tag-a2"], ref["tag-a1"], (404, "ADAPTER_UNKNOWN")]
        assert ref["tag-a1"] != ref[None] and ref["tag-a2"] != ref[None]
        # {"seed": n, "alpha": a} loads make_lora_params(n, alpha=a)
        slot = lm.engine._adapter_table["tag-a2"]
        want = lora.make_lora_params(2, num_layers=1, d_model=CFG["d_model"], rank=RANK, alpha=1.0)
        for t, (a, b) in lm.engine._lora.buffers.items():
            np.testing.assert_array_equal(b[:, slot].numpy(), want[t][1])
        assert "paged_adapter_loads 2.0" in metrics and "paged_adapters_resident 2.0" in metrics
        assert 'paged_adapter_requests{adapter="tag-a1"}' in metrics
        assert lm.health_status()["adapters"]["max_adapters"] == 2
    finally:
        lm.unload()


def test_streaminglm_raw_factor_adapters_and_uri_refusal(tmp_path):
    raw = lora.make_lora_params(5, num_layers=1, d_model=CFG["d_model"], rank=RANK)
    lm = StreamingLM(device="cpu", dtype="float32", max_adapters=1, lora_rank=RANK, adapters={"raw-a": raw},
                     **CFG, **ENGINE)
    assert lm._adapter_loader(raw)() is raw
    # {"uri": ...} landed (ROADMAP A5): the catalogue takes it, and its
    # loader restores flax's msgpack onto the factor template bit for bit
    StreamingLM(device="cpu", adapters={"u": {"uri": "gs://bucket/a.msgpack"}}, **CFG)
    from flax import serialization

    path = tmp_path / "a.msgpack"
    path.write_bytes(serialization.to_bytes(raw))
    got = lm._adapter_loader({"uri": f"file://{path}"})()
    assert sorted(got) == sorted(raw)
    for t, (a, b) in raw.items():
        assert isinstance(got[t], tuple)
        np.testing.assert_array_equal(got[t][0], a)
        np.testing.assert_array_equal(got[t][1], b)
