"""The port's generation precision lanes against the JAX engine's.

``PagedEngine(quantize="int8")`` (kernels resting int8, dequantised once
per device call) and ``PagedEngine(precision="w8a8")`` (every
projection and the head int8 x int8 with dynamic per-token activation
scales) against the JAX engine built with the same options, in float32
with the pool chunk and the kernel lane forced (JAX's Pallas kernel in
interpret mode): greedy tokens equal, first-step logits within 1e-4 of
the largest, on both of the port's decode lanes, and for w8a8 with
adapters (the LoRA deltas beside the int8 projections, the qkv one folded
into K4 on the kernel lane).

The lane's own contract: no weight quantised or dequantised inside the
step loop (w8a8 quantises at construction only; int8w dequantises once
per prefill wave and once per chunk), ``int8_lowering_report`` telling
an int8 GEMM from a float one (``tests/test_w8a8.py``'s audit cases) and
reading ``int8`` on a w8a8 decode chunk, the int8 weights' bytes, and
``StreamingLM`` passing both options through.

The config is wider than the other engine tests' (d_model 64), so every
kernel but none of the embeddings rests int8 under the JAX surgery's
4096-element floor.
"""

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
from seldon_core_tpu_torch.models import registry
from seldon_core_tpu_torch.models.convert import lm_params_from_flax
from seldon_core_tpu_torch.models.paged import PagedEngine, StreamingLM
from seldon_core_tpu_torch.ops import lora, w8a8
from seldon_core_tpu_torch.ops.surgery import QuantizedKernel
from seldon_core_tpu_torch.runtime.component import MicroserviceError

CFG = dict(vocab_size=64, d_model=64, num_layers=2, num_heads=2, max_len=128)
ENGINE = dict(page_size=8, max_slots=4, steps_per_call=4)
RANK = 2
MAX_NEW = 8
SIZES = (14, 7, 12, 9)  # one prefill bucket, one chunk horizon: one JAX program each
MIX = ["t1", None, "t0", "t1"]
CASES = {
    "int8": dict(quantize="int8"),
    "w8a8": dict(precision="w8a8"),
    "w8a8+adapters": dict(precision="w8a8", adapters=True),
}


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


def _prompts():
    rng = np.random.default_rng(11)
    return [rng.integers(0, CFG["vocab_size"], size=(n,)).astype(np.int32) for n in SIZES]


def _adapters():
    return {f"t{i}": lora.make_lora_params(200 + i, num_layers=CFG["num_layers"], d_model=CFG["d_model"], rank=RANK)
            for i in range(2)}


def _registry(mod):
    reg = mod.WeightRegistry(budget_bytes=0)
    for name, ad in _adapters().items():
        reg.register(name, (lambda a=ad: a), bytes_hint=lora.adapter_bytes(ad))
    return reg


def _engine_kw(case, mod):
    kw = dict(CASES[case])
    mix = [None] * len(SIZES)
    if kw.pop("adapters", False):
        kw.update(max_adapters=2, lora_rank=RANK, weight_registry=_registry(mod))
        mix = MIX
    return kw, mix


def _drive(eng, mix, logits_of):
    """First-step logits (after the one prefill wave) and greedy tokens."""
    streams = [eng.submit(p, max_new_tokens=MAX_NEW, adapter=a) for p, a in zip(_prompts(), mix)]
    with eng._lock:
        admitted = eng._admit_locked()
    assert [s for s, _ in admitted] == streams
    eng._prefill_streams(streams)
    first = logits_of(eng)[[s.slot for s in streams]]
    eng.run()
    return np.stack([s.result for s in streams]), first


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
    with _env(SELDON_TPU_PAGED_KERNEL="force", SELDON_TPU_CHUNK_IMPL="pool", SELDON_TPU_PAGED_KERNEL_IMPL="stream"):
        for case in CASES:
            kw, mix = _engine_kw(case, jax_registry)
            eng = jax_paged.PagedEngine(flax_params, dtype=jnp.float32, prefix_cache=False, **CFG, **ENGINE, **kw)
            assert eng._kernel_active
            out[case] = _drive(eng, mix, lambda e: np.asarray(e._logits))
            eng.close()
    return out


def _port(params, monkeypatch, case, lane="force"):
    monkeypatch.setenv("SELDON_TPU_PAGED_KERNEL", lane)
    monkeypatch.setenv("SELDON_TPU_CHUNK_IMPL", "pool")  # the JAX engines' chunk, on either lane
    kw, mix = _engine_kw(case, registry)
    eng = PagedEngine(params, dtype="float32", device="cpu", prefix_cache=False, **CFG, **ENGINE, **kw)
    return eng, mix


@pytest.mark.parametrize("lane", ["force", "0"])
@pytest.mark.parametrize("case", list(CASES))
def test_greedy_tokens_and_first_logits_equal_the_jax_engine(params, jax_runs, monkeypatch, case, lane):
    eng, mix = _port(params, monkeypatch, case, lane)
    assert eng._kernel_active is (lane == "force")
    tokens, first = _drive(eng, mix, lambda e: e._logits.numpy())
    want_tokens, want_first = jax_runs[case]
    np.testing.assert_allclose(first, want_first, rtol=1e-4, atol=1e-4 * np.abs(want_first).max())
    np.testing.assert_array_equal(tokens, want_tokens)


def test_lanes_differ_from_the_float_engine(params, jax_runs, monkeypatch):
    # the quantised lanes are other numerics, not the float engine renamed
    monkeypatch.setenv("SELDON_TPU_PAGED_KERNEL", "force")
    plain = PagedEngine(params, dtype="float32", device="cpu", prefix_cache=False, **CFG, **ENGINE)
    _, first = _drive(plain, [None] * len(SIZES), lambda e: e._logits.numpy())
    for case in ("int8", "w8a8"):
        assert not np.allclose(first, jax_runs[case][1], rtol=1e-6, atol=0), case
    assert not np.allclose(jax_runs["int8"][1], jax_runs["w8a8"][1], rtol=1e-6, atol=0)


def test_the_manifest_and_the_resting_bytes(params, flax_params, monkeypatch):
    from seldon_core_tpu.ops import surgery as jax_surgery

    eng, _ = _port(params, monkeypatch, "int8")
    _, jax_manifest = jax_surgery.quantize_params(flax_params)
    assert sorted(r["path"].removeprefix("params/") for r in eng.quantize_manifest) == \
        sorted(r["path"] for r in jax_manifest)
    assert len(eng.quantize_manifest) == 4 * CFG["num_layers"] + 1  # every kernel, the head included
    assert all(isinstance(qk, QuantizedKernel) and qk.q.dtype == torch.int8 for qk in eng._qkernels.values())
    plain = PagedEngine(params, dtype="float32", device="cpu", **CFG, **ENGINE)
    w8 = _port(params, monkeypatch, "w8a8")[0]
    assert eng.weight_bytes() < 0.45 * plain.weight_bytes() and w8.weight_bytes() < 0.45 * plain.weight_bytes()
    assert w8._qkernels == {}  # w8a8 rests as the layers' frozen integers and steps
    frozen = [m for m in w8.module.modules() if isinstance(m, w8a8.W8A8Dense)]
    assert len(frozen) == 4 * CFG["num_layers"] + 1 and all(m.frozen is not None for m in frozen)
    assert all(m.weight.numel() == 0 for m in frozen)  # no float copy rests beside the integers


def test_w8a8_quantizes_no_weight_per_call_or_step(params, monkeypatch):
    eng, _ = _port(params, monkeypatch, "w8a8")
    before = w8a8.weight_quantizations()
    eng.generate(_prompts()[2], max_new_tokens=MAX_NEW)
    assert w8a8.weight_quantizations() == before
    assert eng.engine_stats()["weight_materializations"] == 0


def test_int8w_dequantizes_once_per_prefill_wave_and_per_chunk(params, monkeypatch):
    eng, _ = _port(params, monkeypatch, "int8")
    eng.generate(_prompts()[2], max_new_tokens=MAX_NEW)
    s = eng.engine_stats()
    assert s["chunks"] == MAX_NEW // ENGINE["steps_per_call"] and s["prefill_chunks"] == 1
    assert s["weight_materializations"] == s["chunks"] + 1  # one prefill wave, one per chunk, none per step
    # the module's kernels rest empty between calls
    assert all(eng.module.get_submodule(k.rpartition(".")[0]).weight.numel() == 0 for k in eng._qkernels)


def test_int8_lowering_report_reads_the_gemms():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(8, 32)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(32, 16)).astype(np.float32))
    rep = w8a8.int8_lowering_report(lambda a, b: w8a8.w8a8_matmul(a, b), x, w)
    assert rep["verdict"] == "int8" and rep["float_ops"] == 0 and rep["int8_majority"], rep
    assert rep["backend"] == "cpu" and any("_int_mm" in line for line in rep["evidence"])
    rep = w8a8.int8_lowering_report(lambda a, b: a @ b, x, w)
    assert rep["verdict"] == "float-upcast" and not rep["int8_majority"], rep
    rep = w8a8.int8_lowering_report(lambda a, b: a.long() @ b.long(), x, w)
    assert rep["verdict"] == "int-widened", rep
    assert set(rep) == {"verdict", "int8_ops", "int_widened_ops", "float_ops", "int8_majority", "backend",
                        "evidence"}


def test_int8_lowering_report_of_a_w8a8_decode_chunk(params, monkeypatch):
    eng, _ = _port(params, monkeypatch, "w8a8")
    stream = eng.submit(_prompts()[0], max_new_tokens=MAX_NEW)
    eng.step()  # prefill + the first chunk: the next step is decode alone
    rep = w8a8.int8_lowering_report(eng.step)
    assert rep["verdict"] == "int8" and rep["int8_majority"], rep
    # 4 projections a layer and the head, each step of the chunk
    assert rep["int8_ops"] == (4 * CFG["num_layers"] + 1) * ENGINE["steps_per_call"]
    eng.run()
    assert stream.result.shape == (MAX_NEW,)


def test_streaminglm_passes_the_precision_through(monkeypatch):
    monkeypatch.setenv("SELDON_TPU_PAGED_KERNEL", "force")
    lm = StreamingLM(device="cpu", dtype="float32", precision="w8a8", max_new_tokens=4, **CFG, **ENGINE)
    lm.load()
    try:
        status = lm.health_status()
        assert status["precision"] == "w8a8" and status["quantize"] == "int8"
        assert status["weight_bytes"] == lm.engine.weight_bytes()
        assert lm.predict(_prompts()[0][None], []).shape == (1, 4)
    finally:
        lm.unload()
    for kw in (dict(precision="fp8"), dict(quantize="int4")):
        with pytest.raises(MicroserviceError) as err:
            StreamingLM(device="cpu", **CFG, **kw)
        assert err.value.reason == "BAD_QUANTIZE"
