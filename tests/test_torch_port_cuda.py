"""The PyTorch port on a CUDA card: kernels (K1, K3, K4, K5) against their
plain versions, and the served paths through the kernels.

Every test here needs the card and skips without one (the decision is
made inside each test, never at import).  The module imports no JAX, so
it also runs on a card host without the JAX package's dependencies:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from seldon_core_tpu_torch.models.cudaserver import CudaServer
from seldon_core_tpu_torch.models.generate import load_lm_params
from seldon_core_tpu_torch.models.paged import PagedEngine
from seldon_core_tpu_torch.ops import kernels

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = rng.integers(0, 256, size=shape, dtype=np.uint8)
    scale = rng.uniform(0.001, 0.05, c).astype(np.float32)
    shift = rng.uniform(-2.0, 1.0, c).astype(np.float32)
    return [torch.from_numpy(a).cuda() for a in (x, scale, shift)]


@pytest.mark.parametrize("shape", [(32, 224, 224, 3), (3, 5, 7, 1), (2, 9, 11, 4), (1, 1, 1, 17)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_fused_normalize_bit_identical_to_plain_version(shape, dtype):
    _need_card()
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    args = _inputs(shape, seed=sum(shape))
    before = kernels.launch_counts()["fused_normalize"]
    got = kernels.fused_normalize(*args, out_dtype=dtype)
    ref = kernels.fused_normalize_reference(*args, out_dtype=dtype)
    torch.cuda.synchronize()
    assert got.is_cuda and got.is_contiguous() and tuple(got.shape) == shape
    assert torch.equal(got.view(bits), ref.view(bits))
    assert kernels.launch_counts()["fused_normalize"] == before + 1


def test_fused_normalize_misaligned_view():
    _need_card()
    x, scale, shift = _inputs((2, 4, 4, 3), seed=5)
    view = x.flatten()[1:94].view(1, 31, 1, 3)  # contiguous, one byte off alignment
    assert view.data_ptr() % 16
    got = kernels.fused_normalize(view, scale, shift)
    assert torch.equal(got, kernels.fused_normalize_reference(view, scale, shift))


def test_served_uint8_batch_launches_the_kernel():
    _need_card()
    cs = CudaServer(model="resnet_tiny", num_classes=4, normalize=True, max_batch_size=2)
    cs.load()
    try:
        kernels.reset_launch_counts()
        out = cs.predict(np.random.default_rng(9).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8), [])
        assert out.shape == (2, 4) and np.isfinite(out).all()
        assert kernels.launch_counts()["fused_normalize"] == 1
    finally:
        cs.unload()


# K4/K5 shapes: the serving config (B=16, h=8, hd=64, ps=64, P=16) at the
# lengths chip_smoke.py uses, and a ragged small one (hd=16, ps=8)
PAGED_CASES = [
    (16, 8, 64, 64, 16, [0, 1, 63, 64, 65, 127, 128, 200, 333, 511, 512, 640, 777, 900, 1000, 1024]),
    (5, 2, 16, 8, 6, [0, 1, 8, 9, 48]),
]
PAGED_REL_TOL = 1e-4  # largest |kernel - plain| over finite entries / largest |plain|


def _paged_inputs(B, h, hd, ps, P, lengths, dtype, seed):
    rng = np.random.default_rng(seed)
    num_pages = B * P + 1
    pool = [rng.standard_normal((num_pages, ps, h, hd), dtype=np.float32) for _ in range(2)]
    q = rng.standard_normal((B, h, hd), dtype=np.float32) * 0.125
    tables = rng.permutation(np.arange(1, num_pages)).reshape(B, P).astype(np.int32)  # non-contiguous ids
    out = [torch.from_numpy(a).to(dtype).cuda() for a in (q, *pool)]
    return out + [torch.from_numpy(tables).cuda(), torch.tensor(lengths, dtype=torch.int32).cuda()]


@pytest.mark.parametrize("case", range(len(PAGED_CASES)))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("impl", ["stream", "grid"])
def test_paged_decode_matches_plain_version(impl, dtype, case, monkeypatch):
    _need_card()
    monkeypatch.setenv("SELDON_TPU_PAGED_KERNEL_IMPL", impl)
    B, h, hd, ps, P, lengths = PAGED_CASES[case]
    args = _paged_inputs(B, h, hd, ps, P, lengths, dtype, seed=case)
    name = f"paged_decode_{impl}"
    before = kernels.launch_counts()[name]
    got = kernels.paged_attention_decode(*args, page_size=ps)
    ref = kernels.paged_attention_decode_reference(*args, page_size=ps)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == before + (1 if impl == "stream" else 2)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32 and g.shape == r.shape and not torch.isnan(g).any()
        special = torch.isinf(r) | (r == 0)
        assert torch.equal(g[special], r[special])
        fin = ~special
        assert ((g[fin] - r[fin]).abs().max() / r[fin].abs().max()).item() <= PAGED_REL_TOL


@pytest.mark.parametrize("impl", ["stream", "grid"])
def test_paged_engine_launches_the_kernel_every_step_of_every_layer(impl, monkeypatch):
    _need_card()
    monkeypatch.setenv("SELDON_TPU_PAGED_KERNEL_IMPL", impl)
    monkeypatch.delenv("SELDON_TPU_PAGED_KERNEL", raising=False)  # auto: the kernel lane on a CUDA engine
    cfg = dict(vocab_size=128, d_model=64, num_layers=2, num_heads=4, max_len=128)
    eng = PagedEngine(load_lm_params("", cfg, 0), dtype="bfloat16", device="cuda", page_size=16, max_slots=4,
                      steps_per_call=4, **cfg)
    assert eng._kernel_active
    kernels.reset_launch_counts()
    rng = np.random.default_rng(0)
    streams = [eng.submit(rng.integers(0, 128, n), max_new_tokens=8) for n in (5, 17, 40)]
    eng.run()
    steps = eng.engine_stats()["chunks"] * 4
    per_launch = 1 if impl == "stream" else 2
    assert kernels.launch_counts()[f"paged_decode_{impl}"] == cfg["num_layers"] * steps * per_launch
    assert all(s.result.shape == (8,) and ((s.result >= 0) & (s.result < 128)).all() for s in streams)


# K3 shapes: the ViT-B/16 serving shape, the causal LM check shape, small
# f32 ones, head_dim 128 and a ragged one in f16; (B, L, H, D, dtype, causal)
FLASH_CASES = [
    (32, 197, 12, 64, torch.bfloat16, False),
    (4, 1024, 8, 64, torch.bfloat16, True),
    (2, 50, 2, 16, torch.float32, False),
    (2, 50, 2, 16, torch.float32, True),
    (1, 1, 1, 8, torch.float32, True),
    (2, 197, 4, 128, torch.bfloat16, False),
    (2, 130, 3, 40, torch.float16, True),
]
# float32: largest |kernel - plain| within 1e-5 of the largest |plain|;
# bf16 / f16: one step of the format (rtol 2**-7 / 2**-10), with a floor at
# one step of 2**-8 of the largest |plain| (near zero the two float32 sums
# differ by more than a step of the value itself)
FLASH_RTOL = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}


def assert_flash_close(got, ref):
    g, r = got.float(), ref.float()
    assert got.dtype == ref.dtype and got.shape == ref.shape and not torch.isnan(g).any()
    if got.dtype == torch.float32:
        assert (g - r).abs().max().item() <= 1e-5 * r.abs().max().item()
    else:
        rtol = FLASH_RTOL[got.dtype]
        assert bool(((g - r).abs() <= rtol * r.abs() + rtol * 2.0 ** -8 * r.abs().max()).all())


@pytest.mark.parametrize("case", range(len(FLASH_CASES)))
def test_flash_attention_matches_plain_version(case):
    _need_card()
    assert not torch.backends.cuda.matmul.allow_tf32  # the plain version's float32 einsums in full float32
    B, L, H, D, dtype, causal = FLASH_CASES[case]
    rng = np.random.default_rng(case)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, L, H, D), dtype=np.float32)).to(dtype).cuda()
               for _ in range(3))
    before = kernels.launch_counts()["flash_attention"]
    got = kernels.flash_attention(q, k, v, causal=causal)
    ref = kernels.flash_attention_reference(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention"] == before + 1
    assert_flash_close(got, ref)


def test_flash_attention_reads_the_qkv_split_in_place():
    _need_card()
    qkv = torch.randn(3, 197, 3 * 12 * 64, device="cuda", dtype=torch.bfloat16)
    q, k, v = (t.reshape(3, 197, 12, 64) for t in qkv.split(12 * 64, dim=-1))
    assert_flash_close(kernels.flash_attention(q, k, v), kernels.flash_attention_reference(q, k, v))


def test_flash_attention_refuses_what_the_kernel_does_not_take():
    _need_card()
    q = torch.zeros(1, 4, 2, 136, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        kernels.flash_attention(q, q, q)
    q = torch.zeros(1, 4, 2, 12, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        kernels.flash_attention(q, q, q)
    q = torch.zeros(1, 4, 2, 16, device="cuda")
    with pytest.raises(TypeError, match="one dtype"):
        kernels.flash_attention(q, q.half(), q)


def test_served_vit_launches_the_kernel_in_every_block():
    _need_card()
    cs = CudaServer(model="vit_tiny", num_classes=4, normalize=True, max_batch_size=2,
                    model_kwargs={"attention": "flash"})
    cs.load()
    try:
        kernels.reset_launch_counts()
        out = cs.predict(np.random.default_rng(10).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8), [])
        assert out.shape == (2, 4) and np.isfinite(out).all()
        counts = kernels.launch_counts()
        assert counts["fused_normalize"] == 1 and counts["flash_attention"] == len(cs.module.blocks)
    finally:
        cs.unload()
