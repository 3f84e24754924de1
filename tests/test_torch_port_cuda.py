"""The PyTorch port on a CUDA card: kernels (K1, K2, K3, K4, K5, and the
int8 and LoRA-fold variants of K4 / K5) against their plain versions, the
w8a8 lane's integer GEMMs against an exact float64 product, and the
served paths through the kernels.

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
from seldon_core_tpu_torch.models.resnet import same_pads
from seldon_core_tpu_torch.ops import kernels, w8a8

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


# the served batches; C = 1, 3, 4 with and without a tail; C = 5 and 17 (the
# generic body); fewer bytes than one unit; more units than one wave holds
@pytest.mark.parametrize("shape", [(32, 224, 224, 3), (3, 5, 7, 1), (2, 9, 11, 4), (1, 1, 1, 17),
                                   (1, 224, 224, 3), (1, 5, 7, 3), (3, 5, 7, 4), (2, 3, 5, 5), (1, 1, 5, 3),
                                   (64, 224, 224, 3)])
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


def test_fused_normalize_raises_when_the_launch_fails(monkeypatch):
    _need_card()
    x, scale, shift = _inputs((2, 9, 11, 3), seed=6)
    real = kernels.normalize_geometry
    # 512 threads a block is past the kernel's launch bounds: the library refuses the launch
    monkeypatch.setattr(kernels, "normalize_geometry", lambda *a: real(*a)._replace(threads=512))
    before = kernels.launch_counts()["fused_normalize"]
    with pytest.raises(kernels.KernelLaunchError, match="fused_normalize launch failed"):
        kernels.fused_normalize(x, scale, shift)
    assert kernels.launch_counts()["fused_normalize"] == before
    monkeypatch.setattr(kernels, "normalize_geometry", real)
    got = kernels.fused_normalize(x, scale, shift)  # the refused launch leaves no error behind
    assert torch.equal(got, kernels.fused_normalize_reference(x, scale, shift))


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


def _assert_paged_close(got, ref):
    """acc / m / l within PAGED_REL_TOL of the plain version, -inf and 0
    exactly where it has them; the fold's delta within 1e-5, 0 where it is."""
    assert len(got) == len(ref)
    for g, r in zip(got[:3], ref[:3]):
        assert g.dtype == torch.float32 and g.shape == r.shape and not torch.isnan(g).any()
        special = torch.isinf(r) | (r == 0)
        assert torch.equal(g[special], r[special])
        fin = ~special
        if bool(fin.any()):
            assert ((g[fin] - r[fin]).abs().max() / r[fin].abs().max()).item() <= PAGED_REL_TOL
    if len(got) == 4:
        d, rd = got[3], ref[3]
        assert torch.equal(d[rd == 0], rd[rd == 0])
        assert ((d - rd).abs().max() / rd.abs().max().clamp_min(1e-30)).item() <= 1e-5


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
    assert kernels.launch_counts()[name] == before + 1  # K4 and K5 alike: one launch, the merge inside
    _assert_paged_close(got, ref)


# the int8 and LoRA-fold variants: (impl, int8 pages, fold)
PAGED_VARIANTS = [("stream", True, False), ("grid", True, False), ("stream", False, True), ("stream", True, True)]
LORA_SLOTS, LORA_RANK = 3, 8


def _variant_inputs(B, h, hd, ps, P, lengths, dtype, quantized, seed):
    """q, pages (int8 with positive scales, or q's dtype), tables, lengths,
    and the fold's x / A / B / slot ids (lanes over slots 0, 1, 2)."""
    rng = np.random.default_rng(seed)
    num_pages, D = B * P + 1, h * hd
    if quantized:
        pages = [torch.from_numpy(rng.integers(-127, 128, (num_pages, ps, h, hd), dtype=np.int8)).cuda()
                 for _ in range(2)]
        scales = tuple(torch.from_numpy(rng.uniform(0.001, 0.05, num_pages).astype(np.float32)).cuda()
                       for _ in range(2))
    else:
        pages = [torch.from_numpy(rng.standard_normal((num_pages, ps, h, hd), dtype=np.float32)).to(dtype).cuda()
                 for _ in range(2)]
        scales = None
    q = torch.from_numpy(rng.standard_normal((B, h, hd), dtype=np.float32) * 0.125).to(dtype).cuda()
    tables = torch.from_numpy(rng.permutation(np.arange(1, num_pages)).reshape(B, P).astype(np.int32)).cuda()
    a = (rng.standard_normal((LORA_SLOTS, D, LORA_RANK), dtype=np.float32) / np.float32(np.sqrt(D)))
    b = (rng.standard_normal((LORA_SLOTS, LORA_RANK, 3 * D), dtype=np.float32) / np.float32(np.sqrt(LORA_RANK)))
    a[0] = b[0] = 0
    lora = (torch.from_numpy(rng.standard_normal((B, D), dtype=np.float32)).cuda(), torch.from_numpy(a).cuda(),
            torch.from_numpy(b).cuda(), torch.tensor([i % LORA_SLOTS for i in range(B)], dtype=torch.int32).cuda(),
            hd ** -0.5)
    return [q, *pages, tables, torch.tensor(lengths, dtype=torch.int32).cuda()], scales, lora


@pytest.mark.parametrize("case", range(len(PAGED_CASES)))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("impl,quantized,fold", PAGED_VARIANTS,
                         ids=[kernels.paged_launch_name(*v) for v in PAGED_VARIANTS])
def test_paged_decode_variants_match_plain_version(impl, quantized, fold, dtype, case, monkeypatch):
    _need_card()
    monkeypatch.setenv("SELDON_TPU_PAGED_KERNEL_IMPL", impl)
    B, h, hd, ps, P, lengths = PAGED_CASES[case]
    args, scales, lora = _variant_inputs(B, h, hd, ps, P, lengths, dtype, quantized, seed=10 + case)
    kw = dict(page_size=ps, kv_scales=scales, lora=lora if fold else None)
    name = kernels.paged_launch_name(impl, quantized, fold)
    before = kernels.launch_counts()[name]
    got = kernels.paged_attention_decode(*args, **kw)
    ref = kernels.paged_attention_decode_reference(*args, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == before + 1
    assert len(got) == len(ref) == (4 if fold else 3)
    _assert_paged_close(got, ref)
    if fold:
        assert bool((got[3][lora[3] == 0] == 0).all())  # slot-0 lanes: exactly 0


def _call(impl, args, kw, monkeypatch):
    monkeypatch.setenv("SELDON_TPU_PAGED_KERNEL_IMPL", impl)
    return kernels.paged_attention_decode(*args, **kw)


def _pick(args, kw, sel, lengths=None, tables=None, slots=None):
    """The lanes `sel` of a call's inputs, with other lengths / tables /
    adapter slots where given."""
    q, pk, pv, t, lens = args
    lens = lens if lengths is None else lengths
    t = t if tables is None else tables
    kw = dict(kw)
    if kw.get("lora") is not None:
        x, a, b, idx, q_scale = kw["lora"]
        kw["lora"] = (x[sel], a, b, (idx if slots is None else slots)[sel], q_scale)
    return [q[sel], pk, pv, t[sel], lens[sel]], kw


@pytest.mark.parametrize("impl,quantized,fold", [("stream", False, False), ("grid", False, False)] + PAGED_VARIANTS,
                         ids=["paged_decode_stream", "paged_decode_grid"] +
                             [kernels.paged_launch_name(*v) for v in PAGED_VARIANTS])
def test_paged_decode_lane_bits_do_not_depend_on_other_lanes(impl, quantized, fold, monkeypatch):
    """A lane's (acc, m, l, delta) stay bit-identical when the other lanes'
    lengths, tables and adapter slots change, and when B changes."""
    _need_card()
    B, h, hd, ps, P, lengths = PAGED_CASES[0]
    args, scales, lora = _variant_inputs(B, h, hd, ps, P, lengths, torch.bfloat16, quantized, seed=40)
    kw = dict(page_size=ps, kv_scales=scales, lora=lora if fold else None)
    base = _call(impl, args, kw, monkeypatch)
    every = torch.arange(B, device="cuda")
    even, odd = every[0::2], every[1::2]
    lens2, tables2 = args[4].clone(), args[3].clone()
    lens2[odd] = torch.roll(args[4][odd], 3)
    tables2[odd] = torch.roll(args[3][odd], 1, 0)
    slots = lora[3].clone()
    slots[odd] = (slots[odd] + 1) % LORA_SLOTS
    for sel, extra in ((torch.flip(every, (0,)), {}), (even, {}), (every[:3], {}),
                       (every, dict(lengths=lens2, tables=tables2, slots=slots))):
        got = _call(impl, *_pick(args, kw, sel, **extra), monkeypatch)
        keep = even if extra else sel
        for g, r in zip(got, base):
            assert torch.equal(g[keep if extra else slice(None)], r[keep])


@pytest.mark.parametrize("impl", ["stream", "grid"])
def test_paged_decode_repeats_bit_for_bit(impl, monkeypatch):
    _need_card()
    B, h, hd, ps, P, lengths = PAGED_CASES[0]
    args, scales, lora = _variant_inputs(B, h, hd, ps, P, lengths, torch.bfloat16, True, seed=41)
    kw = dict(page_size=ps, kv_scales=scales, lora=lora if impl == "stream" else None)
    first = _call(impl, args, kw, monkeypatch)
    for _ in range(5):
        for g, r in zip(_call(impl, args, kw, monkeypatch), first):
            assert torch.equal(g, r)


@pytest.mark.parametrize("ps", [8, 16, 64])
@pytest.mark.parametrize("impl", ["stream", "grid"])
def test_paged_decode_lengths_at_chunk_edges(impl, ps, monkeypatch):
    """Lengths one below, at and one above a chunk of G pages, and above
    the table's P * ps (capped), against the plain version."""
    _need_card()
    h, hd, P = 4, 32, 12
    G, _ = kernels.paged_split(impl, h, hd, ps, P, torch.bfloat16)
    edge = G * ps
    lengths = [0, 1, edge - 1, edge, edge + 1, 2 * edge - 1, 2 * edge + 1, P * ps - 1, P * ps, P * ps + 1,
               P * ps + 100]
    args, _, _ = _variant_inputs(len(lengths), h, hd, ps, P, [max(n, 0) for n in lengths], torch.bfloat16,
                                 False, seed=ps)
    got = _call(impl, args, dict(page_size=ps), monkeypatch)
    _assert_paged_close(got, kernels.paged_attention_decode_reference(*args, page_size=ps))


# (heads, head_dim, page size): head_dim 16 / 64 / 128, pages of 8 / 16 / 64,
# h * hd up to 16 x 128
PAGED_GEOMETRIES = [(2, 16, 8), (8, 64, 16), (4, 128, 64), (16, 128, 16), (16, 64, 64), (3, 40, 8)]


@pytest.mark.parametrize("pool", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("geometry", PAGED_GEOMETRIES, ids=[f"h{h}-hd{d}-ps{p}" for h, d, p in PAGED_GEOMETRIES])
@pytest.mark.parametrize("impl,fold", [("stream", False), ("grid", False), ("stream", True)],
                         ids=["stream", "grid", "stream-lora"])
def test_paged_decode_geometries_match_plain_version(impl, fold, geometry, pool, monkeypatch):
    _need_card()
    h, hd, ps = geometry
    P, lengths = 6, [0, 1, ps - 1, ps, ps + 1, 3 * ps + 5, 6 * ps, 6 * ps + 9]
    quantized = pool == "int8"
    qdtype = torch.float32 if pool == "float32" else torch.bfloat16
    args, scales, lora = _variant_inputs(len(lengths), h, hd, ps, P, lengths, qdtype, quantized, seed=h * hd + ps)
    kw = dict(page_size=ps, kv_scales=scales, lora=lora if fold else None)
    name = kernels.paged_launch_name(impl, quantized, fold)
    before = kernels.launch_counts()[name]
    got = _call(impl, args, kw, monkeypatch)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == before + 1
    _assert_paged_close(got, kernels.paged_attention_decode_reference(*args, **kw))


def test_paged_decode_grid_is_one_device_kernel(monkeypatch):
    """K5 computes, merges and writes in one launch: the profiler sees one
    kernel on the device for one call."""
    _need_card()
    from torch.profiler import ProfilerActivity, profile

    B, h, hd, ps, P, lengths = PAGED_CASES[0]
    args = _paged_inputs(B, h, hd, ps, P, lengths, torch.bfloat16, seed=5)
    monkeypatch.setenv("SELDON_TPU_PAGED_KERNEL_IMPL", "grid")
    kernels.paged_attention_decode(*args, page_size=ps)  # built and warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        kernels.paged_attention_decode(*args, page_size=ps)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
             and "paged_decode" in e.name]
    assert len(names) == 1, names


def test_paged_decode_back_to_back_calls_share_the_counters(monkeypatch):
    """Calls queued on one stream without a sync between them share the
    arrival counters (the paged merge's, and K2's split K between them):
    each result equals its plain version, and the counters are 0
    afterwards."""
    _need_card()
    B, h, hd, ps, P, _ = PAGED_CASES[0]
    rng = np.random.default_rng(6)
    calls, products = [], []
    for i in range(12):
        lengths = rng.integers(0, P * ps + 1, B).tolist()
        args, scales, lora = _variant_inputs(B, h, hd, ps, P, lengths, torch.bfloat16, i % 2 == 0, seed=60 + i)
        impl = ("stream", "grid")[i % 3 == 0]
        kw = dict(page_size=ps, kv_scales=scales, lora=lora if impl == "stream" and i % 4 == 1 else None)
        calls.append((impl, args, kw, _call(impl, args, kw, monkeypatch)))
        if i % 3 == 1:  # the LM's qkv at 16 lanes: K2 splits K
            x, w_q, scale = _k2_inputs(16, 512, 1536, torch.float32, seed=i)
            products.append((x, w_q, scale, kernels.int8_matmul(x, w_q, scale)))
    torch.cuda.synchronize()
    for impl, args, kw, got in calls:
        _assert_paged_close(got, kernels.paged_attention_decode_reference(*args, **kw))
    for x, w_q, scale, got in products:
        assert_k2_close(got, kernels.int8_matmul_reference(x, w_q, scale))
    stream = torch.cuda.current_stream().cuda_stream
    assert int(kernels._COUNTERS[(torch.cuda.current_device(), stream)].abs().sum()) == 0


def test_int8_adapter_streaminglm_round_trip(monkeypatch):
    """StreamingLM on the card with an int8 pool and two adapters: every
    decode step of every layer launches K4-int8+LoRA, and each served row
    equals an in-process engine of the same weights, adapters and pool."""
    _need_card()
    from seldon_core_tpu_torch.models.paged import StreamingLM
    from seldon_core_tpu_torch.models.registry import WeightRegistry
    from seldon_core_tpu_torch.ops.lora import make_lora_params

    monkeypatch.setenv("SELDON_TPU_KV_DTYPE", "int8")
    monkeypatch.delenv("SELDON_TPU_PAGED_KERNEL", raising=False)
    monkeypatch.setenv("SELDON_TPU_PAGED_KERNEL_IMPL", "stream")
    cfg = dict(vocab_size=128, d_model=64, num_layers=2, num_heads=4, max_len=128)
    engine = dict(page_size=16, max_slots=4, steps_per_call=4)
    lm = StreamingLM(max_adapters=2, lora_rank=4, adapters={"cuda-a1": {"seed": 1}, "cuda-a2": {"seed": 2}},
                     max_new_tokens=8, **cfg, **engine)
    lm.load()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 128, n) for n in (5, 17, 40)]
    try:
        assert lm.engine._kv_int8 and lm.engine._kernel_active
        kernels.reset_launch_counts()
        calls0 = _decode_calls(lm.engine.engine_stats())
        served = [lm.predict(np.asarray([p]), [], meta={"tags": {"adapter": a} if a else {}})[0]
                  for p, a in zip(prompts, (None, "cuda-a1", "cuda-a2"))]
        calls = _decode_calls(lm.engine.engine_stats()) - calls0
        assert calls > 0 and kernels.launch_counts()["paged_decode_stream_int8_lora"] == cfg["num_layers"] * calls
    finally:
        lm.unload()
    reg = WeightRegistry()
    for name, seed in (("cuda-a1", 1), ("cuda-a2", 2)):
        reg.register(name, (lambda s=seed: make_lora_params(s, num_layers=2, d_model=64, rank=4, alpha=4.0)))
    eng = PagedEngine(load_lm_params("", cfg, 0, torch.device("cuda")), dtype="bfloat16", device="cuda",
                      max_adapters=2, lora_rank=4, weight_registry=reg, **cfg, **engine)
    for p, a, row in zip(prompts, (None, "cuda-a1", "cuda-a2"), served):
        np.testing.assert_array_equal(eng.generate(p, max_new_tokens=8, adapter=a), row)


def _decode_calls(stats) -> int:
    """Decode kernel calls a layer over an engine's life: one per step
    per length bucket (a bucketed chunk splits its lanes in two)."""
    return sum(int(k) * v for k, v in stats["chunk_steps"].items()) + stats["bucketed_steps"]


@pytest.mark.parametrize("impl", ["stream", "grid"])
def test_paged_engine_launches_the_kernel_every_step_of_every_layer(impl, monkeypatch):
    _need_card()
    monkeypatch.setenv("SELDON_TPU_PAGED_KERNEL_IMPL", impl)
    monkeypatch.delenv("SELDON_TPU_PAGED_KERNEL", raising=False)  # auto: the kernel lane on a CUDA engine
    monkeypatch.setenv("SELDON_TPU_CTX_BUCKETS", "2")  # the split asked for: one bucket is the CUDA default
    cfg = dict(vocab_size=128, d_model=64, num_layers=2, num_heads=4, max_len=128)
    eng = PagedEngine(load_lm_params("", cfg, 0), dtype="bfloat16", device="cuda", page_size=16, max_slots=4,
                      steps_per_call=4, **cfg)
    assert eng._kernel_active
    kernels.reset_launch_counts()
    rng = np.random.default_rng(0)
    streams = [eng.submit(rng.integers(0, 128, n), max_new_tokens=8) for n in (5, 17, 40)]
    eng.run()
    calls = _decode_calls(eng.engine_stats())
    assert calls > eng.engine_stats()["chunks"] * 4  # the three lanes split into two length buckets
    assert kernels.launch_counts()[f"paged_decode_{impl}"] == cfg["num_layers"] * calls
    assert all(s.result.shape == (8,) and ((s.result >= 0) & (s.result < 128)).all() for s in streams)



@pytest.mark.parametrize("case", ["w8a8", "prefix_hit"])
def test_scheduler_lanes_launch_the_kernel_every_step_and_match_the_gather_lane(case, monkeypatch):
    """A w8a8 engine, and suffix prefills over prefix-cache hits: K4 once
    per layer per decode step, and in float32 the greedy tokens of the
    gather lane."""
    _need_card()
    cfg = dict(vocab_size=128, d_model=64, num_layers=2, num_heads=4, max_len=256)
    params = load_lm_params("", cfg, 0)
    rng = np.random.default_rng(3)
    system = rng.integers(0, 128, 48)
    prompts = [np.concatenate([system, rng.integers(0, 128, n)]) for n in (5, 17, 30)]
    kw = dict(precision="w8a8", prefix_cache=False) if case == "w8a8" else dict(prefix_cache=True)

    def run(lane):
        if lane == "auto":
            monkeypatch.delenv("SELDON_TPU_PAGED_KERNEL", raising=False)
        else:
            monkeypatch.setenv("SELDON_TPU_PAGED_KERNEL", lane)
        monkeypatch.setenv("SELDON_TPU_CHUNK_IMPL", "pool")  # the gather lane, not the ring, with the kernel off
        eng = PagedEngine(params, dtype="float32", device="cuda", page_size=16, max_slots=4, steps_per_call=4,
                          **cfg, **kw)
        first = eng.generate(prompts[0], max_new_tokens=8)  # publishes the system prompt's pages
        calls0 = _decode_calls(eng.engine_stats())
        kernels.reset_launch_counts()
        rest = [eng.submit(p, max_new_tokens=8) for p in prompts[1:]]
        eng.run()
        torch.cuda.synchronize()
        stats = eng.engine_stats()
        steps = _decode_calls(stats) - calls0
        return ([first.tolist()] + [s.result.tolist() for s in rest], kernels.launch_counts()["paged_decode_stream"],
                steps, stats, eng._kernel_active)

    tokens, launches, steps, stats, active = run("auto")
    gather, gather_launches, _, _, gather_active = run("0")
    assert active and not gather_active and gather_launches == 0
    assert steps > 0 and launches == cfg["num_layers"] * steps
    assert tokens == gather
    if case == "prefix_hit":
        assert stats["prefix_hits"] == 2 and stats["prefix_tokens_saved"] == 2 * 48


def test_ring_chunk_and_the_length_buckets_on_the_card(monkeypatch):
    """In float32: a ring engine (``SELDON_TPU_CHUNK_IMPL=ring``) gives a
    K4 pool engine's greedy tokens and launches no K4; on a bimodal batch
    every pool chunk splits into two buckets and launches K4 once per
    layer per step per bucket."""
    _need_card()
    cfg = dict(vocab_size=128, d_model=64, num_layers=2, num_heads=4, max_len=512)
    params = load_lm_params("", cfg, 0)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 128, n) for n in (6, 9, 300, 330)]
    monkeypatch.delenv("SELDON_TPU_PAGED_KERNEL", raising=False)
    monkeypatch.setenv("SELDON_TPU_CTX_BUCKETS", "2")  # the split asked for: one bucket is the CUDA default
    runs = {}
    for impl in ("ring", "pool"):
        monkeypatch.setenv("SELDON_TPU_CHUNK_IMPL", impl)
        eng = PagedEngine(params, dtype="float32", device="cuda", page_size=16, max_slots=4, steps_per_call=4,
                          prefix_cache=False, **cfg)
        assert eng._chunk_impl == impl and eng._kernel_active == (impl == "pool")
        kernels.reset_launch_counts()
        streams = [eng.submit(p, max_new_tokens=16) for p in prompts]
        eng.run()
        torch.cuda.synchronize()
        runs[impl] = ([s.result.tolist() for s in streams], kernels.launch_counts().get("paged_decode_stream", 0),
                      eng.engine_stats())
    (ring, ring_k4, ring_stats), (pool, pool_k4, pool_stats) = runs["ring"], runs["pool"]
    assert ring == pool and ring_k4 == 0
    assert ring_stats["bucketed_chunks"] == ring_stats["chunks"] > 0
    steps = sum(int(k) * v for k, v in pool_stats["chunk_steps"].items())
    assert pool_stats["bucketed_chunks"] == pool_stats["chunks"] and pool_stats["bucketed_steps"] == steps
    assert pool_k4 == cfg["num_layers"] * steps * 2


# K3 shapes: the ViT-B/16 serving shapes at 224 and 384, the causal LM check shape, small
# f32 ones, head_dim 128 and a ragged one in f16; (B, L, H, D, dtype, causal)
FLASH_CASES = [
    (32, 197, 12, 64, torch.bfloat16, False),
    (32, 577, 12, 64, torch.bfloat16, False),  # ViT-B/16 at 384 x 384 (A6's second signature)
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


def test_served_vit_at_two_resolutions_launches_the_kernels_per_group():
    _need_card()
    cs = CudaServer(model="vit_tiny", num_classes=4, normalize=True, max_batch_size=2, input_shape=(32, 32, 3),
                    extra_input_shapes=[(48, 48, 3)], model_kwargs={"attention": "flash"})
    cs.load()
    try:
        kernels.reset_launch_counts()
        rng = np.random.default_rng(11)
        for shape in ((32, 32, 3), (48, 48, 3)):
            out = cs.predict(rng.integers(0, 256, (2, *shape), dtype=np.uint8), [])
            assert out.shape == (2, 4) and np.isfinite(out).all()
        counts = kernels.launch_counts()
        assert counts["fused_normalize"] == 2 and counts["flash_attention"] == 2 * len(cs.module.blocks)
        assert len(cs.batcher.signatures) == 2
    finally:
        cs.unload()


# ---------------------------------------------------------------------------
# K2: int8_matmul; the w8a8 lane's integer GEMMs
# ---------------------------------------------------------------------------

K2_CASES = [  # (M, K, N, x dtype)
    (6304, 768, 3072, torch.bfloat16), (32, 2048, 1000, torch.bfloat16), (16, 512, 1536, torch.float32),
    (5, 16, 10, torch.float32), (100, 300, 70, torch.float32), (33, 70, 9, torch.float16), (1, 1, 1, torch.float32),
]


def _k2_inputs(m, k, n, dtype, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32)).to(dtype).cuda()
    w_q, scale = kernels.quantize_weights(rng.standard_normal((k, n), dtype=np.float32))
    return x, torch.from_numpy(w_q).cuda(), torch.from_numpy(scale).cuda()


def assert_k2_close(got, ref):
    """float32 within 1e-5 of the largest |plain|; bf16 / f16 within one
    step of the format, with a floor at 2**-8 of a step of the largest."""
    g, r = got.float(), ref.float()
    assert not bool(torch.isnan(g).any())
    if got.dtype == torch.float32:
        assert (g - r).abs().max().item() <= 1e-5 * r.abs().max().item()
    else:
        step = FLASH_RTOL[got.dtype]
        assert bool(((g - r).abs() <= step * r.abs() + step * 2.0 ** -8 * r.abs().max()).all())


@pytest.mark.parametrize("case", range(len(K2_CASES)))
def test_int8_matmul_matches_plain_version(case):
    _need_card()
    m, k, n, dtype = K2_CASES[case]
    x, w_q, scale = _k2_inputs(m, k, n, dtype, seed=case)
    before = kernels.launch_counts()["int8_matmul"]
    got = kernels.int8_matmul(x, w_q, scale)
    ref = kernels.int8_matmul_reference(x, w_q, scale)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["int8_matmul"] == before + 1
    assert got.dtype == dtype and tuple(got.shape) == (m, n)
    assert_k2_close(got, ref)


def test_int8_matmul_strided_and_misaligned_views():
    _need_card()
    x, w_q, scale = _k2_inputs(40, 100, 24, torch.bfloat16, seed=20)
    wide = torch.zeros(40, 103, dtype=torch.bfloat16, device="cuda")
    wide[:, 1:101] = x
    view = wide[:, 1:101]  # row stride 103, base 2 bytes past alignment: scalar loads
    assert_k2_close(kernels.int8_matmul(view, w_q, scale), kernels.int8_matmul_reference(x, w_q, scale))
    out32 = kernels.int8_matmul(x, w_q, scale, out_dtype=torch.float32)
    assert out32.dtype == torch.float32
    assert_k2_close(out32, kernels.int8_matmul_reference(x, w_q, scale, torch.float32))


def test_int8_dense_on_the_card():
    _need_card()
    rng = np.random.default_rng(21)
    kernel, bias = rng.standard_normal((64, 48), dtype=np.float32), rng.standard_normal(48, dtype=np.float32)
    layer = kernels.Int8Dense(kernel, bias)
    assert layer.w_q.is_cuda
    x = torch.from_numpy(rng.standard_normal((9, 64), dtype=np.float32)).cuda()
    before = kernels.launch_counts()["int8_matmul"]
    got = layer(x)
    assert kernels.launch_counts()["int8_matmul"] == before + 1
    ref = kernels.int8_matmul_reference(x, layer.w_q, layer.scale) + layer.bias
    assert_k2_close(got, ref)


def test_int8_matmul_refuses_what_the_kernel_does_not_take():
    _need_card()
    x, w_q, scale = _k2_inputs(4, 8, 8, torch.float32, seed=22)
    with pytest.raises(TypeError, match="int8 weights"):
        kernels.int8_matmul(x, w_q.float(), scale)
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        kernels.int8_matmul(x.double(), w_q, scale)
    with pytest.raises(ValueError, match="one device"):
        kernels.int8_matmul(x, w_q.cpu(), scale)


@pytest.mark.parametrize("b,hw,cin,cout,kernel,stride", [(32, 56, 64, 64, 3, 1), (2, 28, 128, 128, 3, 2),
                                                         (4, 14, 256, 512, 1, 2), (1, 7, 512, 2048, 1, 1)])
def test_w8a8_conv_integer_gemm_is_exact(b, hw, cin, cout, kernel, stride):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(hw)
    xq = torch.randint(-127, 128, (b, hw, hw, cin), dtype=torch.int8, device="cuda", generator=g)
    wq = torch.randint(-127, 128, (kernel, kernel, cin, cout), dtype=torch.int8, device="cuda", generator=g)
    before = kernels.launch_counts()["w8a8_int_mm"]
    acc = w8a8._int_conv(xq, wq, (stride, stride), "SAME")
    assert kernels.launch_counts()["w8a8_int_mm"] == before + 1
    lo, hi = same_pads(hw, kernel, stride)
    x64 = torch.nn.functional.pad(xq.double().permute(0, 3, 1, 2), (lo, hi, lo, hi))
    want = torch.nn.functional.conv2d(x64, wq.double().permute(3, 2, 0, 1), stride=stride).permute(0, 2, 3, 1)
    assert acc.dtype == torch.int32 and torch.equal(acc.double(), want)


def test_served_precision_lanes_on_the_card():
    _need_card()
    for precision in ("int8w", "w8a8"):
        cs = CudaServer(model="resnet_tiny", num_classes=4, normalize=True, max_batch_size=2, precision=precision)
        cs.load()
        try:
            assert all(v.q.is_cuda and v.q.dtype == torch.int8 for v in cs._qparams.values())
            kernels.reset_launch_counts()
            out = cs.predict(np.random.default_rng(23).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8), [])
            assert out.shape == (2, 4) and np.isfinite(out).all()
            assert kernels.launch_counts()["w8a8_int_mm"] == (11 if precision == "w8a8" else 0)
        finally:
            cs.unload()


# ---------------------------------------------------------------------------
# the tensor-core bodies of K3 (bf16 / f16) and K2 (mma.sync, split K)
# ---------------------------------------------------------------------------

def _flash_qkv(B, L, H, D, dtype, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((B, L, H, D), dtype=np.float32)).to(dtype).cuda()
            for _ in range(3)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
@pytest.mark.parametrize("head_dim", [8, 16, 40, 64, 96, 128])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_flash_attention_tensor_core_head_dims(dtype, head_dim, causal):
    """Every head_dim the kernel takes, padded to the mma's 16 where it is
    not a multiple of 16, at the ViT's 197 tokens (ragged tiles)."""
    _need_card()
    q, k, v = _flash_qkv(2, 197, 3, head_dim, dtype, seed=head_dim)
    assert_flash_close(kernels.flash_attention(q, k, v, causal=causal),
                       kernels.flash_attention_reference(q, k, v, causal=causal))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
@pytest.mark.parametrize("L", [1, 2, 63, 64, 65, 197])
def test_flash_attention_tensor_core_lengths(dtype, L):
    _need_card()
    for causal in (False, True):
        q, k, v = _flash_qkv(3, L, 2, 64, dtype, seed=L)
        assert_flash_close(kernels.flash_attention(q, k, v, causal=causal),
                           kernels.flash_attention_reference(q, k, v, causal=causal))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
def test_flash_attention_tensor_core_rows_with_no_finite_score_write_zero(dtype):
    """A causal row whose every live score is non-finite (its q row is inf)
    gets weight 0 everywhere and writes 0, as the plain version does; the
    other rows are untouched, and nothing is NaN.  No key at all (Lk = 0)
    writes 0 too."""
    _need_card()
    q, k, v = _flash_qkv(2, 130, 2, 64, dtype, seed=3)
    q[0, 70] = float("inf")
    got = kernels.flash_attention(q, k, v, causal=True)
    ref = kernels.flash_attention_reference(q, k, v, causal=True)
    assert_flash_close(got, ref)
    assert bool((got[0, 70] == 0).all())
    empty = q.new_zeros((2, 0, 2, 64))
    out = kernels.flash_attention(q[:, :5], empty, empty)
    assert tuple(out.shape) == (2, 5, 2, 64) and bool((out == 0).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
def test_flash_attention_tensor_core_views(dtype):
    """The qkv split read where it lies, and views whose rows are not
    16-byte aligned (element loads into shared memory)."""
    _need_card()
    B, L, H, D = 2, 197, 4, 64
    qkv = torch.randn(B, L, 3 * H * D, device="cuda", dtype=dtype)
    q, k, v = (t.reshape(B, L, H, D) for t in qkv.split(H * D, dim=-1))
    assert_flash_close(kernels.flash_attention(q, k, v), kernels.flash_attention_reference(q, k, v))
    flat = torch.randn(3 * B * L * H * D + 1, device="cuda", dtype=dtype)
    q, k, v = (flat[1 + i * B * L * H * D:1 + (i + 1) * B * L * H * D].view(B, L, H, D) for i in range(3))
    assert q.data_ptr() % 16
    for causal in (False, True):
        assert_flash_close(kernels.flash_attention(q, k, v, causal=causal),
                           kernels.flash_attention_reference(q, k, v, causal=causal))


# (M, K, N): ViT-B/16's fc1 at batch 32, the ResNet-50 head, the LM's qkv, one row
K2_MODEL_SHAPES = [(6304, 768, 3072), (32, 2048, 1000), (16, 512, 1536), (1, 768, 3072)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32], ids=["bf16", "f16", "f32"])
@pytest.mark.parametrize("shape", K2_MODEL_SHAPES, ids=["fc1", "head", "qkv", "row"])
def test_int8_matmul_tensor_core_shapes_repeat_bit_for_bit(dtype, shape):
    """The model shapes in every x dtype (split K at the small-M ones):
    within the bars of the plain version, and two calls give the same bits
    (the slices are added in a fixed order)."""
    _need_card()
    m, k, n = shape
    x, w_q, scale = _k2_inputs(m, k, n, dtype, seed=m + n)
    first = kernels.int8_matmul(x, w_q, scale)
    second = kernels.int8_matmul(x, w_q, scale)
    ref = kernels.int8_matmul_reference(x, w_q, scale)
    torch.cuda.synchronize()
    assert_k2_close(first, ref)
    assert torch.equal(first.view(torch.uint8), second.view(torch.uint8))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32], ids=["bf16", "f16", "f32"])
@pytest.mark.parametrize("m,k,n", [(129, 31, 130), (7, 1000, 257), (300, 4097, 20), (1, 8, 1), (64, 520, 1003)])
def test_int8_matmul_tensor_core_ragged_edges(dtype, m, k, n):
    """M, N and K off every tile edge; K deep enough at (300, 4097) to split;
    w rows of odd width (element loads of w) at N = 257 and 1003."""
    _need_card()
    x, w_q, scale = _k2_inputs(m, k, n, dtype, seed=m * 7 + k)
    assert_k2_close(kernels.int8_matmul(x, w_q, scale), kernels.int8_matmul_reference(x, w_q, scale))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32], ids=["bf16", "f16", "f32"])
@pytest.mark.parametrize("n", [1536, 1544], ids=["w16", "w8"])
def test_int8_matmul_tensor_core_unsplit_every_output_dtype(dtype, n):
    """Enough output tiles to run without split K, so the epilogue goes
    straight from the accumulators: every output dtype, w rows aligned to
    16 and to 8 bytes (N = 1544), and the same bits on a second call."""
    _need_card()
    m, k = 2048, 256
    x, w_q, scale = _k2_inputs(m, k, n, dtype, seed=n)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert kernels.k2_splits(m, n, k, sms, kernels.K2_DEPTH[dtype]) == 1
    for out_dtype in (torch.float32, torch.bfloat16, torch.float16):
        got = kernels.int8_matmul(x, w_q, scale, out_dtype=out_dtype)
        again = kernels.int8_matmul(x, w_q, scale, out_dtype=out_dtype)
        assert got.dtype == out_dtype and torch.equal(got, again)
        assert_k2_close(got, kernels.int8_matmul_reference(x, w_q, scale, out_dtype))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_int8_matmul_tensor_core_misaligned_x_and_split_k(dtype):
    """x rows that are not 16-byte aligned (element loads) at a split-K
    shape, and every output dtype."""
    _need_card()
    m, k, n = 32, 2048, 1000
    x, w_q, scale = _k2_inputs(m, k, n, dtype, seed=31)
    wide = torch.zeros(m, k + 3, dtype=dtype, device="cuda")
    wide[:, 1:k + 1] = x
    view = wide[:, 1:k + 1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert view.data_ptr() % 16 and kernels.k2_splits(m, n, k, sms, kernels.K2_DEPTH[dtype]) > 1
    for out_dtype in (torch.float32, torch.bfloat16, torch.float16):
        got = kernels.int8_matmul(view, w_q, scale, out_dtype=out_dtype)
        assert got.dtype == out_dtype
        assert_k2_close(got, kernels.int8_matmul_reference(x, w_q, scale, out_dtype))


def test_one_length_bucket_by_default_on_the_card(monkeypatch):
    """With ``SELDON_TPU_CTX_BUCKETS`` unset a CUDA engine runs one bucket
    (``ROADMAP.md`` C19): no bucketed chunk on a bimodal batch, K4 once
    per layer per step."""
    _need_card()
    monkeypatch.delenv("SELDON_TPU_CTX_BUCKETS", raising=False)
    monkeypatch.delenv("SELDON_TPU_PAGED_KERNEL", raising=False)
    monkeypatch.delenv("SELDON_TPU_CHUNK_IMPL", raising=False)
    cfg = dict(vocab_size=128, d_model=64, num_layers=2, num_heads=4, max_len=512)
    eng = PagedEngine(load_lm_params("", cfg, 0), dtype="bfloat16", device="cuda", page_size=16, max_slots=4,
                      steps_per_call=4, prefix_cache=False, **cfg)
    rng = np.random.default_rng(4)
    kernels.reset_launch_counts()
    for p in (6, 9, 300, 330):
        eng.submit(rng.integers(0, 128, p), max_new_tokens=16)
    eng.run()
    torch.cuda.synchronize()
    stats = eng.engine_stats()
    steps = sum(int(k) * v for k, v in stats["chunk_steps"].items())
    assert stats["ctx_buckets"] == 1 and stats["bucketed_chunks"] == 0 and steps > 0
    assert kernels.launch_counts()["paged_decode_stream"] == cfg["num_layers"] * steps


def test_speculative_decoding_on_the_card(monkeypatch):
    """In float32 with TF32 off: the speculative engine and the generator
    give the plain engine's greedy tokens; the engine's verify rounds
    launch no K4, the generator's draft model K4 once per draft layer per
    one-token forward."""
    from seldon_core_tpu_torch.models.speculative import SpeculativeGenerator

    _need_card()
    monkeypatch.delenv("SELDON_TPU_PAGED_KERNEL", raising=False)
    cfg = dict(vocab_size=128, d_model=64, num_layers=2, num_heads=4, max_len=256)
    draft_cfg = dict(cfg, num_layers=1)
    params = load_lm_params("", cfg, 0, torch.device("cuda"))
    draft = load_lm_params("", draft_cfg, 1, torch.device("cuda"))
    base = np.tile(np.arange(8) + 3, 8)
    prompts = [base[: 20 + 7 * i] for i in range(3)]
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        plain = PagedEngine(params, dtype="float32", device="cuda", page_size=16, max_slots=4, **cfg)
        want = [plain.generate(p, max_new_tokens=24).tolist() for p in prompts]
        spec = PagedEngine(params, dtype="float32", device="cuda", page_size=16, max_slots=4,
                           speculative={"draft": "ngram", "draft_k": 4}, **cfg)
        kernels.reset_launch_counts()
        streams = [spec.submit(p, max_new_tokens=24) for p in prompts]
        spec.run()
        torch.cuda.synchronize()
        assert [s.result.tolist() for s in streams] == want
        assert sum(kernels.launch_counts().values()) == 0 and spec.engine_stats()["spec_accepted"] > 0
        gen = SpeculativeGenerator(params, dtype="float32", device="cuda", page_size=16, draft="model",
                                   draft_params=draft, draft_config=draft_cfg, **cfg)
        assert gen._use_kernel
        kernels.reset_launch_counts()
        got = [gen.generate(p, 24).tolist() for p in prompts]
        torch.cuda.synchronize()
        assert got == want
        assert kernels.launch_counts()["paged_decode_stream"] == draft_cfg["num_layers"] * gen.single_token_forwards > 0
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def test_migration_and_the_kv_tier_on_the_card(monkeypatch, tmp_path):
    """In float32 with TF32 off, on the kernel lane: a sampled stream moved
    mid-decode between two CUDA engines (its CUDA generator's state in
    the payload) finishes with the uninterrupted run's tokens, and its
    resumed decode launches K4 once a layer a decode call; a CPU
    generator's state sent to a CUDA engine is a 400; a promoted tier
    chain decodes the tokens of a full prefill."""
    from seldon_core_tpu_torch.codec.bufview import pack_kv_migration, unpack_kv_migration
    from seldon_core_tpu_torch.runtime import MicroserviceError

    _need_card()
    monkeypatch.delenv("SELDON_TPU_PAGED_KERNEL", raising=False)
    cfg = dict(vocab_size=128, d_model=64, num_layers=2, num_heads=4, max_len=256)
    params = load_lm_params("", cfg, 0, torch.device("cuda"))
    prompt = np.arange(40) % 128
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        def make(**kw):
            return PagedEngine(params, dtype="float32", device="cuda", page_size=16, max_slots=4, **cfg, **kw)

        sampling = dict(seed=3, temperature=0.9, top_k=8)
        want = make().generate(prompt, max_new_tokens=24, **sampling)
        a, b = make(), make()
        s = a.submit(prompt, max_new_tokens=24, **sampling)
        for _ in range(2):
            a.step()
        assert 0 < len(s.tokens) < 24
        (payload, stream), = a.migrate_export()
        assert payload["key_data"].size * 4 == torch.cuda.default_generators[0].get_state().numel()
        b.migrate_import(payload, stream=stream)
        calls0 = sum(int(k) * v for k, v in b.engine_stats()["chunk_steps"].items())
        kernels.reset_launch_counts()
        b.run()
        torch.cuda.synchronize()
        calls = sum(int(k) * v for k, v in b.engine_stats()["chunk_steps"].items()) - calls0
        assert s.result.tolist() == want.tolist()
        assert kernels.launch_counts()["paged_decode_stream"] == cfg["num_layers"] * calls > 0
        cpu_state = torch.Generator().manual_seed(3).get_state().numpy()
        bad = dict(unpack_kv_migration(pack_kv_migration(payload)), key_data=cpu_state.view(np.uint32))
        with pytest.raises(MicroserviceError) as err:
            make().migrate_import(bad)
        assert err.value.status_code == 400 and err.value.reason == "RNG_STATE_MISMATCH"
        monkeypatch.setenv("SELDON_TPU_KV_OFFLOAD", "1")
        tier = make(num_pages=6, max_steps_per_call=4)
        monkeypatch.setenv("SELDON_TPU_KV_OFFLOAD", "0")
        full = make()
        sessions = [np.arange(70) % 128, (np.arange(70) * 7 + 1) % 128]
        for _round in range(2):
            for p in sessions:
                assert tier.generate(p, max_new_tokens=4).tolist() == full.generate(p, max_new_tokens=4).tolist()
        assert tier.engine_stats()["kv_tier_host_hits"] > 0
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def test_nan_screen_and_records_on_the_card(monkeypatch):
    """In float32 with TF32 off, on the kernel lane: one ``paged.nan``
    retires one stream 500 ``NUMERIC_POISON`` through the chunk's NaN
    column and leaves the others' tokens equal to an uninjected run;
    every flight-recorder record names the kernel lane, and K4 launches
    once a layer a decode call."""
    from seldon_core_tpu_torch.utils import faults

    _need_card()
    monkeypatch.delenv("SELDON_TPU_PAGED_KERNEL", raising=False)
    cfg = dict(vocab_size=128, d_model=64, num_layers=2, num_heads=4, max_len=256)
    params = load_lm_params("", cfg, 0, torch.device("cuda"))
    prompts = [np.arange(20 + 7 * i) % 128 for i in range(4)]
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        def run(eng):
            streams = [eng.submit(p, max_new_tokens=16) for p in prompts]
            eng.run()
            return streams

        want = [s.result.tolist() for s in run(PagedEngine(params, dtype="float32", device="cuda", page_size=16,
                                                           max_slots=4, **cfg))]
        eng = PagedEngine(params, dtype="float32", device="cuda", page_size=16, max_slots=4, **cfg)
        kernels.reset_launch_counts()
        faults.configure("paged.nan:times=1")
        try:
            streams = run(eng)
        finally:
            faults.clear()
        torch.cuda.synchronize()
        stats = eng.engine_stats(detail=True)
        hit = [i for i, s in enumerate(streams) if s.error is not None]
        assert len(hit) == 1 and streams[hit[0]].error.reason == "NUMERIC_POISON" and stats["quarantined"] == 1
        assert all(streams[i].result.tolist() == want[i] for i in range(4) if i not in hit)
        assert stats["recorder"] and all(r["kernel_active"] == 1 for r in stats["recorder"])
        calls = sum(int(k) * v for k, v in stats["chunk_steps"].items()) + stats["bucketed_steps"]
        assert kernels.launch_counts()["paged_decode_stream"] == cfg["num_layers"] * calls > 0
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
