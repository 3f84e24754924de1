#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (``seldon_core_tpu_torch``) only, and imports nothing of
JAX or of the JAX package.  Phases, each of which fails the run:

1. card report (``nvidia-smi`` name and power limit);
2. build every CUDA kernel of the main paths from ``ops/csrc``, one
   ``nvcc`` per source, all started together;
3. ``fused_normalize`` (K1) against its plain PyTorch version on the
   card, bit for bit, at the main path's shapes and at ragged ones;
   kernel, plain and library-call times (CUDA events, median of 100, L2
   flushed before each launch) beside the bound (bytes moved over the
   card's memory rate);
3b. the paged-decode kernels K4 (``stream``) and K5 (``grid``) against
   their plain version on the card: the serving shape (16 lanes, 8
   heads of 64, pages of 64, 16-page tables, random non-contiguous page
   ids, ragged lengths 0..1024) and a small ragged one (head_dim 16,
   pages of 8), bf16 and f32 pages; largest |kernel - plain| over finite
   entries within 1e-4 of the largest |plain|, -inf and 0 exactly where
   the plain version has them, no NaN; kernel, plain and library
   (gather + scaled_dot_product_attention) times at uniform length 512
   and at the ragged lengths, beside the bound;
3c. the flash-attention kernel K3 against its plain version on the card
   (TF32 off for matmul and cuDNN): the ViT-B/16 serving shape (32, 197,
   12, 64) bf16 non-causal, also as the strided views of the qkv split;
   (4, 1024, 8, 64) bf16 causal; (2, 50, 2, 16) and (1, 1, 1, 8) f32,
   causal and not; head_dim 128 in bf16 and 40 in f16.  float32: the
   largest |kernel - plain| within 1e-5 of the largest |plain|; bf16 /
   f16: one step of the format (rtol 2**-7 / 2**-10) with a floor at one
   step of 2**-8 of the largest |plain|; no NaN.  Kernel, plain and
   ``F.scaled_dot_product_attention`` times (median of 100, L2 flushed)
   beside the bound, at the serving and the causal shape;
4. the main path: the microservice CLI serving ResNet-50 (224x224x3,
   1000 classes, bf16, normalize=true, max_batch_size=32, seeded random
   weights with live residual branches) over REST as a subprocess; uint8
   ``rawTensor`` requests (a batch of 8 and 8 concurrent single images)
   must give 1000 finite logits per row, and every row must agree with an
   in-process model of the same weights; ``/metrics`` must show batching;
   the server's kernel launch counts, taken just before and just after
   the traffic, must show every kernel launched;
5. whole-path numerics in-process: bf16 with the kernels against f32
   with the plain versions (TF32 off), relative L2 error <= 5e-2 and
   per-row cosine similarity >= 0.99;
6. numbers: p50/p99 latency of 1000 sequential single-image requests,
   img/s of batch-32 requests from 4 clients over a 10 s window, device
   forward time, and a profiler breakdown;
7. the generation path: the CLI serving ``StreamingLM`` (vocab 16384,
   d_model 512, 8 layers, 8 heads, max_len 1024, pages of 64, 16 slots,
   8 steps a chunk, 64 new tokens, bf16, seeded random weights) over
   REST as a subprocess; 16 concurrent greedy requests (prompts of 16 to
   700 tokens) return 64 ids each, in the vocabulary; 8 sequential
   single requests equal an in-process ``PagedEngine`` of the same
   weights, each prompt alone, bit for bit; at least 75% of the
   concurrent rows equal theirs too; a repeated request is identical;
   the server's K4 launches grow by at least 8 layers x the decode
   steps it took; numbers: REST p50/p99 over 200 sequential requests
   (prompt 128, 32 new) and REST tokens/s of 16 closed-loop clients
   over 10 s;
8. engine numerics in-process: in f32 the kernel lane, the gather lane
   (``SELDON_TPU_PAGED_KERNEL=0``) and the grid kernel give identical
   greedy tokens for 16 ragged prompts (K5's launches counted there);
   bf16 kernel lane against f32 gather lane on the first decode step's
   logits, relative L2 <= 5e-2 and per-row cosine >= 0.99; numbers:
   decode tokens/s at 16 slots (prompt 128, 128 new tokens, full run
   minus prefill and one chunk), prefill ms for 16 x 128, and a profile
   of one decode chunk (device time by kernel, K4's share, idle share);
9. the ViT path: the CLI serving ViT-B/16 (224x224x3, 1000 classes, d768,
   12 layers of 12 heads of 64, 197 tokens, bf16, normalize=true,
   max_batch_size=32, ``{"attention": "flash"}``, seeded random weights)
   over REST as a subprocess; uint8 ``rawTensor`` requests (a batch of 8
   and 8 concurrent single images) give 1000 finite logits per row, each
   within relative L2 2e-2 of an in-process model of the same weights and
   nearer its own image's answer than any other's; the server's
   ``flash_attention`` launches grow by exactly 12 x the batches served
   and ``fused_normalize``'s by the batch count; numbers: p50/p99 of 500
   sequential single images, img/s of batch-32 requests from 4 clients
   over 10 s, and the device time of the in-process forward at batch 1
   and 32 from the profiler, with K3's share and the idle share;
10. transformer numerics in-process: ViT-B/16 bf16 with K3 against f32
   with plain attention (TF32 off), relative L2 <= 5e-2 and per-row
   cosine >= 0.99; ``transformer_lm`` (the generation config) served by
   an in-process ``CudaServer`` with ``attention=flash`` (causal K3, 8
   launches a forward) against the plain model in f32, within 1e-4.

Output: the ``nvidia-smi`` line, then one ``{"kernels": [...]}`` line,
then the last line ``{"ok": true, "device": {...}}``.  Exits non-zero,
printing no result, when CUDA is unavailable or the port is not beside
this script.
"""

from __future__ import annotations

import base64
import contextlib
import json
import os
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
MODEL_PARAMS = [
    {"name": "model", "value": "resnet50", "type": "STRING"},
    {"name": "normalize", "value": "true", "type": "BOOL"},
    {"name": "dtype", "value": "bfloat16", "type": "STRING"},
    {"name": "max_batch_size", "value": "32", "type": "INT"},
]
IMG = (224, 224, 3)
NUM_CLASSES = 1000
SEED = 0
LATENCY_REQUESTS = 1000         # p99 rests on the 10 slowest
THROUGHPUT_CLIENTS = 4
THROUGHPUT_SECONDS = 10.0
# tolerances, stated before any run
SERVED_VS_LOCAL_REL_L2 = 2e-2   # each bf16 served row vs in-process bf16, same weights
CROSS_ROW_MIN_REL_L2 = 2 * SERVED_VS_LOCAL_REL_L2  # two images' answers must differ by more
WHOLE_PATH_REL_L2 = 5e-2        # bf16 + kernel vs f32 + plain, same weights
WHOLE_PATH_MIN_COS = 0.99
# the generation cell: the repo's generation serving config (bench.py
# generation phase, docs/architecture.md: B=16, d512/L8, vocab 16k)
LM_CONFIG = dict(vocab_size=16384, d_model=512, num_layers=8, num_heads=8, max_len=1024)
LM_ENGINE = dict(page_size=64, max_slots=16, steps_per_call=8)
LM_MAX_NEW = 64
LM_PARAMS = [{"name": k, "value": str(v), "type": "INT"}
             for k, v in {**LM_CONFIG, **LM_ENGINE, "max_new_tokens": LM_MAX_NEW}.items()]
# the ViT cell: the JAX registry's vit_base16 (ViT-Base/16, Dosovitskiy et al.
# 2020, Table 1) served with flash attention
VIT_PARAMS = [
    {"name": "model", "value": "vit_base16", "type": "STRING"},
    {"name": "normalize", "value": "true", "type": "BOOL"},
    {"name": "dtype", "value": "bfloat16", "type": "STRING"},
    {"name": "max_batch_size", "value": "32", "type": "INT"},
    {"name": "model_kwargs", "value": json.dumps({"attention": "flash"}), "type": "JSON"},
]
VIT_LAYERS = 12
VIT_LATENCY_REQUESTS = 500
FLASH_CASES = [  # (B, L, H, D, dtype name, causal, strided qkv views)
    (32, 197, 12, 64, "bfloat16", False, False),
    (32, 197, 12, 64, "bfloat16", False, True),
    (4, 1024, 8, 64, "bfloat16", True, False),
    (2, 50, 2, 16, "float32", False, False),
    (2, 50, 2, 16, "float32", True, False),
    (1, 1, 1, 8, "float32", False, False),
    (1, 1, 1, 8, "float32", True, False),
    (2, 197, 4, 128, "bfloat16", False, False),
    (2, 130, 3, 40, "float16", True, False),
]
FLASH_F32_REL_TOL = 1e-5        # largest |kernel - plain| / largest |plain|
FLASH_STEP = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}  # one step of the format, relative
LM_FLASH_ATOL = 1e-4            # f32 logits, causal K3 vs plain attention
BF16_PEAK_FLOPS = 989e12        # H100 SXM dense bf16 tensor cores (data sheet)
RAGGED_LENGTHS = [0, 1, 63, 64, 65, 127, 128, 200, 333, 511, 512, 640, 777, 900, 1000, 1024]
PAGED_CASES = [  # (lanes, heads, head_dim, page_size, table pages, lengths)
    (16, 8, 64, 64, 16, RAGGED_LENGTHS),
    (5, 2, 16, 8, 6, [0, 1, 8, 9, 48]),
]
PAGED_REL_TOL = 1e-4            # largest |kernel - plain| over finite entries / largest |plain|
GEN_MIN_IDENTICAL_SHARE = 0.75  # concurrent served rows equal to the in-process rows
GEN_LATENCY_REQUESTS = 200
GEN_CLIENTS = 16
GEN_SECONDS = 10.0
F32_PEAK_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores (data sheet)


class SmokeFailure(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------- phase 1

def card_report(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    props = torch.cuda.get_device_properties(0)
    # HBM is double data rate: bytes/s = 2 * clock * bus width / 8
    mem_bytes_per_s = 2.0 * props.memory_clock_rate * 1e3 * props.memory_bus_width / 8
    log(f"card: {smi_line} | torch: {name} | {props.multi_processor_count} SMs | "
        f"memory {mem_bytes_per_s / 1e12:.3f} TB/s (clock {props.memory_clock_rate} kHz, "
        f"bus {props.memory_bus_width} bit) | torch {torch.__version__} cuda {torch.version.cuda}")
    return smi_line, name, mem_bytes_per_s


# ---------------------------------------------------------------- timing

def time_cuda(torch, fn, reps: int = 100, warm: int = 5, flush_mb: int = 256) -> float:
    """Median ms of one call, CUDA events around each, L2 flushed before
    each (a 256 MB write keeps the GPU busy while the host enqueues, so
    host overhead stays out of the measured span; a wrapper whose host
    work is longer needs a longer write, ``flush_mb``)."""
    flush = torch.empty(flush_mb * 1024 * 1024, dtype=torch.uint8, device="cuda")
    for _ in range(warm):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for i in range(reps):
        flush.zero_()
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


# ---------------------------------------------------------------- phase 3

def kernel_checks(torch, np, kernels, mem_bytes_per_s):
    shapes = [(32, *IMG), (1, *IMG), (3, 5, 7, 1), (2, 9, 11, 4)]
    dtypes = [torch.bfloat16, torch.float16, torch.float32]
    bits = {torch.bfloat16: torch.int16, torch.float16: torch.int16, torch.float32: torch.int32}
    rng = np.random.default_rng(SEED)
    max_err = 0.0
    inputs = {}
    for shape in shapes:
        c = shape[-1]
        if c == 3:
            scale, shift = kernels.imagenet_affine()
        else:
            scale = rng.uniform(0.001, 0.05, c).astype(np.float32)
            shift = rng.uniform(-2.0, 1.0, c).astype(np.float32)
        x = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).cuda()
        s, b = torch.from_numpy(scale).cuda(), torch.from_numpy(shift).cuda()
        inputs[shape] = (x, s, b)
        for dt in dtypes:
            got = kernels.fused_normalize(x, s, b, dt)
            ref = kernels.fused_normalize_reference(x, s, b, dt)
            torch.cuda.synchronize()
            check(got.shape == x.shape and got.dtype == dt and got.is_contiguous(),
                  f"fused_normalize {shape} {dt}: bad output {tuple(got.shape)} {got.dtype}")
            same = torch.equal(got.view(bits[dt]), ref.view(bits[dt]))
            err = (got.float() - ref.float()).abs().max().item()
            max_err = max(max_err, err)
            log(f"fused_normalize {shape} -> {str(dt)[6:]}: bit-identical={same} max_abs_err={err}")
            check(same, f"fused_normalize {shape} {dt} differs from its plain version (max {err})")

    timings = {}
    for batch in (32, 1):
        x, s, b = inputs[(batch, *IMG)]
        lib_out = torch.empty(x.shape, dtype=torch.bfloat16, device="cuda")

        def library():
            # one PyTorch call for the same function: shift + x * scale,
            # u8 promoted to f32, cast to bf16 on store
            torch.addcmul(b, x, s, out=lib_out)

        library()
        lib_err = (lib_out.float() - kernels.fused_normalize_reference(x, s, b, torch.bfloat16).float()
                   ).abs().max().item()
        ms = time_cuda(torch, lambda: kernels.fused_normalize(x, s, b, torch.bfloat16))
        plain_ms = time_cuda(torch, lambda: kernels.fused_normalize_reference(x, s, b, torch.bfloat16))
        library_ms = time_cuda(torch, library)
        n = x.numel()
        bound_bytes = n * (1 + 2) + 2 * s.numel() * 4  # u8 in, bf16 out, scale+shift
        # 2 f32 flops per element; 67 TFLOP/s f32 (non-tensor-core) peak
        bound_ms = max(bound_bytes / mem_bytes_per_s, 2 * n / 67e12) * 1e3
        timings[batch] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                          "bound_ms": bound_ms, "bytes": bound_bytes}
        log(f"fused_normalize ({batch},224,224,3) u8->bf16: kernel {ms * 1e3:.2f} us, "
            f"plain chain {plain_ms * 1e3:.2f} us, torch.addcmul(out=bf16) {library_ms * 1e3:.2f} us "
            f"(max abs diff from the plain version {lib_err}), bound {bound_ms * 1e3:.2f} us "
            f"({bound_bytes} bytes; {bound_ms / ms * 100:.1f}% of the memory roofline)")
    return max_err, timings


# ---------------------------------------------------------------- phase 3b

@contextlib.contextmanager
def knob_env(**values):
    """Set SELDON_TPU_* knobs for a block (None unsets), then restore them."""
    before = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
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


def paged_inputs(torch, np, B, h, hd, ps, P, lengths, dtype, seed):
    """q, pages, tables with random non-contiguous page ids, lengths."""
    rng = np.random.default_rng(seed)
    num_pages = B * P + 1
    pk = rng.standard_normal((num_pages, ps, h, hd), dtype=np.float32)
    pv = rng.standard_normal((num_pages, ps, h, hd), dtype=np.float32)
    q = rng.standard_normal((B, h, hd), dtype=np.float32) * 0.125
    tables = rng.permutation(np.arange(1, num_pages)).reshape(B, P).astype(np.int32)
    out = [torch.from_numpy(a).to(dtype).cuda() for a in (q, pk, pv)]
    return out + [torch.from_numpy(tables).cuda(), torch.tensor(lengths, dtype=torch.int32).cuda()]


def compare_flash_state(torch, got, ref, what):
    """-> (largest abs error, largest relative error) over acc, m, l."""
    worst_abs = worst_rel = 0.0
    for name, g, r in zip(("acc", "m", "l"), got, ref):
        check(g.shape == r.shape and g.dtype == torch.float32, f"{what} {name}: bad output {tuple(g.shape)}")
        check(not bool(torch.isnan(g).any()), f"{what} {name}: NaN in the kernel's output")
        special = torch.isinf(r) | (r == 0)
        check(bool(torch.equal(g[special], r[special])), f"{what} {name}: -inf/0 differ from the plain version")
        fin = ~special
        if bool(fin.any()):
            err = (g[fin] - r[fin]).abs().max().item()
            worst_abs = max(worst_abs, err)
            worst_rel = max(worst_rel, err / r[fin].abs().max().item())
    return worst_abs, worst_rel


def paged_bound(B, h, hd, ps, P, lengths, elt, mem_bytes_per_s):
    """Least time for one call: the live pages' K and V, q, the tables and
    lengths read once, acc/m/l written once, over the memory rate; the
    4 * len * h * hd flops over the f32 peak (far below)."""
    live = [min(max(n, 0), P * ps) for n in lengths]
    kv = sum(-(-n // ps) for n in live) * ps * h * hd * 2 * elt
    nbytes = kv + B * h * hd * elt + B * P * 4 + B * 4 + B * h * hd * 4 + 2 * B * h * 4
    flops = sum(4 * n * h * hd for n in live)
    return max(nbytes / mem_bytes_per_s, flops / F32_PEAK_FLOPS) * 1e3, nbytes


def paged_kernel_checks(torch, np, kernels, mem_bytes_per_s):
    errs = {impl: {"max_abs_err": 0.0, "max_rel_err": 0.0} for impl in ("stream", "grid")}
    for case, (B, h, hd, ps, P, lengths) in enumerate(PAGED_CASES):
        for dtype in (torch.bfloat16, torch.float32):
            args = paged_inputs(torch, np, B, h, hd, ps, P, lengths, dtype, seed=case)
            ref = kernels.paged_attention_decode_reference(*args, page_size=ps)
            for impl in ("stream", "grid"):
                with knob_env(SELDON_TPU_PAGED_KERNEL_IMPL=impl):
                    got = kernels.paged_attention_decode(*args, page_size=ps)
                torch.cuda.synchronize()
                what = f"paged_decode_{impl} B={B} h={h} hd={hd} ps={ps} P={P} {str(dtype)[6:]}"
                err_abs, err_rel = compare_flash_state(torch, got, ref, what)
                log(f"{what}: max_abs_err={err_abs:.3e} max_rel_err={err_rel:.3e} (limit {PAGED_REL_TOL})")
                check(err_rel <= PAGED_REL_TOL, f"{what} differs from its plain version: {err_rel}")
                e = errs[impl]
                e["max_abs_err"], e["max_rel_err"] = max(e["max_abs_err"], err_abs), max(e["max_rel_err"], err_rel)

    import torch.nn.functional as F

    B, h, hd, ps, P, _ = PAGED_CASES[0]
    timings = {}
    for label, lengths in (("uniform512", [512] * B), ("ragged", RAGGED_LENGTHS)):
        q, pk, pv, tables, lens = paged_inputs(torch, np, B, h, hd, ps, P, lengths, torch.bfloat16, seed=7)
        T = P * ps
        mask = (torch.arange(T, device=lens.device)[None, :] < lens[:, None])[:, None, None, :]

        def library():
            # the closest PyTorch calls: gather the pages, then one fused
            # attention over the length mask (normalised output)
            gk = pk[tables].reshape(B, T, h, hd).transpose(1, 2)
            gv = pv[tables].reshape(B, T, h, hd).transpose(1, 2)
            return F.scaled_dot_product_attention(q[:, :, None, :], gk, gv, attn_mask=mask, scale=1.0)

        row = {}
        for impl in ("stream", "grid"):
            with knob_env(SELDON_TPU_PAGED_KERNEL_IMPL=impl):
                row[impl] = time_cuda(torch, lambda: kernels.paged_attention_decode(q, pk, pv, tables, lens,
                                                                                     page_size=ps), flush_mb=1024)
        row["plain_ms"] = time_cuda(torch, lambda: kernels.paged_attention_decode_reference(
            q, pk, pv, tables, lens, page_size=ps), reps=20)
        row["library_ms"] = time_cuda(torch, library, flush_mb=1024)
        row["bound_ms"], row["bytes"] = paged_bound(B, h, hd, ps, P, lengths, 2, mem_bytes_per_s)
        timings[label] = row
        log(f"paged decode bf16 B={B} h={h} hd={hd} ps={ps} P={P} {label}: K4 stream {row['stream'] * 1e3:.2f} us, "
            f"K5 grid {row['grid'] * 1e3:.2f} us, plain {row['plain_ms'] * 1e3:.2f} us, gather + SDPA (two calls, "
            f"normalised) {row['library_ms'] * 1e3:.2f} us, bound {row['bound_ms'] * 1e3:.2f} us "
            f"({row['bytes']} bytes)")
    return errs, timings


# ---------------------------------------------------------------- phase 3c

@contextlib.contextmanager
def no_tf32(torch):
    """float32 matmuls and convolutions in full float32 for a block."""
    before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before


def flash_inputs(torch, np, B, L, H, D, dtype, strided, seed):
    """q, k, v on the card; `strided`: the three views of one qkv tensor."""
    rng = np.random.default_rng(seed)
    if strided:
        qkv = torch.from_numpy(rng.standard_normal((B, L, 3 * H * D), dtype=np.float32)).to(dtype).cuda()
        return [t.reshape(B, L, H, D) for t in qkv.split(H * D, dim=-1)]
    return [torch.from_numpy(rng.standard_normal((B, L, H, D), dtype=np.float32)).to(dtype).cuda()
            for _ in range(3)]


def flash_bound(B, L, H, D, causal, elt, mem_bytes_per_s):
    """Least time for one call: q, k, v read once and o written once over
    the memory rate, against the 4 * B * H * D flops per (query, live key)
    pair (L * (L + 1) / 2 pairs when causal) over the bf16 tensor-core
    peak; -> (ms, "bytes" or "operations", bytes, flops)."""
    nbytes = 4 * B * L * H * D * elt
    pairs = L * (L + 1) // 2 if causal else L * L
    flops = 4 * B * H * D * pairs
    t_bytes, t_ops = nbytes / mem_bytes_per_s, flops / BF16_PEAK_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def flash_kernel_checks(torch, np, kernels, mem_bytes_per_s):
    import torch.nn.functional as F

    worst = {"max_abs_err": 0.0, "max_rel_err": 0.0}
    with no_tf32(torch):
        for case, (B, L, H, D, dt, causal, strided) in enumerate(FLASH_CASES):
            q, k, v = flash_inputs(torch, np, B, L, H, D, getattr(torch, dt), strided, seed=100 + case)
            got = kernels.flash_attention(q, k, v, causal=causal)
            ref = kernels.flash_attention_reference(q, k, v, causal=causal)
            torch.cuda.synchronize()
            what = f"flash_attention {(B, L, H, D)} {dt} causal={causal}{' qkv-split views' if strided else ''}"
            check(got.shape == ref.shape and got.dtype == ref.dtype, f"{what}: bad output {tuple(got.shape)}")
            g, r = got.float(), ref.float()
            check(not bool(torch.isnan(g).any()), f"{what}: NaN in the kernel's output")
            err = (g - r).abs()
            peak = r.abs().max().item()
            rel = err.max().item() / peak
            if dt == "float32":
                ok, limit = rel <= FLASH_F32_REL_TOL, f"{FLASH_F32_REL_TOL} of max |plain|"
            else:
                step = FLASH_STEP[dt]
                ok = bool((err <= step * r.abs() + step * 2.0 ** -8 * peak).all())
                limit = f"one {dt} step, rtol {step}, floor {step * 2.0 ** -8:.3e} x max |plain|"
            log(f"{what}: max_abs_err={err.max().item():.3e} max|plain|={peak:.3e} rel={rel:.3e} ({limit})")
            check(ok, f"{what} differs from its plain version")
            worst["max_abs_err"] = max(worst["max_abs_err"], err.max().item())
            worst["max_rel_err"] = max(worst["max_rel_err"], rel)

        timings = {}
        for label, (B, L, H, D, causal) in (("serving", (32, 197, 12, 64, False)), ("causal", (4, 1024, 8, 64, True))):
            q, k, v = flash_inputs(torch, np, B, L, H, D, torch.bfloat16, False, seed=7)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))  # (B, H, L, D) views for the library call
            row = {
                "ms": time_cuda(torch, lambda: kernels.flash_attention(q, k, v, causal=causal)),
                "plain_ms": time_cuda(torch, lambda: kernels.flash_attention_reference(q, k, v, causal=causal)),
                "library_ms": time_cuda(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)),
                "shape": [B, L, H, D], "causal": causal,
            }
            row["bound_ms"], row["bound_by"], row["bytes"], row["flops"] = flash_bound(B, L, H, D, causal, 2,
                                                                                         mem_bytes_per_s)
            timings[label] = row
            log(f"flash_attention bf16 {(B, L, H, D)} causal={causal}: kernel {row['ms'] * 1e3:.2f} us, plain "
                f"{row['plain_ms'] * 1e3:.2f} us, F.scaled_dot_product_attention {row['library_ms'] * 1e3:.2f} us, "
                f"bound {row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}: {row['bytes']} bytes, "
                f"{row['flops']} flops; {row['bound_ms'] / row['ms'] * 100:.1f}% of the roofline)")
    return worst, timings


# ---------------------------------------------------------------- phase 4 + 6

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http(url: str, body=None, timeout: float = 120.0):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        raw = r.read()
    return raw if url.endswith("/metrics") else json.loads(raw)


def raw_request(np, images):
    return {"data": {"rawTensor": {
        "shape": list(images.shape), "dtype": "uint8",
        "data": base64.b64encode(np.ascontiguousarray(images).tobytes()).decode("ascii"),
    }}}


def decode_logits(np, resp, rows: int):
    check("data" in resp and "rawTensor" in resp["data"], f"response carries no rawTensor: {str(resp)[:300]}")
    r = resp["data"]["rawTensor"]
    arr = np.frombuffer(base64.b64decode(r["data"]), dtype=np.dtype(r["dtype"])).reshape(r["shape"])
    check(arr.shape == (rows, NUM_CLASSES), f"expected ({rows}, {NUM_CLASSES}) logits, got {arr.shape}")
    check(bool(np.isfinite(arr).all()), "non-finite logits in a served answer")
    return arr


def metrics_values(text: bytes):
    out = {}
    for line in text.decode().splitlines():
        if line and not line.startswith("#"):
            key, _, val = line.rpartition(" ")
            out[key] = float(val)
    return out


def start_server(port: int, logfile, component: str = "seldon_core_tpu_torch.models.cudaserver.CudaServer",
                 params=MODEL_PARAMS):
    cmd = [sys.executable, "-m", "seldon_core_tpu_torch.runtime.microservice", component, "--api", "REST",
           "--host", "127.0.0.1", "--http-port", str(port), "--parameters", json.dumps(params)]
    return subprocess.Popen(cmd, cwd=ROOT, stdout=logfile, stderr=subprocess.STDOUT,
                            start_new_session=True)


def wait_ready(proc, base: str, logpath: str, timeout_s: float = 600.0):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout_s:
        if proc.poll() is not None:
            raise SmokeFailure(f"server exited with {proc.returncode}:\n{tail(logpath)}")
        try:
            status = http(base + "/health/status", timeout=5)
            if status.get("jsonData", {}).get("loaded"):
                return status["jsonData"], time.perf_counter() - t0
        except (urllib.error.URLError, ConnectionError, OSError):
            pass
        time.sleep(1.0)
    raise SmokeFailure(f"server not ready after {timeout_s}s:\n{tail(logpath)}")


def tail(path: str, n: int = 40) -> str:
    with open(path, errors="replace") as f:
        return "".join(f.readlines()[-n:])


def stop_server(proc) -> None:
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGTERM)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=30)


def pct(values, q: float) -> float:
    import math

    v = sorted(values)
    return v[max(0, math.ceil(q * len(v)) - 1)]


def distinct_images(np, rng, n: int):
    """uint8 images that differ in per-channel level as well as in noise,
    so a random-weight model gives each a clearly different answer and a
    row served to the wrong request cannot pass the per-row check."""
    level = rng.integers(0, 160, (n, 1, 1, IMG[-1]))
    noise = rng.integers(0, 96, (n, *IMG))
    return (level + noise).astype(np.uint8)


def rel_l2(np, a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def concurrent(fn, n: int):
    """Run fn(i) for i < n on n threads at once; returns the results in
    order and re-raises the first failure."""
    results, errors = [None] * n, []

    def run(i):
        try:
            results[i] = fn(i)
        except Exception as e:  # noqa: BLE001 — re-raised below, on the caller's thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


def served_rows_check(torch, np, kernels, resnet, base, rng):
    """A batch of 8 and 8 concurrent single images, every served row held
    against an in-process model with the server's weights."""
    eight = distinct_images(np, rng, 8)
    served_eight = decode_logits(np, http(base + "/predict", raw_request(np, eight)), 8)
    singles = distinct_images(np, rng, 8)
    answers = concurrent(lambda i: http(base + "/predict", raw_request(np, singles[i:i + 1])), 8)
    served_singles = np.concatenate([decode_logits(np, a, 1) for a in answers])

    # the server's weights in-process: the same seeded init, residual branches live
    local = resnet.ResNet50(num_classes=NUM_CLASSES, dtype=torch.bfloat16)
    local.reset_parameters(torch.Generator().manual_seed(SEED), zero_init_residual=False)
    local = local.cuda().eval().to(memory_format=torch.channels_last)
    scale, shift = (torch.from_numpy(a).cuda() for a in kernels.imagenet_affine())
    errs, cross = [], []
    for images, served in ((eight, served_eight), (singles, served_singles)):
        with torch.inference_mode():
            x = kernels.fused_normalize(torch.from_numpy(images).cuda(), scale, shift, torch.bfloat16)
            ref = local(x).double().cpu().numpy()
        errs += [rel_l2(np, served[i], ref[i]) for i in range(len(ref))]
        cross += [rel_l2(np, ref[i], ref[j]) for i in range(len(ref)) for j in range(len(ref)) if i != j]
    log(f"served vs in-process bf16, {len(errs)} rows (batch of 8 + 8 concurrent singles): max row rel L2 "
        f"{max(errs):.3e} (limit {SERVED_VS_LOCAL_REL_L2}); least rel L2 between two images' answers "
        f"{min(cross):.3e} (must exceed {CROSS_ROW_MIN_REL_L2})")
    check(min(cross) > CROSS_ROW_MIN_REL_L2,
          f"the test images' answers are too alike to tell a row mix-up apart: {min(cross)}")
    check(max(errs) <= SERVED_VS_LOCAL_REL_L2, f"served rows disagree with the in-process model: {errs}")
    return max(errs)


def latency_window(np, base, rng, n: int):
    """REST latency of n sequential single-image requests, in ms."""
    bodies = [raw_request(np, rng.integers(0, 256, (1, *IMG), dtype=np.uint8)) for _ in range(16)]
    for body in bodies:  # warm the client and server sides
        decode_logits(np, http(base + "/predict", body), 1)
    lat = []
    for i in range(n):
        t0 = time.perf_counter()
        decode_logits(np, http(base + "/predict", bodies[i % len(bodies)]), 1)
        lat.append((time.perf_counter() - t0) * 1e3)
    return lat


def throughput_window(np, base, rng, clients: int, seconds: float):
    """img/s of batch-32 requests from `clients` closed-loop clients that
    send until `seconds` have passed; the in-flight requests finish and
    count, and the wall clock runs until the last one returns."""
    bodies = [raw_request(np, rng.integers(0, 256, (32, *IMG), dtype=np.uint8)) for _ in range(clients)]
    decode_logits(np, http(base + "/predict", bodies[0]), 32)  # warm the client side
    t0 = time.perf_counter()

    def client(k):
        n = 0
        while time.perf_counter() - t0 < seconds:
            decode_logits(np, http(base + "/predict", bodies[k]), 32)
            n += 1
        return n

    requests = sum(concurrent(client, clients))
    wall = time.perf_counter() - t0
    return requests * 32 / wall, requests, wall


def main_path(torch, np, kernels, resnet, card):
    rng = np.random.default_rng(SEED + 1)
    port = free_port()
    base = f"http://127.0.0.1:{port}"
    fd, logpath = tempfile.mkstemp(prefix="chip_smoke_server_", suffix=".log")
    logfile = os.fdopen(fd, "w")
    proc = start_server(port, logfile)
    try:
        status, ready_s = wait_ready(proc, base, logpath)
        log(f"server ready in {ready_s:.1f}s (load {status['load_time_s']:.1f}s, buckets {status['buckets']}, "
            f"device {status['device_name']})")
        check(status["device"].startswith("cuda"), f"server is not on the card: {status['device']}")
        m0 = metrics_values(http(base + "/metrics"))
        before = status["kernel_launches"]

        served_err = served_rows_check(torch, np, kernels, resnet, base, rng)
        lat = latency_window(np, base, rng, LATENCY_REQUESTS)
        img_s, b32_requests, b32_wall = throughput_window(np, base, rng, THROUGHPUT_CLIENTS, THROUGHPUT_SECONDS)

        after = http(base + "/health/status")["jsonData"]["kernel_launches"]
        m1 = metrics_values(http(base + "/metrics"))
    finally:
        stop_server(proc)
        logfile.close()
    launches = {k: after[k] - before.get(k, 0) for k in after}
    batches = m1["cudaserver_batches_total"] - m0["cudaserver_batches_total"]
    log(f"main path: {int(batches)} batches, mean rows/batch {m1['cudaserver_mean_batch_rows']:.2f}, "
        f"kernel launches {launches}")
    check(batches > 0 and m1["cudaserver_mean_batch_rows"] > 1.0, f"/metrics shows no batching: {m1}")
    check(launches["fused_normalize"] > 0, "kernel fused_normalize was not launched on the main path")
    numbers = {
        "batches": batches, "launches_per_batch": {k: n / batches for k, n in launches.items()},
        "served_max_row_rel_l2": served_err,
        "p50_ms": pct(lat, 0.50), "p99_ms": pct(lat, 0.99), "n_latency": len(lat),
        "batch32_img_s": img_s, "batch32_requests": b32_requests, "batch32_wall_s": b32_wall,
        "clients": THROUGHPUT_CLIENTS,
    }
    log(f"REST single-image latency over {len(lat)} sequential requests: p50 {numbers['p50_ms']:.2f} ms, "
        f"p99 {numbers['p99_ms']:.2f} ms; batch-32 throughput ({THROUGHPUT_CLIENTS} clients, "
        f"{b32_requests} requests in {b32_wall:.2f} s): {img_s:.1f} img/s [{card}]")
    return launches, numbers


# ---------------------------------------------------------------- phase 5 + 6

def whole_path(torch, np, kernels, resnet, card):
    rng = np.random.default_rng(SEED + 2)
    images = torch.from_numpy(rng.integers(0, 256, (8, *IMG), dtype=np.uint8)).cuda()
    scale, shift = (torch.from_numpy(a).cuda() for a in kernels.imagenet_affine())

    def build(dtype):
        m = resnet.ResNet50(num_classes=NUM_CLASSES, dtype=dtype)
        # every residual branch live (no zero-initialised BatchNorm scale)
        m.reset_parameters(torch.Generator().manual_seed(SEED + 3), zero_init_residual=False)
        return m.cuda().eval().to(memory_format=torch.channels_last)

    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        with torch.inference_mode():
            ref = build(torch.float32)(
                kernels.fused_normalize_reference(images, scale, shift, torch.float32)).double().cpu()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    model = build(torch.bfloat16)
    with torch.inference_mode():
        got = model(kernels.fused_normalize(images, scale, shift, torch.bfloat16)).double().cpu()
    check(bool(torch.isfinite(got).all()) and got.shape == (8, NUM_CLASSES), "bad bf16 whole-path logits")
    rel = float((got - ref).norm() / ref.norm())
    cos = float(torch.nn.functional.cosine_similarity(got, ref, dim=-1).min())
    log(f"whole path bf16+kernel vs f32+plain (TF32 off), ResNet-50 batch 8: rel L2 {rel:.3e} "
        f"(limit {WHOLE_PATH_REL_L2}), min row cosine {cos:.6f} (limit {WHOLE_PATH_MIN_COS})")
    check(rel <= WHOLE_PATH_REL_L2 and cos >= WHOLE_PATH_MIN_COS, "whole-path numerics out of tolerance")

    # device time of the served program (normalize + ResNet-50), in-process
    fwd = {}
    for batch in (1, 32):
        x = torch.from_numpy(rng.integers(0, 256, (batch, *IMG), dtype=np.uint8)).cuda()

        def step():
            with torch.inference_mode():
                model(kernels.fused_normalize(x, scale, shift, torch.bfloat16))

        fwd[batch] = time_cuda(torch, step, reps=30, warm=5)
        log(f"device forward (normalize + ResNet-50 bf16) batch {batch}: {fwd[batch]:.3f} ms "
            f"= {batch / fwd[batch] * 1e3:.1f} img/s [{card}]")

    x = torch.from_numpy(rng.integers(0, 256, (32, *IMG), dtype=np.uint8)).cuda()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            with torch.inference_mode():
                model(kernels.fused_normalize(x, scale, shift, torch.bfloat16))
        torch.cuda.synchronize()
    log("profile, 3 forwards at batch 32, top device time:")
    log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=12, max_name_column_width=60))
    return {"rel_l2": rel, "min_cos": cos, "forward_ms": fwd}


# ---------------------------------------------------------------- phase 7

def gen_request(np, base, prompt, max_new: int = LM_MAX_NEW, timeout: float = 300.0):
    """One greedy generation request over REST; returns its (max_new,) ids."""
    body = {"data": {"ndarray": [[int(t) for t in prompt]]}}
    if max_new != LM_MAX_NEW:
        body["meta"] = {"tags": {"max_new_tokens": max_new}}
    resp = http(base + "/predict", body, timeout=timeout)
    check("data" in resp and "ndarray" in resp["data"], f"response carries no ndarray: {str(resp)[:300]}")
    row = np.asarray(resp["data"]["ndarray"], np.int64)
    check(row.shape == (1, max_new), f"expected (1, {max_new}) ids, got {row.shape}")
    check(bool(((row >= 0) & (row < LM_CONFIG["vocab_size"])).all()), "served ids outside the vocabulary")
    return row[0]


def gen_latency(np, base, prompts, n: int, max_new: int):
    for p in prompts[:4]:  # warm the client side
        gen_request(np, base, p, max_new)
    lat = []
    for i in range(n):
        t0 = time.perf_counter()
        gen_request(np, base, prompts[i % len(prompts)], max_new)
        lat.append((time.perf_counter() - t0) * 1e3)
    return lat


def gen_throughput(np, base, prompts, clients: int, seconds: float, max_new: int):
    """Generated tokens/s of `clients` closed-loop clients sending until
    `seconds` have passed; in-flight requests finish and count."""
    t0 = time.perf_counter()

    def client(k):
        n = 0
        while time.perf_counter() - t0 < seconds:
            gen_request(np, base, prompts[(k + n) % len(prompts)], max_new)
            n += 1
        return n

    requests = sum(concurrent(client, clients))
    wall = time.perf_counter() - t0
    return requests * max_new / wall, requests, wall


def lm_engine(PagedEngine, params, dtype):
    return PagedEngine(params, dtype=dtype, device="cuda", **LM_CONFIG, **LM_ENGINE)


def generation_path(torch, np, PagedEngine, load_lm_params, card):
    """The served generation path, rows held against an in-process engine."""
    rng = np.random.default_rng(SEED + 20)
    V = LM_CONFIG["vocab_size"]
    conc_prompts = [rng.integers(0, V, int(n)) for n in np.linspace(16, 700, 16)]
    single_prompts = [rng.integers(0, V, n) for n in (20, 64, 65, 128, 200, 333, 511, 640)]
    bench_prompts = [rng.integers(0, V, 128) for _ in range(16)]
    port = free_port()
    base = f"http://127.0.0.1:{port}"
    fd, logpath = tempfile.mkstemp(prefix="chip_smoke_lm_server_", suffix=".log")
    logfile = os.fdopen(fd, "w")
    proc = start_server(port, logfile, "seldon_core_tpu_torch.models.paged.StreamingLM", LM_PARAMS)
    try:
        status, ready_s = wait_ready(proc, base, logpath)
        log(f"StreamingLM ready in {ready_s:.1f}s (load {status['load_time_s']:.1f}s, device "
            f"{status['device_name']}, kernel lane {status['kernel_active']})")
        check(status["device"].startswith("cuda") and status["kernel_active"],
              f"the generation server is not on the card's kernel lane: {status}")
        before, chunks0 = status["kernel_launches"], status["engine"]["chunks"]
        served_conc = concurrent(lambda i: gen_request(np, base, conc_prompts[i]), len(conc_prompts))
        served_single = [gen_request(np, base, p) for p in single_prompts]
        repeat = gen_request(np, base, single_prompts[3])
        after_status = http(base + "/health/status")["jsonData"]
        lat = gen_latency(np, base, bench_prompts, GEN_LATENCY_REQUESTS, 32)
        tok_s, tp_requests, tp_wall = gen_throughput(np, base, bench_prompts, GEN_CLIENTS, GEN_SECONDS, 32)
    finally:
        stop_server(proc)
        logfile.close()
    after = after_status["kernel_launches"]
    launches = {k: after[k] - before.get(k, 0) for k in after}
    steps = (after_status["engine"]["chunks"] - chunks0) * LM_ENGINE["steps_per_call"]
    log(f"generation path: {steps} decode steps, kernel launches {launches}")
    check(steps > 0 and launches["paged_decode_stream"] >= LM_CONFIG["num_layers"] * steps,
          f"K4 was not launched on every layer of every decode step: {launches}, {steps} steps")
    check(bool((repeat == served_single[3]).all()), "a repeated greedy request changed its answer")

    # the server's weights in-process (its default seed 0), each prompt alone
    eng = lm_engine(PagedEngine, load_lm_params("", LM_CONFIG, 0, torch.device("cuda")), "bfloat16")
    local_single = [eng.generate(p, max_new_tokens=LM_MAX_NEW) for p in single_prompts]
    local_conc = [eng.generate(p, max_new_tokens=LM_MAX_NEW) for p in conc_prompts]
    del eng
    torch.cuda.empty_cache()
    same_single = [bool((a == b).all()) for a, b in zip(served_single, local_single)]
    share = float(np.mean([bool((a == b).all()) for a, b in zip(served_conc, local_conc)]))
    log(f"served vs in-process engine, each prompt alone: {sum(same_single)}/{len(same_single)} sequential rows "
        f"bit-identical; concurrent rows identical share {share:.3f} (limit {GEN_MIN_IDENTICAL_SHARE})")
    check(all(same_single), f"sequential served rows differ from the in-process engine: {same_single}")
    check(share >= GEN_MIN_IDENTICAL_SHARE, f"too few concurrent rows equal the in-process engine: {share}")
    numbers = {
        "decode_steps": steps, "launches": launches, "concurrent_identical_share": share,
        "rest_p50_ms": pct(lat, 0.50), "rest_p99_ms": pct(lat, 0.99), "n_latency": len(lat),
        "rest_tokens_per_s": tok_s, "rest_requests": tp_requests, "rest_wall_s": tp_wall,
        "clients": GEN_CLIENTS,
    }
    log(f"generation REST over {len(lat)} sequential requests (prompt 128, 32 new): p50 "
        f"{numbers['rest_p50_ms']:.2f} ms, p99 {numbers['rest_p99_ms']:.2f} ms; {GEN_CLIENTS} closed-loop clients: "
        f"{tok_s:.1f} tokens/s ({tp_requests} requests in {tp_wall:.2f} s) [{card}]")
    return launches, numbers


# ---------------------------------------------------------------- phase 8

def device_time_by_name(prof):
    """-> ({name: (device us, count)}, busy us) of a profiler run.  Device
    time two ways: the device-side events (kernels, copies, fills), and
    the kernels the profiler files under the host op that launched them;
    the fuller of the two is the breakdown."""
    from torch.autograd import DeviceType

    views = ({}, {})
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, n = views[0].get(e.name, (0.0, 0))
            views[0][e.name] = (us + e.time_range.elapsed_us(), n + 1)
        for k in getattr(e, "kernels", None) or ():
            us, n = views[1].get(k.name, (0.0, 0))
            views[1][k.name] = (us + k.duration, n + 1)
    totals = [sum(us for us, _ in v.values()) for v in views]
    log(f"profiler device time: {totals[0] / 1e3:.3f} ms in {sum(n for _, n in views[0].values())} device events, "
        f"{totals[1] / 1e3:.3f} ms in {sum(n for _, n in views[1].values())} kernels under host ops")
    return (views[0] if totals[0] >= totals[1] else views[1]), max(totals)


def first_step_logits(torch, np, eng, prompts, tokens):
    """Prefill `prompts` (one per slot), then one decode step of `tokens`
    on the engine's own lane; returns its (slots, vocab) logits."""
    for p in prompts:
        eng.submit(p, max_new_tokens=1)
    with eng._lock:
        admitted = eng._admit_locked()
    check(len(admitted) == len(prompts), "not every prompt was admitted")
    with torch.inference_mode():
        eng._prefill(admitted)
        lengths = torch.from_numpy(eng._lengths.copy()).cuda()
        width = eng._pages_horizon(admitted, 1)
        tables = torch.from_numpy(np.ascontiguousarray(eng._block_tables[:, :width])).cuda()
        logits, _, _ = eng.module(tokens[:, None], lengths[:, None], eng.pages_k, eng.pages_v, tables, lengths,
                                  use_kernel=eng._kernel_active)
    return logits[:, 0].double().cpu()


def engine_numerics(torch, np, kernels, PagedEngine, load_lm_params, card):
    rng = np.random.default_rng(SEED + 30)
    V = LM_CONFIG["vocab_size"]
    prompts = [rng.integers(0, V, int(n)) for n in np.linspace(16, 700, 16)]
    params = load_lm_params("", LM_CONFIG, SEED + 5, torch.device("cuda"))

    def tokens(**env):
        with knob_env(**env):
            eng = lm_engine(PagedEngine, params, "float32")
            streams = [eng.submit(p, max_new_tokens=16) for p in prompts]
            eng.run()
        return np.stack([s.result for s in streams]), eng._kernel_active

    k_stream, lane = tokens(SELDON_TPU_PAGED_KERNEL=None, SELDON_TPU_PAGED_KERNEL_IMPL="stream")
    gather, lane0 = tokens(SELDON_TPU_PAGED_KERNEL="0")
    kernels.reset_launch_counts()
    k_grid, lane_grid = tokens(SELDON_TPU_PAGED_KERNEL=None, SELDON_TPU_PAGED_KERNEL_IMPL="grid")
    grid_launches = kernels.launch_counts()["paged_decode_grid"]
    check(lane and lane_grid and not lane0, "the f32 engines did not take the lanes asked for")
    log(f"f32 greedy, 16 ragged prompts x 16 tokens: K4 lane == gather lane {bool((k_stream == gather).all())}, "
        f"K4 == K5 {bool((k_stream == k_grid).all())} (K5 launches {grid_launches})")
    check(bool((k_stream == gather).all()), "f32 kernel lane and gather lane disagree on greedy tokens")
    check(bool((k_stream == k_grid).all()), "f32 stream and grid kernels disagree on greedy tokens")
    check(grid_launches > 0, "the grid engine launched no K5")

    step_tokens = torch.from_numpy(rng.integers(0, V, len(prompts))).cuda()
    with knob_env(SELDON_TPU_PAGED_KERNEL=None, SELDON_TPU_PAGED_KERNEL_IMPL="stream"):
        got = first_step_logits(torch, np, lm_engine(PagedEngine, params, "bfloat16"), prompts, step_tokens)
    with knob_env(SELDON_TPU_PAGED_KERNEL="0"):
        ref = first_step_logits(torch, np, lm_engine(PagedEngine, params, "float32"), prompts, step_tokens)
    torch.cuda.empty_cache()
    rel = float((got - ref).norm() / ref.norm())
    cos = float(torch.nn.functional.cosine_similarity(got, ref, dim=-1).min())
    log(f"first decode step, bf16 kernel lane vs f32 gather lane: rel L2 {rel:.3e} (limit {WHOLE_PATH_REL_L2}), "
        f"min row cosine {cos:.6f} (limit {WHOLE_PATH_MIN_COS})")
    check(bool(torch.isfinite(got).all()), "non-finite bf16 decode logits")
    check(rel <= WHOLE_PATH_REL_L2 and cos >= WHOLE_PATH_MIN_COS, "bf16 decode numerics out of tolerance")
    return grid_launches, {"rel_l2": rel, "min_cos": cos}


def engine_numbers(torch, np, PagedEngine, load_lm_params, card):
    """In-process bf16 numbers at 16 slots: decode tokens/s (prompt 128,
    128 new: full run minus prefill and one chunk, min of 3 each),
    prefill ms for 16 x 128, and a profile of one decode chunk."""
    rng = np.random.default_rng(SEED + 40)
    prompts = rng.integers(0, LM_CONFIG["vocab_size"], (LM_ENGINE["max_slots"], 128))
    eng = lm_engine(PagedEngine, load_lm_params("", LM_CONFIG, 0, torch.device("cuda")), "bfloat16")

    def run(max_new):
        t0 = time.perf_counter()
        streams = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
        eng.run()
        check(all(s.result.shape == (max_new,) for s in streams), "bad in-process generation")
        return time.perf_counter() - t0

    run(128)
    run(1)
    dt_p1 = min(run(1) for _ in range(3))
    dt_full = min(run(128) for _ in range(3))
    decode_tok_s = len(prompts) * 127 / max(dt_full - dt_p1, 1e-9)

    prefill_ms = float("inf")
    for _ in range(3):
        for p in prompts:
            eng.submit(p, max_new_tokens=1)
        with eng._lock:
            admitted = eng._admit_locked()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            eng._prefill(admitted)
        torch.cuda.synchronize()
        prefill_ms = min(prefill_ms, (time.perf_counter() - t0) * 1e3)
        eng.run()

    from torch.profiler import ProfilerActivity, profile

    for p in prompts:
        eng.submit(p, max_new_tokens=128)
    eng.step()  # admission, prefill and the first chunk
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()  # one decode chunk (its readback synchronises)
        chunk_ms = (time.perf_counter() - t0) * 1e3
    eng.run()

    by_name, busy_us = device_time_by_name(prof)
    k4_us = sum(us for name, (us, _) in by_name.items() if "paged_decode_stream" in name)
    launches = sum(n for _, n in by_name.values())
    log(f"profile of one decode chunk ({LM_ENGINE['steps_per_call']} steps, 16 lanes, prompt 128): wall "
        f"{chunk_ms:.3f} ms, {launches} device events, device busy {busy_us / 1e3:.3f} ms, idle share "
        f"{1 - busy_us / 1e3 / chunk_ms:.3f}, K4 {k4_us / 1e3:.3f} ms ({k4_us / max(busy_us, 1e-9):.3f} of device "
        f"time)")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        log(f"  {us / 1e3:9.3f} ms  {n:6d}x  {us / max(busy_us, 1e-9):6.3f}  {name[:90]}")
    check(launches > 0, "the profiler recorded no device event in the decode chunk")
    del eng
    torch.cuda.empty_cache()
    numbers = {
        "decode_tokens_per_s": decode_tok_s, "full_run_s": dt_full, "prefill_plus_chunk_s": dt_p1,
        "prefill_ms_16x128": prefill_ms, "chunk_wall_ms": chunk_ms, "chunk_device_busy_ms": busy_us / 1e3,
        "chunk_idle_share": 1 - busy_us / 1e3 / chunk_ms, "k4_share_of_device_time": k4_us / max(busy_us, 1e-9),
        "chunk_device_events": launches,
    }
    log(f"in-process bf16, 16 slots, prompt 128, 128 new: decode {decode_tok_s:.1f} tokens/s, prefill 16x128 "
        f"{prefill_ms:.3f} ms [{card}]")
    return numbers


# ---------------------------------------------------------------- phase 9

def vit_model(torch, kernels, vit, dtype, flash: bool, seed: int):
    """ViT-B/16 in-process with the server's seeded init."""
    attn = {"attn_fn": kernels.flash_attn_fn()} if flash else {}
    model = vit.ViTBase16(num_classes=NUM_CLASSES, dtype=dtype, **attn)
    return model.reset_parameters(torch.Generator().manual_seed(seed)).cuda().eval()


def vit_path(torch, np, kernels, vit, card):
    """The served ViT-B/16 path, rows held against an in-process model."""
    rng = np.random.default_rng(SEED + 50)
    port = free_port()
    base = f"http://127.0.0.1:{port}"
    fd, logpath = tempfile.mkstemp(prefix="chip_smoke_vit_server_", suffix=".log")
    logfile = os.fdopen(fd, "w")
    proc = start_server(port, logfile, params=VIT_PARAMS)
    try:
        status, ready_s = wait_ready(proc, base, logpath)
        log(f"ViT-B/16 server ready in {ready_s:.1f}s (load {status['load_time_s']:.1f}s, buckets "
            f"{status['buckets']}, device {status['device_name']})")
        check(status["device"].startswith("cuda"), f"the ViT server is not on the card: {status['device']}")
        m0 = metrics_values(http(base + "/metrics"))
        before = status["kernel_launches"]
        groups = [distinct_images(np, rng, 8), distinct_images(np, rng, 8)]
        served = [decode_logits(np, http(base + "/predict", raw_request(np, groups[0])), 8)]
        answers = concurrent(lambda i: http(base + "/predict", raw_request(np, groups[1][i:i + 1])), 8)
        served.append(np.concatenate([decode_logits(np, a, 1) for a in answers]))
        lat = latency_window(np, base, rng, VIT_LATENCY_REQUESTS)
        img_s, b32_requests, b32_wall = throughput_window(np, base, rng, THROUGHPUT_CLIENTS, THROUGHPUT_SECONDS)
        after = http(base + "/health/status")["jsonData"]["kernel_launches"]
        m1 = metrics_values(http(base + "/metrics"))
    finally:
        stop_server(proc)
        logfile.close()
    launches = {k: after[k] - before.get(k, 0) for k in after}
    batches = int(m1["cudaserver_batches_total"] - m0["cudaserver_batches_total"])
    log(f"ViT path: {batches} batches, mean rows/batch {m1['cudaserver_mean_batch_rows']:.2f}, kernel launches "
        f"{launches}")
    check(batches > 0, "the ViT server served no batch")
    check(launches["flash_attention"] == VIT_LAYERS * batches,
          f"flash_attention launches {launches['flash_attention']} != {VIT_LAYERS} x {batches} batches")
    check(launches["fused_normalize"] == batches,
          f"fused_normalize launches {launches['fused_normalize']} != {batches} batches")

    # the server's weights in-process (its default seed 0), each group as one batch
    local = vit_model(torch, kernels, vit, torch.bfloat16, True, SEED)
    scale, shift = (torch.from_numpy(a).cuda() for a in kernels.imagenet_affine())
    refs = []
    with torch.inference_mode():
        for images in groups:
            x = kernels.fused_normalize(torch.from_numpy(images).cuda(), scale, shift, torch.bfloat16)
            refs.append(local(x).double().cpu().numpy())
    served_all, ref_all = np.concatenate(served), np.concatenate(refs)
    n = len(ref_all)
    errs = [rel_l2(np, served_all[i], ref_all[i]) for i in range(n)]
    nearest = [int(np.argmin([rel_l2(np, served_all[i], ref_all[j]) for j in range(n)])) for i in range(n)]
    cross = min(rel_l2(np, ref_all[i], ref_all[j]) for i in range(n) for j in range(n) if i != j)
    log(f"ViT served vs in-process bf16, {n} rows (batch of 8 + 8 concurrent singles): max row rel L2 "
        f"{max(errs):.3e} (limit {SERVED_VS_LOCAL_REL_L2}); every row nearest its own image's answer: "
        f"{nearest == list(range(n))}; least rel L2 between two images' answers {cross:.3e}")
    check(max(errs) <= SERVED_VS_LOCAL_REL_L2, f"served ViT rows disagree with the in-process model: {errs}")
    check(nearest == list(range(n)), f"a served ViT row is nearer another image's answer: {nearest}")
    numbers = {
        "batches": batches, "launches": launches, "served_max_row_rel_l2": max(errs),
        "least_cross_row_rel_l2": cross,
        "p50_ms": pct(lat, 0.50), "p99_ms": pct(lat, 0.99), "n_latency": len(lat),
        "batch32_img_s": img_s, "batch32_requests": b32_requests, "batch32_wall_s": b32_wall,
        "clients": THROUGHPUT_CLIENTS,
    }
    log(f"ViT-B/16 REST single-image latency over {len(lat)} sequential requests: p50 {numbers['p50_ms']:.2f} ms, "
        f"p99 {numbers['p99_ms']:.2f} ms; batch-32 throughput ({THROUGHPUT_CLIENTS} clients, {b32_requests} "
        f"requests in {b32_wall:.2f} s): {img_s:.1f} img/s [{card}]")
    return local, numbers


def vit_forward_profile(torch, np, kernels, model, card):
    """Device time of the served program (K1 + ViT-B/16 bf16 with K3) at
    batch 1 and 32: event-timed forward, and a profile of 5 forwards
    (device busy per forward, K3's share, idle share)."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(SEED + 51)
    scale, shift = (torch.from_numpy(a).cuda() for a in kernels.imagenet_affine())
    out = {}
    for batch in (1, 32):
        x = torch.from_numpy(rng.integers(0, 256, (batch, *IMG), dtype=np.uint8)).cuda()

        def step():
            with torch.inference_mode():
                model(kernels.fused_normalize(x, scale, shift, torch.bfloat16))

        forward_ms = time_cuda(torch, step, reps=30, warm=5)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(5):
                step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        by_name, busy_us = device_time_by_name(prof)
        k3_us = sum(us for name, (us, _) in by_name.items() if "flash_attention" in name)
        k3_n = sum(n for name, (_, n) in by_name.items() if "flash_attention" in name)
        row = {"forward_ms": forward_ms, "device_busy_ms_per_forward": busy_us / 5e3,
               "k3_share_of_device_time": k3_us / max(busy_us, 1e-9), "k3_launches_profiled": k3_n,
               "profiled_wall_ms_per_forward": wall_ms / 5, "idle_share": 1 - busy_us / 1e3 / wall_ms}
        out[batch] = row
        log(f"ViT-B/16 forward (K1 + bf16 ViT with K3) batch {batch}: event-timed {forward_ms:.3f} ms "
            f"= {batch / forward_ms * 1e3:.1f} img/s; profiled: device busy {row['device_busy_ms_per_forward']:.3f} "
            f"ms a forward, K3 {row['k3_share_of_device_time']:.3f} of it ({k3_n} launches in 5 forwards), idle "
            f"share {row['idle_share']:.3f} [{card}]")
        for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
            log(f"  {us / 5e3:9.3f} ms/fwd  {n // 5:5d}x  {us / max(busy_us, 1e-9):6.3f}  {name[:90]}")
        check(k3_n == 5 * VIT_LAYERS, f"the profile shows {k3_n} K3 launches in 5 forwards")
    return out


# ---------------------------------------------------------------- phase 10

def transformer_numerics(torch, np, kernels, vit, transformer, CudaServer, card):
    """ViT-B/16 bf16 + K3 against f32 + plain attention; the causal K3
    lane of transformer_lm against the plain model, both f32."""
    rng = np.random.default_rng(SEED + 60)
    images = torch.from_numpy(rng.integers(0, 256, (8, *IMG), dtype=np.uint8)).cuda()
    scale, shift = (torch.from_numpy(a).cuda() for a in kernels.imagenet_affine())
    with no_tf32(torch), torch.inference_mode():
        ref_model = vit_model(torch, kernels, vit, torch.float32, False, SEED + 3)
        ref = ref_model(kernels.fused_normalize_reference(images, scale, shift, torch.float32)).double().cpu()
        del ref_model
        model = vit_model(torch, kernels, vit, torch.bfloat16, True, SEED + 3)
        got = model(kernels.fused_normalize(images, scale, shift, torch.bfloat16)).double().cpu()
        del model
    check(bool(torch.isfinite(got).all()) and got.shape == (8, NUM_CLASSES), "bad bf16 ViT logits")
    rel = float((got - ref).norm() / ref.norm())
    cos = float(torch.nn.functional.cosine_similarity(got, ref, dim=-1).min())
    log(f"ViT-B/16 bf16 + K1 + K3 vs f32 + plain versions (TF32 off), batch 8: rel L2 {rel:.3e} (limit "
        f"{WHOLE_PATH_REL_L2}), min row cosine {cos:.6f} (limit {WHOLE_PATH_MIN_COS})")
    check(rel <= WHOLE_PATH_REL_L2 and cos >= WHOLE_PATH_MIN_COS, "ViT numerics out of tolerance")

    seq = 256
    tokens = rng.integers(0, LM_CONFIG["vocab_size"], (2, seq)).astype(np.int32)
    with no_tf32(torch):
        cs = CudaServer(model="transformer_lm", input_shape=[seq], dtype="float32", max_batch_size=2,
                        warmup_dtypes=("int32",), seed=SEED + 6, model_kwargs={**LM_CONFIG, "attention": "flash"})
        cs.load()
        try:
            before = kernels.launch_counts()["flash_attention"]
            flash = cs.predict(tokens, [])
            lm_launches = kernels.launch_counts()["flash_attention"] - before
        finally:
            cs.unload()
        del cs
        plain_lm = transformer.TransformerLM(dtype=torch.float32, **LM_CONFIG)
        plain_lm = plain_lm.reset_parameters(torch.Generator().manual_seed(SEED + 6)).cuda().eval()
        with torch.inference_mode():
            plain = plain_lm(torch.from_numpy(tokens).cuda()).cpu().numpy()
        del plain_lm
    torch.cuda.empty_cache()
    err = float(np.abs(flash - plain).max())
    log(f"transformer_lm served in-process with attention=flash (causal K3, {lm_launches} launches for one batch "
        f"of 2 x {seq}) vs plain attention, f32: max abs logit diff {err:.3e} (limit {LM_FLASH_ATOL}), max |logit| "
        f"{float(np.abs(plain).max()):.3f}")
    check(flash.shape == plain.shape == (2, seq, LM_CONFIG["vocab_size"]), f"bad LM logits {flash.shape}")
    check(lm_launches == LM_CONFIG["num_layers"], f"causal K3 launched {lm_launches} times, not once per layer")
    check(err <= LM_FLASH_ATOL, "causal flash LM differs from the plain LM")
    return {"vit_rel_l2": rel, "vit_min_cos": cos, "lm_max_abs_err": err, "lm_launches": lm_launches}


# ---------------------------------------------------------------- main

def run() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: FAIL: torch is not importable: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: torch.cuda.is_available() is false; this smoke test needs a CUDA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        import numpy as np

        from seldon_core_tpu_torch.models import resnet, transformer, vit
        from seldon_core_tpu_torch.models.cudaserver import CudaServer
        from seldon_core_tpu_torch.models.generate import load_lm_params
        from seldon_core_tpu_torch.models.paged import PagedEngine
        from seldon_core_tpu_torch.ops import _build, kernels
    except ImportError as e:
        print(f"chip_smoke: FAIL: the port is not beside this script ({e})", file=sys.stderr)
        return 1

    t_start = time.perf_counter()
    try:
        smi_line, name, mem_bytes_per_s = card_report(torch)
        card = smi_line
        t0 = time.perf_counter()
        sources = ("fused_normalize", "paged_decode", "flash_attention")
        with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, all at once
            libs = list(pool.map(_build.build, sources))
        for source in sources:
            _build.load(source)
        log(f"built {', '.join(lib.name for lib in libs)} in {time.perf_counter() - t0:.1f}s")
        max_err, timings = kernel_checks(torch, np, kernels, mem_bytes_per_s)
        paged_errs, paged_timings = paged_kernel_checks(torch, np, kernels, mem_bytes_per_s)
        flash_errs, flash_timings = flash_kernel_checks(torch, np, kernels, mem_bytes_per_s)
        launches, numbers = main_path(torch, np, kernels, resnet, card)
        whole = whole_path(torch, np, kernels, resnet, card)
        gen_launches, gen_numbers = generation_path(torch, np, PagedEngine, load_lm_params, card)
        grid_launches, gen_numerics = engine_numerics(torch, np, kernels, PagedEngine, load_lm_params, card)
        engine = engine_numbers(torch, np, PagedEngine, load_lm_params, card)
        vit_local, vit_numbers = vit_path(torch, np, kernels, vit, card)
        vit_profile = vit_forward_profile(torch, np, kernels, vit_local, card)
        del vit_local
        torch.cuda.empty_cache()
        tf_numerics = transformer_numerics(torch, np, kernels, vit, transformer, CudaServer, card)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    t32, t1 = timings[32], timings[1]
    result = {
        "numbers": numbers,
        "whole_path": {"rel_l2": whole["rel_l2"], "min_cos": whole["min_cos"],
                       "forward_ms_b1": whole["forward_ms"][1], "forward_ms_b32": whole["forward_ms"][32]},
        "generation": gen_numbers,
        "generation_numerics": gen_numerics,
        "generation_engine": engine,
        "paged_timings": paged_timings,
        "vit": vit_numbers,
        "vit_forward": vit_profile,
        "transformer_numerics": tf_numerics,
        "flash_timings": flash_timings,
        "seconds": time.perf_counter() - t_start,
    }
    log(json.dumps(result))
    kernel_line = {"kernels": [{
        "name": "fused_normalize",
        "route": "cuda",
        "source": "seldon_core_tpu_torch/ops/csrc/fused_normalize.cu",
        "replaces": "seldon_core_tpu/ops/kernels.py:46",
        "launches": launches["fused_normalize"],
        "max_abs_err": max_err,
        "ms": t32["ms"], "plain_ms": t32["plain_ms"], "bound_ms": t32["bound_ms"],
        "bound_by": "bytes", "library_ms": t32["library_ms"], "library_call": "torch.addcmul(out=bf16)",
        "shape": [32, *IMG], "out_dtype": "bfloat16",
        "batch1": {"ms": t1["ms"], "plain_ms": t1["plain_ms"], "library_ms": t1["library_ms"],
                   "bound_ms": t1["bound_ms"]},
    }]}
    uni, rag = paged_timings["uniform512"], paged_timings["ragged"]
    B, h, hd, ps, P, _ = PAGED_CASES[0]
    for impl, line, n, where in (
            ("stream", 409, gen_launches["paged_decode_stream"], "served generation path"),
            ("grid", 343, grid_launches, "in-process PagedEngine, SELDON_TPU_PAGED_KERNEL_IMPL=grid")):
        kernel_line["kernels"].append({
            "name": f"paged_decode_{impl}",
            "route": "cuda",
            "source": "seldon_core_tpu_torch/ops/csrc/paged_decode.cu",
            "replaces": f"seldon_core_tpu/ops/kernels.py:{line}",
            "launches": n, "launches_on": where,
            "max_abs_err": paged_errs[impl]["max_abs_err"], "max_rel_err": paged_errs[impl]["max_rel_err"],
            "ms": uni[impl], "plain_ms": uni["plain_ms"], "bound_ms": uni["bound_ms"], "bound_by": "bytes",
            "library_ms": uni["library_ms"],
            "library_call": "pk[tables] gather + F.scaled_dot_product_attention (two calls, normalised)",
            "shape": [B, h, hd, ps, P], "lengths": "uniform 512", "pool_dtype": "bfloat16",
            "ragged": {"ms": rag[impl], "plain_ms": rag["plain_ms"], "library_ms": rag["library_ms"],
                       "bound_ms": rag["bound_ms"], "lengths": RAGGED_LENGTHS},
        })
    serving, causal = flash_timings["serving"], flash_timings["causal"]
    kernel_line["kernels"].append({
        "name": "flash_attention",
        "route": "cuda",
        "source": "seldon_core_tpu_torch/ops/csrc/flash_attention.cu",
        "replaces": "seldon_core_tpu/ops/kernels.py:255",
        "launches": vit_numbers["launches"]["flash_attention"],
        "launches_on": f"served ViT-B/16 REST path ({VIT_LAYERS} per batch, {vit_numbers['batches']} batches)",
        "max_abs_err": flash_errs["max_abs_err"], "max_rel_err": flash_errs["max_rel_err"],
        "ms": serving["ms"], "plain_ms": serving["plain_ms"], "bound_ms": serving["bound_ms"],
        "bound_by": serving["bound_by"], "library_ms": serving["library_ms"],
        "library_call": "F.scaled_dot_product_attention on (B, H, L, D) views",
        "shape": serving["shape"], "dtype": "bfloat16",
        "causal": {"shape": causal["shape"], "ms": causal["ms"], "plain_ms": causal["plain_ms"],
                        "library_ms": causal["library_ms"], "bound_ms": causal["bound_ms"],
                        "bound_by": causal["bound_by"], "launches": tf_numerics["lm_launches"],
                        "launches_on": "in-process CudaServer transformer_lm, attention=flash, f32"},
    })
    print(smi_line)
    print(json.dumps(kernel_line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(run())
