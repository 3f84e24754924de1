"""Hand-written CUDA kernels for serving hot ops, with their plain versions.

* ``fused_normalize`` — uint8 NHWC batch -> normalised activation dtype
  in one pass (cast + per-channel affine fused; the plain PyTorch chain
  runs a convert, a multiply, an add and a cast as four passes over
  device memory before the first convolution).
* ``int8_matmul`` (K2) — ``(x @ w_int8) * scale[col]`` with f32
  accumulation on the tensor cores, the int8 weights converted inside the
  tile, K split across blocks (fixed-order sum) when M is small;
  ``Int8Dense`` wraps it as a layer and ``quantize_weights`` converts a
  trained (K, N) kernel.
* ``flash_attention`` (K3) — blockwise attention with an online softmax
  over (batch, seq, heads, head_dim) q, k, v, causal or not, read where
  they lie (bf16 / f16 products on the tensor cores); the attention of
  every ``TransformerBlock`` served with ``"attention": "flash"`` (the
  ViTs, the encoder, the LM).
* ``paged_attention_decode`` — one decode step of attention over a paged
  K/V pool, read through the block table, as the unnormalised flash
  state ``(acc, m, l)``; the ``stream`` kernel (K4) by default, the
  ``grid`` kernel (K5) under ``SELDON_TPU_PAGED_KERNEL_IMPL=grid``; both
  read int8 pages with per-page scales (``kv_scales``), and K4 folds the
  per-lane qkv LoRA delta into the same launch (``lora``).

Every wrapper dispatches on where its input lies and on nothing else: a
CUDA tensor launches the kernel (building it at first use from
``ops/csrc``), a CPU tensor takes the plain version.  A kernel that does
not build or launch raises; it never falls back.  Each wrapper counts
its kernel launches (``launch_counts``), so a run can show that its
main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from seldon_core_tpu_torch.ops import _build
from seldon_core_tpu_torch.runtime import knobs

_COUNT_LOCK = threading.Lock()
# one entry per kernel wrapper, plus "w8a8_int_mm": the integer GEMMs of
# the w8a8 layers (``ops/w8a8.py``, ``torch._int_mm`` on either device;
# not a kernel of this repo), the evidence that the int path ran
_LAUNCHES: Dict[str, int] = {"fused_normalize": 0, "flash_attention": 0, "paged_decode_stream": 0,
                             "paged_decode_grid": 0, "paged_decode_stream_int8": 0,
                             "paged_decode_stream_lora": 0, "paged_decode_stream_int8_lora": 0,
                             "paged_decode_grid_int8": 0, "int8_matmul": 0, "w8a8_int_mm": 0}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    with _COUNT_LOCK:
        return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for k in _LAUNCHES:
            _LAUNCHES[k] = 0


def _count(name: str) -> None:
    with _COUNT_LOCK:
        _LAUNCHES[name] += 1


class KernelLaunchError(RuntimeError):
    """A CUDA kernel launch was refused or failed."""


# ---------------------------------------------------------------------------
# fused uint8 -> normalised float
# ---------------------------------------------------------------------------

# output dtype -> the kernel's out_kind code (csrc/fused_normalize.cu)
_OUT_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _check_normalize_args(x, scale, shift, out_dtype) -> None:
    if x.dtype != torch.uint8:
        raise TypeError(f"fused_normalize takes uint8 input, got {x.dtype}")
    if x.dim() < 1:
        raise ValueError("fused_normalize input needs a channel (last) dimension")
    if out_dtype not in _OUT_KINDS:
        raise TypeError(
            f"fused_normalize out_dtype must be one of {sorted(map(str, _OUT_KINDS))}, got {out_dtype}"
        )
    c = x.shape[-1]
    for name, t in (("scale", scale), ("shift", shift)):
        if tuple(t.shape) != (c,):
            raise ValueError(f"fused_normalize {name} must have shape ({c},), got {tuple(t.shape)}")


def fused_normalize_reference(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                              out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The plain PyTorch version: ``y = x * scale[c] + shift[c]`` in f32,
    then cast.  The CUDA kernel agrees with it bit for bit."""
    _check_normalize_args(x, scale, shift, out_dtype)
    y = x.to(torch.float32) * scale.to(torch.float32) + shift.to(torch.float32)
    return y.to(out_dtype)


def fused_normalize(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                    out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(batch, H, W, C) uint8 -> out_dtype, y = x * scale + shift per channel.

    scale/shift: (C,) tensors; e.g. imagenet normalisation folded into
    a = 1/(255*std), b = -mean/std (``imagenet_affine``).  The result is
    a contiguous (batch, H, W, C) tensor, so ``y.permute(0, 3, 1, 2)`` is
    an NCHW view with channels_last strides and no copy.
    """
    if not x.is_cuda:
        return fused_normalize_reference(x, scale, shift, out_dtype)
    _check_normalize_args(x, scale, shift, out_dtype)
    lib = _normalize_lib()
    x = x.contiguous()
    if x.data_ptr() % 16:  # the kernel reads 16-byte vectors
        x = x.clone()
    scale = scale.to(device=x.device, dtype=torch.float32).contiguous()
    shift = shift.to(device=x.device, dtype=torch.float32).contiguous()
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        geo = fused_normalize_grid(x, out_dtype)
        err = lib.fused_normalize_u8(
            x.data_ptr(), scale.data_ptr(), shift.data_ptr(), out.data_ptr(), x.numel(), x.shape[-1],
            _OUT_KINDS[out_dtype], geo.blocks, geo.threads, torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise KernelLaunchError(f"fused_normalize launch failed: cudaError {err}")
    _count("fused_normalize")
    return out


_NORMALIZE_THREADS = 256  # csrc/fused_normalize.cu kMaxThreads: the block of a full grid
_MAX_BLOCKS_PER_SM = 32   # resident blocks an SM holds at most (sm_90)


class NormalizeGeometry(NamedTuple):
    """K1's launch: ``blocks`` x ``threads`` threads stride over the n // 16
    whole 16-byte ``vectors`` (thread t takes vectors t, t + T, ... with T
    the grid's threads), then over the ``tail`` = n % 16 bytes one at a
    time.  The channel pattern repeats every ``unit`` = lcm(16, C) bytes
    and T * 16 is a multiple of it, so every vector of a thread starts on
    the same channel, 16 t mod C."""

    unit: int
    vectors: int
    tail: int
    threads: int
    blocks: int

    def spans(self, thread: int):
        """Byte ranges [start, end) that ``thread`` converts, in order."""
        stride, end = self.blocks * self.threads, 16 * self.vectors
        return ([(16 * v, 16 * v + 16) for v in range(thread, self.vectors, stride)]
                + [(i, i + 1) for i in range(end + thread, end + self.tail, stride)])


def normalize_geometry(n: int, c: int, sms: int, blocks_per_sm: int) -> NormalizeGeometry:
    """The grid of one K1 launch over ``n`` bytes of ``c`` channels: one
    wave, one vector a thread where one wave holds them.

    The block is the largest of 256, 128, 64, 32 threads that still gives
    min(sms, vectors // 32) blocks, so a small batch spreads over the SMs
    instead of filling a few.  A full grid (256 threads) holds
    ``sms * blocks_per_sm`` blocks, the occupancy the library reports
    (``fused_normalize_blocks_per_sm``); a smaller block holds the
    registers of a proportional share.  The block count is a multiple of
    what keeps the grid's threads a multiple of lcm(16, c) / 16.
    """
    if n < 0 or c < 1 or sms < 1 or blocks_per_sm < 1:
        raise ValueError(f"normalize_geometry: bad n={n}, c={c}, sms={sms}, blocks_per_sm={blocks_per_sm}")
    unit = 16 * c // math.gcd(16, c)
    vectors, period = n // 16, unit // 16

    def grid(threads):
        step = period // math.gcd(period, threads)  # blocks that keep the threads a multiple of the period
        resident = min(_MAX_BLOCKS_PER_SM, blocks_per_sm * _NORMALIZE_THREADS // threads)
        cap = sms * resident // step * step
        need = -(-max(1, -(-vectors // threads)) // step) * step
        return step, cap, need

    want = max(1, min(sms, vectors // 32))
    threads = next((t for t in (256, 128, 64) if -(-vectors // t) >= want and grid(t)[1] >= grid(t)[0]), 32)
    step, cap, need = grid(threads)
    return NormalizeGeometry(unit, vectors, n % 16, threads, max(step, min(need, cap)))


def fused_normalize_grid(x: torch.Tensor, out_dtype: torch.dtype) -> NormalizeGeometry:
    """The grid ``fused_normalize`` launches for the CUDA tensor ``x``; the
    caller has made ``x``'s device current."""
    index = x.device.index
    return normalize_geometry(x.numel(), x.shape[-1], _sm_count(index),
                              _normalize_occupancy(index, x.shape[-1], _OUT_KINDS[out_dtype]))


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _normalize_occupancy(device_index: int, c: int, kind: int) -> int:
    """Resident 256-thread blocks an SM holds of the body K1 launches for
    (c, kind); the caller has made the device current."""
    blocks = ctypes.c_int(0)
    err = _normalize_lib().fused_normalize_blocks_per_sm(c, kind, _NORMALIZE_THREADS, ctypes.byref(blocks))
    if err != 0 or blocks.value < 1:
        raise KernelLaunchError(f"fused_normalize occupancy query failed: cudaError {err}, {blocks.value} blocks")
    return blocks.value


def _normalize_lib() -> ctypes.CDLL:
    lib = _build.load("fused_normalize")
    fn = lib.fused_normalize_u8
    if fn.restype is not ctypes.c_int or not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, ctypes.c_longlong, i, i, i, i, p]
        fn.restype = i
        occ = lib.fused_normalize_blocks_per_sm
        occ.argtypes = [i, i, i, ctypes.POINTER(i)]
        occ.restype = i
    return lib


def imagenet_affine(mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225)) -> Tuple[np.ndarray, np.ndarray]:
    """Fold 'x/255 then standardise' into one per-channel affine."""
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    return 1.0 / (255.0 * std), -mean / std


# ---------------------------------------------------------------------------
# int8-weight matmul (K2)
# ---------------------------------------------------------------------------

# x / output dtype -> the kernel's kind code (csrc/int8_matmul.cu)
_MATMUL_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _check_int8_matmul_args(x, w_int8, scale) -> None:
    """The JAX function's errors, naming the same dims."""
    if x.dim() != 2 or w_int8.dim() != 2:
        raise ValueError(
            f"int8_matmul wants 2-D operands, got x{tuple(x.shape)} @ "
            f"w_int8{tuple(w_int8.shape)}"
        )
    m, k = x.shape
    k2, n = w_int8.shape
    if k != k2:
        raise ValueError(
            f"int8_matmul contraction mismatch: x is (M={m}, K={k}) but "
            f"w_int8 is (K={k2}, N={n}) — the inner (K) dims must agree"
        )
    if tuple(scale.shape) != (n,):
        raise ValueError(
            f"int8_matmul scale must be one f32 per output column: want "
            f"shape ({n},) to match w_int8's N={n}, got {tuple(scale.shape)}"
        )


def int8_matmul_reference(x: torch.Tensor, w_int8: torch.Tensor, scale: torch.Tensor,
                          out_dtype: torch.dtype = None) -> torch.Tensor:
    """The plain PyTorch version: ``(x.float() @ w.float()) * scale`` in
    f32, cast to ``out_dtype`` (default ``x.dtype``)."""
    _check_int8_matmul_args(x, w_int8, scale)
    y = (x.float() @ w_int8.float()) * scale.to(device=x.device, dtype=torch.float32)
    return y.to(out_dtype or x.dtype)


def int8_matmul(x: torch.Tensor, w_int8: torch.Tensor, scale: torch.Tensor,
                out_dtype: torch.dtype = None) -> torch.Tensor:
    """y = (x @ dequant(w)) with w stored int8, per-column scales.

    x: (M, K) float32, bfloat16 or float16; w_int8: (K, N) int8; scale:
    (N,) float32.  f32 accumulation, one rounding to ``out_dtype``
    (default ``x.dtype``).  On a CUDA tensor this launches K2
    (``csrc/int8_matmul.cu``): x with a unit column stride (any row
    stride), ragged M, N and K taken as they are; anything else raises.
    On a CPU tensor it is :func:`int8_matmul_reference`.
    """
    _check_int8_matmul_args(x, w_int8, scale)
    if not x.is_cuda:
        return int8_matmul_reference(x, w_int8, scale, out_dtype)
    out_dtype = out_dtype or x.dtype
    if x.dtype not in _MATMUL_KINDS or out_dtype not in _MATMUL_KINDS:
        raise TypeError(f"int8_matmul takes float32, bfloat16 or float16 x and output, got {x.dtype} -> {out_dtype}")
    if w_int8.dtype != torch.int8:
        raise TypeError(f"int8_matmul takes int8 weights, got {w_int8.dtype}")
    if w_int8.device != x.device or scale.device != x.device:
        raise ValueError("x, w_int8 and scale must lie on one device")
    if x.stride(-1) != 1:
        x = x.contiguous()
    if w_int8.stride(-1) != 1:
        w_int8 = w_int8.contiguous()
    scale = scale.to(torch.float32).contiguous()
    (m, k), n = x.shape, w_int8.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    lda, ldw = max(x.stride(0), k), max(w_int8.stride(0), n)
    vec_x = x.data_ptr() % 16 == 0 and (lda * x.element_size()) % 16 == 0
    w_align = next((a for a in (16, 8) if w_int8.data_ptr() % a == 0 and ldw % a == 0), 1)
    tiles = -(-m // K2_TILE) * -(-n // K2_TILE)
    sms = _sm_count(x.device.index)
    splits = k2_splits(m, n, k, sms, K2_DEPTH[x.dtype])
    lib = _matmul_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        partials = counters = None
        if splits > 1:
            partials = torch.empty((splits, tiles, K2_TILE * K2_TILE), dtype=torch.float32, device=x.device)
            counters = _arrival_counters(x.device, stream, sms)  # a split call has fewer tiles than SMs
        err = lib.int8_matmul(
            x.data_ptr(), w_int8.data_ptr(), scale.data_ptr(), out.data_ptr(), m, n, k, lda, ldw,
            _MATMUL_KINDS[x.dtype], _MATMUL_KINDS[out_dtype], int(vec_x), w_align,
            None if partials is None else partials.data_ptr(), None if counters is None else counters.data_ptr(),
            splits, stream,
        )
    if err != 0:
        raise KernelLaunchError(f"int8_matmul launch failed: cudaError {err}")
    _count("int8_matmul")
    return out


K2_TILE = 128       # csrc/int8_matmul.cu kBM = kBN: the output tile of one block
# csrc/int8_matmul.cu Layout::kBK: the k-tile, by x's dtype
K2_DEPTH = {torch.float32: 32, torch.bfloat16: 64, torch.float16: 64}


def k2_splits(m: int, n: int, k: int, sms: int, depth: int) -> int:
    """K slices of one K2 call: 1 when the 128 x 128 output tiles fill the
    card's SMs, else as many as bring the blocks to about one wave, each
    slice at least ``64 // depth`` k-tiles of ``depth`` deep (64 of K) and
    none empty."""
    tiles = -(-m // K2_TILE) * -(-n // K2_TILE)
    k_tiles = -(-k // depth)
    least = max(64 // depth, 1)
    if tiles >= sms or k_tiles < 2 * least:
        return 1
    splits = min(sms // tiles, k_tiles // least)
    return -(-k_tiles // -(-k_tiles // splits))  # no empty slice


_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


def _arrival_counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` int32 arrival counters for a kernel that reduces
    across its blocks in the same launch (K2's split K: one per output
    tile; the paged decode's merge: one per lane and head group), one
    buffer per stream: zeroed once, and left at 0 by every call (the last
    block to arrive resets its counter), so calls in stream order share
    it; a larger zeroed buffer replaces it when a call needs more."""
    key = (device.index, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = _COUNTERS[key] = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
    return buf


def _matmul_lib() -> ctypes.CDLL:
    lib = _build.load("int8_matmul")
    fn = lib.int8_matmul
    if fn.restype is not ctypes.c_int or not fn.argtypes:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, i, i, i, ll, ll, i, i, i, i, p, p, i, p]
        fn.restype = ctypes.c_int
    return lib


def quantize_weights(w) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-output-channel int8 quantisation of a (K, N) kernel:
    ``scale = max|w[:, n]| / 127`` (1.0 for a zero column), ``w_q =
    clip(round(w / scale), -127, 127)``, round half to even, in numpy
    float32 — the JAX package's function, bit for bit."""
    w = np.asarray(w, np.float32)
    max_abs = np.abs(w).max(axis=0)
    scale = np.where(max_abs > 0, max_abs / 127.0, 1.0).astype(np.float32)
    w_q = np.clip(np.round(w / scale[None, :]), -127, 127).astype(np.int8)
    return w_q, scale


class Int8Dense(torch.nn.Module):
    """A serving-time dense layer with int8 weights.

    Built from a trained kernel in flax's (K, N) layout (and an optional
    (N,) bias), given as numpy: buffers ``w_q`` (K, N) int8, ``scale``
    (N,) float32 and ``bias`` float32.  ``forward(x)`` is
    ``int8_matmul(x, w_q, scale) + bias`` in x's dtype, so K2 runs on the
    card; the layer lives on ``device`` (``"cuda"`` unless the caller
    asks for the CPU).
    """

    def __init__(self, kernel, bias=None, device="cuda"):
        super().__init__()
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Int8Dense on device 'cuda' but CUDA is not available (pass device='cpu')")
        w_q, scale = quantize_weights(kernel)
        self.register_buffer("w_q", torch.from_numpy(w_q).to(device))
        self.register_buffer("scale", torch.from_numpy(scale).to(device))
        self.register_buffer("bias", None if bias is None else
                             torch.from_numpy(np.asarray(bias, np.float32)).to(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = int8_matmul(x, self.w_q, self.scale)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


# ---------------------------------------------------------------------------
# flash attention (blockwise online softmax)
# ---------------------------------------------------------------------------

# input dtype -> the kernel's kind code (csrc/flash_attention.cu)
_FLASH_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
FLASH_MAX_HEAD_DIM = 128  # csrc/flash_attention.cu kMaxHeadDim


def _check_flash_args(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention takes (batch, seq, heads, head_dim) q, k, v, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, d = q.shape
    if tuple(k.shape) != tuple(v.shape) or k.shape[0] != b or tuple(k.shape[2:]) != (h, d):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q {tuple(q.shape)}")


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              causal: bool = False) -> torch.Tensor:
    """The plain PyTorch version, in the arithmetic of the flash kernel
    (not of ``plain_attention``): q upcast to float32 and multiplied by
    ``1/sqrt(head_dim)``, k and v upcast, scores, softmax and ``p @ v``
    in float32, masked scores ``-inf`` (keys past the query's position
    when causal), a row with no live key 0, the result cast to q's dtype.
    """
    _check_flash_args(q, k, v)
    sq, sk = q.shape[1], k.shape[1]
    if sk == 0:
        return torch.zeros_like(q)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * (1.0 / float(np.sqrt(q.shape[-1]))), k.float())
    if causal:
        above = torch.arange(sk, device=q.device)[None, :] > torch.arange(sq, device=q.device)[:, None]
        s = s.masked_fill(above, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    safe_m = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.where(torch.isfinite(s), torch.exp(s - safe_m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l > 0, l, 1.0).permute(0, 2, 1, 3)  # (b, h, q, 1) -> (b, q, h, 1)
    return (torch.einsum("bhqk,bkhd->bqhd", p, v.float()) / l).to(q.dtype)


def _no_backward(kernel: str, *tensors: torch.Tensor) -> None:
    """Raise for a kernel launch whose inputs need a gradient: the kernels
    have no backward (nor have the JAX package's Pallas kernels a custom
    gradient), and a launch would cut the graph silently.  Training runs
    the module's plain path (``parallel/train.py``)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{kernel} has no backward: its inputs require a gradient (train on the module's "
                           "plain path, e.g. attention='plain')")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False,
                    block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """Blockwise attention on (batch, seq, heads, head_dim) tensors.

    On a CUDA tensor this launches K3 (``csrc/flash_attention.cu``): f32,
    bf16 or f16 q, k, v of one dtype, any strides but a unit-stride
    head_dim, head_dim a multiple of 8 up to 128; anything else raises.
    On a CPU tensor it is :func:`flash_attention_reference`.  ``block_q``
    and ``block_k`` are accepted for parity with the JAX function, where
    they set the TPU tiling; the CUDA kernel's key tiles are 64 rows, and
    neither changes the result.

    A causal call with ``seq_q != seq_k`` returns ``plain_attention``, on
    either device: that is the JAX function's own contract (cross-length
    causal has no absolute-position convention), not a fallback of the
    kernel.  No served path reaches it: self-attention has
    ``seq_q == seq_k``.
    """
    if block_q < 1 or block_k < 1:
        raise ValueError(f"block_q and block_k must be positive, got {block_q}, {block_k}")
    _check_flash_args(q, k, v)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if causal and sq != sk:
        from seldon_core_tpu_torch.models.transformer import plain_attention

        return plain_attention(q, k, v, causal=True)
    if not q.is_cuda:
        return flash_attention_reference(q, k, v, causal=causal)
    _no_backward("flash_attention (K3)", q, k, v)
    if q.dtype not in _FLASH_KINDS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32, bfloat16 or float16 q, k, v of one dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if d > FLASH_MAX_HEAD_DIM or d % 8:
        raise ValueError(f"flash_attention supports head_dim a multiple of 8 up to {FLASH_MAX_HEAD_DIM}, got {d}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must lie on one device")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = _flash_lib()
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out) for s in t.stride()[:3]))
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides, b, h, sq, sk, d,
            int(causal), 1.0 / float(np.sqrt(d)), _FLASH_KINDS[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise KernelLaunchError(f"flash_attention launch failed: cudaError {err}")
    _count("flash_attention")
    return out


def flash_attn_fn(block_q: int = 128, block_k: int = 128):
    """Drop-in ``attn_fn`` for the transformer family."""

    def fn(q, k, v, causal: bool = False):
        return flash_attention(q, k, v, causal=causal, block_q=block_q, block_k=block_k)

    return fn


def _flash_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.restype is not ctypes.c_int or not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, ctypes.POINTER(ctypes.c_longlong), i, i, i, i, i, i, ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# paged attention decode (flash-decoding over a paged K/V pool)
# ---------------------------------------------------------------------------

# q / pool dtype -> the kernels' q_kind / pool_kind code (csrc/paged_decode.cu)
_POOL_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
PAGED_MAX_HEAD_DIM = 128  # csrc/paged_decode.cu kMaxHeadDim
PAGED_MAX_LORA_RANK = 64  # csrc/paged_decode.cu kMaxRank
PAGED_CHUNK_ROWS = 64  # csrc/paged_decode.cu kMaxChunkRows: K4's chunk of pages, in rows
PAGED_GROUP_BYTES = 512  # csrc/paged_decode.cu kMaxGroupBytes: a head group's share of a pool row
PAGED_GROUP_ELEMS = 256  # csrc/paged_decode.cu kMaxGroupElems: ... in elements, head_dim padded
PAGED_GROUP_HEADS = 16  # csrc/paged_decode.cu kMaxGroupHeads


def paged_split(impl: str, heads: int, head_dim: int, page_size: int, table_pages: int,
                pool_dtype: torch.dtype) -> Tuple[int, int]:
    """How a lane is split across the decode kernel's blocks: ``(G, HG)``,
    a block owning a chunk of ``G`` pages of one lane for a group of
    ``HG`` heads.  The geometry alone decides, never the batch or the
    lengths, so a lane's bits do not change with what is co-scheduled.
    K5 (``grid``) keeps one page a block; K4 (``stream``) gathers pages
    of fewer than 64 rows into chunks of at most 64 rows.  ``HG`` is the
    most heads (at most 16, dividing ``heads``) whose share of a pool
    row, head_dim padded to whole 16-byte pieces, is at most 256
    elements and 512 bytes (4 heads of 64 in bf16 or int8), so two
    blocks fit an SM."""
    chunk_pages = 1 if impl == "grid" else max(1, min(table_pages, PAGED_CHUNK_ROWS // page_size))
    elt = torch.empty((), dtype=pool_dtype).element_size()
    padded = -(-head_dim * elt // 16) * 16 // elt  # elements
    group_heads = max(g for g in range(1, min(heads, PAGED_GROUP_HEADS) + 1)
                      if heads % g == 0 and g * padded <= PAGED_GROUP_ELEMS and g * padded * elt <= PAGED_GROUP_BYTES)
    return chunk_pages, group_heads


def paged_kernel_impl(heads: int, head_dim: int) -> str:
    """The decode kernel that serves this geometry: ``stream`` (K4, the
    default) or ``grid`` (K5), from ``SELDON_TPU_PAGED_KERNEL_IMPL``;
    any other value raises.  Both kernels take every ``head_dim`` up to
    128, so the geometry does not change the choice (the JAX package's
    fallback to ``grid`` for tiny models is a TPU tiling rule).  Callers
    that gate the stream-only LoRA fold resolve through here, so they
    cannot disagree with :func:`paged_attention_decode`."""
    impl = knobs.raw("SELDON_TPU_PAGED_KERNEL_IMPL", "stream")
    if impl not in ("stream", "grid"):
        raise ValueError(f"unknown SELDON_TPU_PAGED_KERNEL_IMPL {impl!r}: use 'stream' or 'grid'")
    return impl


def paged_launch_name(impl: str, quantized: bool = False, fold: bool = False) -> str:
    """The launch counter of one kernel variant, e.g. ``paged_decode_stream_int8_lora``."""
    return f"paged_decode_{impl}" + ("_int8" if quantized else "") + ("_lora" if fold else "")


def _check_paged_args(q, pk, pv, block_tables, lengths, page_size, kv_scales, lora) -> None:
    if q.dim() != 3 or pk.dim() != 4:
        raise ValueError(f"paged_attention_decode takes q (B, h, hd) and pages (num_pages, ps, h, hd), "
                         f"got {tuple(q.shape)} and {tuple(pk.shape)}")
    B, h, hd = q.shape
    if tuple(pv.shape) != tuple(pk.shape) or tuple(pk.shape[2:]) != (h, hd):
        raise ValueError(f"pages {tuple(pk.shape)} / {tuple(pv.shape)} do not match q {tuple(q.shape)}")
    if page_size != pk.shape[1]:
        raise ValueError(f"page_size={page_size} does not match the pool's page dim {pk.shape[1]}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B or tuple(lengths.shape) != (B,):
        raise ValueError(f"block_tables {tuple(block_tables.shape)} / lengths {tuple(lengths.shape)} "
                         f"do not match {B} lanes")
    int8_pages = pk.dtype == torch.int8 or pv.dtype == torch.int8
    if int8_pages != (kv_scales is not None):
        raise ValueError("int8 pages take kv_scales=(sk, sv), and only int8 pages do")
    if kv_scales is not None:
        for name, s in zip(("sk", "sv"), kv_scales):
            if tuple(s.shape) != (pk.shape[0],):
                raise ValueError(f"{name} must have shape ({pk.shape[0]},) (one scale per page), "
                                 f"got {tuple(s.shape)}")
    if lora is not None:
        x, a, b, idx, _q_scale = lora
        D = h * hd
        if tuple(x.shape) != (B, D) or a.dim() != 3 or tuple(a.shape[1:2]) != (D,):
            raise ValueError(f"lora x must be ({B}, {D}) and A (slots, {D}, r), got {tuple(x.shape)} and "
                             f"{tuple(a.shape)}")
        slots, _, rank = a.shape
        if tuple(b.shape) != (slots, rank, 3 * D) or tuple(idx.shape) != (B,):
            raise ValueError(f"lora B must be ({slots}, {rank}, {3 * D}) and adapter_idx ({B},), got "
                             f"{tuple(b.shape)} and {tuple(idx.shape)}")


def paged_attention_decode_reference(q: torch.Tensor, pk: torch.Tensor, pv: torch.Tensor,
                                     block_tables: torch.Tensor, lengths: torch.Tensor, *,
                                     page_size: int, kv_scales=None, lora=None):
    """The plain PyTorch version, lane by lane in float32: lane ``b``
    attends over positions ``[0, min(len_b, P * ps))`` of its pages;
    a lane of length 0 gives ``acc = 0, m = -inf, l = 0``.  int8 pages
    enter as ``float(page) * scale[page]``.  With ``lora`` the lane's
    qkv delta ``(x @ A[slot]) @ B[slot]`` is computed first, q becomes
    ``q + q_scale * delta[:, :D]``, and the delta is the fourth value."""
    _check_paged_args(q, pk, pv, block_tables, lengths, page_size, kv_scales, lora)
    B, h, hd = q.shape
    cap = block_tables.shape[1] * page_size
    qf = q.float()
    delta = None
    if lora is not None:
        x, a, b, idx, q_scale = lora
        idx = idx.long()
        t = torch.einsum("bd,bdr->br", x.float(), a[idx].float())
        delta = torch.einsum("br,bro->bo", t, b[idx].float())
        qf = qf + q_scale * delta[:, : h * hd].reshape(B, h, hd)
    acc = torch.zeros((B, h, hd), dtype=torch.float32, device=q.device)
    m = torch.full((B, h), float("-inf"), dtype=torch.float32, device=q.device)
    l = torch.zeros((B, h), dtype=torch.float32, device=q.device)
    for b, length in enumerate(lengths.tolist()):
        n = min(max(int(length), 0), cap)
        if n == 0:
            continue
        pages = block_tables[b, : -(-n // page_size)].long()
        k, v = pk[pages].float(), pv[pages].float()
        if kv_scales is not None:
            k = k * kv_scales[0][pages].float()[:, None, None, None]
            v = v * kv_scales[1][pages].float()[:, None, None, None]
        k = k.reshape(-1, h, hd)[:n]
        v = v.reshape(-1, h, hd)[:n]
        s = torch.einsum("thd,hd->ht", k, qf[b])
        m[b] = s.max(dim=1).values
        w = torch.exp(s - m[b][:, None])
        l[b] = w.sum(dim=1)
        acc[b] = torch.einsum("ht,thd->hd", w, v)
    return (acc, m, l) if lora is None else (acc, m, l, delta)


def paged_attention_decode(q: torch.Tensor, pk: torch.Tensor, pv: torch.Tensor,
                           block_tables: torch.Tensor, lengths: torch.Tensor, *,
                           page_size: int, kv_scales=None, lora=None):
    """Unnormalised flash state of decode attention over a paged pool.

    ``q`` (B, h, hd), already scaled, float32 or bfloat16; ``pk``/``pv``
    (num_pages, ps, h, hd) in q's dtype, or int8 with ``kv_scales=(sk,
    sv)``, this layer's (num_pages,) float32 scale per page for K and for
    V; ``block_tables`` (B, P) int32 page ids; ``lengths`` (B,) int32
    cached tokens.  Returns float32 ``acc`` (B, h, hd), ``m`` (B, h),
    ``l`` (B, h): merge with the current token's term by the flash rule.
    Lane ``b`` reads its first ``min(len_b, P * ps)`` positions, so the
    page loop is bounded by the lane's own length.

    ``lora=(x, a, b, adapter_idx, q_scale)`` (stream impl only) folds the
    per-lane qkv LoRA delta into the same launch: ``x`` (B, D) the block
    inputs, ``a`` (slots, D, r) and ``b`` (slots, r, 3D) float32 — the
    adapter pool's qkv factors of this layer in the pool's own layout —
    ``adapter_idx`` (B,) int32 slot ids (slot 0 is the zero adapter) and
    ``q_scale`` the ``1/sqrt(hd)`` already applied to q.  The scores use
    ``q + q_scale * delta[:, :D]``, and the return grows a fourth value,
    the raw (B, 3D) float32 delta, for the caller's self-term and pool
    write.  ``lora`` with the grid impl raises, as in the JAX package.

    On a CUDA tensor this launches K4 (``stream``) or K5 (``grid``), as
    ``paged_kernel_impl`` says: one launch, its blocks each a chunk of a
    lane's pages for a group of heads (:func:`paged_split`), the lane's
    chunks merged in the same launch; counted under its variant's name
    (:func:`paged_launch_name`).  On a CPU tensor it is
    :func:`paged_attention_decode_reference`.
    """
    _check_paged_args(q, pk, pv, block_tables, lengths, page_size, kv_scales, lora)
    B, h, hd = q.shape
    impl = paged_kernel_impl(h, hd)
    if lora is not None and impl != "stream":
        raise ValueError(f"paged_attention_decode: the in-kernel LoRA fold is a stream-impl feature but "
                         f"paged_kernel_impl resolved to {impl!r}; callers must gate the fold on "
                         f"paged_kernel_impl(heads, head_dim)")
    if not q.is_cuda:
        return paged_attention_decode_reference(q, pk, pv, block_tables, lengths, page_size=page_size,
                                                kv_scales=kv_scales, lora=lora)
    P = block_tables.shape[1]
    quantized = kv_scales is not None
    if q.dtype not in (torch.float32, torch.bfloat16) or pk.dtype != pv.dtype or (
            pk.dtype != (torch.int8 if quantized else q.dtype)):
        raise TypeError(f"paged_attention_decode takes float32 or bfloat16 q with pages of q's dtype or int8, "
                        f"got {q.dtype}, {pk.dtype}, {pv.dtype}")
    if hd > PAGED_MAX_HEAD_DIM:
        raise ValueError(f"paged_attention_decode supports head_dim <= {PAGED_MAX_HEAD_DIM}, got {hd}")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("block_tables and lengths must be int32")
    if not (pk.is_contiguous() and pv.is_contiguous()):
        raise ValueError("paged_attention_decode needs contiguous pages")
    extra = []
    if quantized:
        sk, sv = (s.to(torch.float32).contiguous() for s in kv_scales)
        extra += [sk, sv]
    fold = lora is not None
    if fold:
        x, a, b_f, idx, q_scale = lora
        if a.dtype != torch.float32 or b_f.dtype != torch.float32 or not (a.is_contiguous() and b_f.is_contiguous()):
            raise TypeError("the LoRA fold takes contiguous float32 factors A (slots, D, r) and B (slots, r, 3D)")
        if not 1 <= a.shape[2] <= PAGED_MAX_LORA_RANK:
            raise ValueError(f"the LoRA fold supports rank 1..{PAGED_MAX_LORA_RANK}, got {a.shape[2]}")
        x = x.to(torch.float32).contiguous()
        idx = idx.to(torch.int32).contiguous()
        extra += [x, a, b_f, idx]
    if any(t.device != q.device for t in (pk, pv, block_tables, lengths, *extra)):
        raise ValueError("q, pages, block_tables, lengths, scales and LoRA inputs must lie on one device")
    lib = _paged_lib()
    q = q.contiguous()
    block_tables = block_tables.contiguous()
    lengths = lengths.contiguous()
    f32 = dict(dtype=torch.float32, device=q.device)
    acc, m, l = torch.empty((B, h, hd), **f32), torch.empty((B, h), **f32), torch.empty((B, h), **f32)
    chunk_pages, group_heads = paged_split(impl, h, hd, page_size, P, pk.dtype)
    chunks = -(-P // chunk_pages)
    scales = (sk.data_ptr(), sv.data_ptr()) if quantized else (None, None)
    delta = None
    if fold:
        delta = torch.empty((B, 3 * h * hd), **f32)
        lora_ptrs = (x.data_ptr(), a.data_ptr(), b_f.data_ptr(), idx.data_ptr(), delta.data_ptr())
        rank, slots, q_scale = a.shape[2], a.shape[0], float(q_scale)
    else:
        lora_ptrs, rank, slots, q_scale = (None,) * 5, 0, 0, 0.0
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        scratch = (None,) * 4
        if chunks > 1:  # a lane may span several blocks: partials and the merge's counters
            part_acc = torch.empty((B, chunks, h, hd), **f32)
            part_m, part_l = torch.empty((B, chunks, h), **f32), torch.empty((B, chunks, h), **f32)
            counters = _arrival_counters(q.device, stream, B * (h // group_heads))
            scratch = (part_acc.data_ptr(), part_m.data_ptr(), part_l.data_ptr(), counters.data_ptr())
        err = lib.paged_decode(q.data_ptr(), pk.data_ptr(), pv.data_ptr(), block_tables.data_ptr(),
                               lengths.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(), *scales, *scratch,
                               *lora_ptrs, B, h, hd, P, page_size, chunk_pages, group_heads,
                               _POOL_KINDS[q.dtype], _POOL_KINDS[pk.dtype], rank, slots, q_scale, stream)
    name = paged_launch_name(impl, quantized, fold)
    if err != 0:
        raise KernelLaunchError(f"{name} launch failed: cudaError {err}")
    _count(name)
    return (acc, m, l) if delta is None else (acc, m, l, delta)


def _paged_lib() -> ctypes.CDLL:
    lib = _build.load("paged_decode")
    fn = lib.paged_decode
    if fn.restype is not ctypes.c_int or not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 19 + [i] * 11 + [ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return lib
