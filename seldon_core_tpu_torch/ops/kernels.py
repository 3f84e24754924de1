"""Hand-written CUDA kernels for serving hot ops, with their plain versions.

* ``fused_normalize`` — uint8 NHWC batch -> normalised activation dtype
  in one pass (cast + per-channel affine fused; the plain PyTorch chain
  runs a convert, a multiply, an add and a cast as four passes over
  device memory before the first convolution).
* ``flash_attention`` (K3) — blockwise attention with an online softmax
  over (batch, seq, heads, head_dim) q, k, v, causal or not, read where
  they lie; the attention of every ``TransformerBlock`` served with
  ``"attention": "flash"`` (the ViTs, the encoder, the LM).
* ``paged_attention_decode`` — one decode step of attention over a paged
  K/V pool, read through the block table, as the unnormalised flash
  state ``(acc, m, l)``; the ``stream`` kernel (K4) by default, the
  ``grid`` kernel (K5) under ``SELDON_TPU_PAGED_KERNEL_IMPL=grid``.

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
import threading
from typing import Dict, Tuple

import numpy as np
import torch

from seldon_core_tpu_torch.ops import _build
from seldon_core_tpu_torch.runtime import knobs

_COUNT_LOCK = threading.Lock()
_LAUNCHES: Dict[str, int] = {"fused_normalize": 0, "flash_attention": 0, "paged_decode_stream": 0,
                             "paged_decode_grid": 0}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    with _COUNT_LOCK:
        return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for k in _LAUNCHES:
            _LAUNCHES[k] = 0


def _count(name: str, launches: int = 1) -> None:
    with _COUNT_LOCK:
        _LAUNCHES[name] += launches


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
        err = lib.fused_normalize_u8(
            x.data_ptr(), scale.data_ptr(), shift.data_ptr(), out.data_ptr(),
            x.numel(), x.shape[-1], _OUT_KINDS[out_dtype], _sm_count(x.device.index),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise KernelLaunchError(f"fused_normalize launch failed: cudaError {err}")
    _count("fused_normalize")
    return out


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _normalize_lib() -> ctypes.CDLL:
    lib = _build.load("fused_normalize")
    fn = lib.fused_normalize_u8
    if fn.restype is not ctypes.c_int or not fn.argtypes:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return lib


def imagenet_affine(mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225)) -> Tuple[np.ndarray, np.ndarray]:
    """Fold 'x/255 then standardise' into one per-channel affine."""
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    return 1.0 / (255.0 * std), -mean / std


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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False,
                    block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """Blockwise attention on (batch, seq, heads, head_dim) tensors.

    On a CUDA tensor this launches K3 (``csrc/flash_attention.cu``): f32,
    bf16 or f16 q, k, v of one dtype, any strides but a unit-stride
    head_dim, head_dim a multiple of 8 up to 128; anything else raises.
    On a CPU tensor it is :func:`flash_attention_reference`.  ``block_q``
    and ``block_k`` are accepted for parity with the JAX function, where
    they set the TPU tiling; the CUDA kernel's tiles are 64 rows, and
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

# pool dtype -> the kernels' pool_kind code (csrc/paged_decode.cu)
_POOL_KINDS = {torch.float32: 0, torch.bfloat16: 1}
PAGED_MAX_HEAD_DIM = 128  # csrc/paged_decode.cu kMaxHeadDim


def paged_kernel_impl(heads: int, head_dim: int) -> str:
    """The decode kernel that serves this geometry: ``stream`` (K4, the
    default) or ``grid`` (K5), from ``SELDON_TPU_PAGED_KERNEL_IMPL``;
    any other value raises.  Both kernels take every ``head_dim`` up to
    128, so the geometry does not change the choice (the JAX package's
    fallback to ``grid`` for tiny models is a TPU tiling rule)."""
    impl = knobs.raw("SELDON_TPU_PAGED_KERNEL_IMPL", "stream")
    if impl not in ("stream", "grid"):
        raise ValueError(f"unknown SELDON_TPU_PAGED_KERNEL_IMPL {impl!r}: use 'stream' or 'grid'")
    return impl


def _check_paged_args(q, pk, pv, block_tables, lengths, page_size) -> None:
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


def paged_attention_decode_reference(q: torch.Tensor, pk: torch.Tensor, pv: torch.Tensor,
                                     block_tables: torch.Tensor, lengths: torch.Tensor, *,
                                     page_size: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version, lane by lane in float32: lane ``b``
    attends over positions ``[0, min(len_b, P * ps))`` of its pages;
    a lane of length 0 gives ``acc = 0, m = -inf, l = 0``."""
    _check_paged_args(q, pk, pv, block_tables, lengths, page_size)
    B, h, hd = q.shape
    cap = block_tables.shape[1] * page_size
    acc = torch.zeros((B, h, hd), dtype=torch.float32, device=q.device)
    m = torch.full((B, h), float("-inf"), dtype=torch.float32, device=q.device)
    l = torch.zeros((B, h), dtype=torch.float32, device=q.device)
    for b, length in enumerate(lengths.tolist()):
        n = min(max(int(length), 0), cap)
        if n == 0:
            continue
        pages = block_tables[b, : -(-n // page_size)].long()
        k = pk[pages].reshape(-1, h, hd)[:n].float()
        v = pv[pages].reshape(-1, h, hd)[:n].float()
        s = torch.einsum("thd,hd->ht", k, q[b].float())
        m[b] = s.max(dim=1).values
        w = torch.exp(s - m[b][:, None])
        l[b] = w.sum(dim=1)
        acc[b] = torch.einsum("ht,thd->hd", w, v)
    return acc, m, l


def paged_attention_decode(q: torch.Tensor, pk: torch.Tensor, pv: torch.Tensor,
                           block_tables: torch.Tensor, lengths: torch.Tensor, *,
                           page_size: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Unnormalised flash state of decode attention over a paged pool.

    ``q`` (B, h, hd), already scaled; ``pk``/``pv`` (num_pages, ps, h, hd)
    in float32 or bfloat16, the same dtype as ``q``; ``block_tables``
    (B, P) int32 page ids; ``lengths`` (B,) int32 cached tokens.  Returns
    float32 ``acc`` (B, h, hd), ``m`` (B, h), ``l`` (B, h): merge with
    the current token's term by the flash rule.  Lane ``b`` reads its
    first ``min(len_b, P * ps)`` positions, so the page loop is bounded
    by the lane's own length.

    On a CUDA tensor this launches K4 (``stream``: one block per lane and
    head) or K5 (``grid``: one block per lane and page, then a merge
    launch; both count), as ``paged_kernel_impl`` says; on a CPU tensor
    it is :func:`paged_attention_decode_reference`.
    """
    if not q.is_cuda:
        return paged_attention_decode_reference(q, pk, pv, block_tables, lengths, page_size=page_size)
    _check_paged_args(q, pk, pv, block_tables, lengths, page_size)
    B, h, hd = q.shape
    P = block_tables.shape[1]
    impl = paged_kernel_impl(h, hd)
    if q.dtype not in _POOL_KINDS or pk.dtype != q.dtype or pv.dtype != q.dtype:
        raise TypeError(f"paged_attention_decode takes float32 or bfloat16 q and pages of one dtype, "
                        f"got {q.dtype}, {pk.dtype}, {pv.dtype}")
    if hd > PAGED_MAX_HEAD_DIM:
        raise ValueError(f"paged_attention_decode supports head_dim <= {PAGED_MAX_HEAD_DIM}, got {hd}")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("block_tables and lengths must be int32")
    if not (pk.is_contiguous() and pv.is_contiguous()):
        raise ValueError("paged_attention_decode needs contiguous pages")
    tensors = (pk, pv, block_tables, lengths)
    if any(t.device != q.device for t in tensors):
        raise ValueError("q, pages, block_tables and lengths must lie on one device")
    lib = _paged_lib()
    q = q.contiguous()
    block_tables = block_tables.contiguous()
    lengths = lengths.contiguous()
    f32 = dict(dtype=torch.float32, device=q.device)
    acc, m, l = torch.empty((B, h, hd), **f32), torch.empty((B, h), **f32), torch.empty((B, h), **f32)
    head = (q.data_ptr(), pk.data_ptr(), pv.data_ptr(), block_tables.data_ptr(), lengths.data_ptr(),
            acc.data_ptr(), m.data_ptr(), l.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if impl == "stream":
            err = lib.paged_decode_stream(*head, B, h, hd, P, page_size, _POOL_KINDS[q.dtype], stream)
            launches = 1
        else:
            part_acc = torch.empty((B, P, h, hd), **f32)
            part_m, part_l = torch.empty((B, P, h), **f32), torch.empty((B, P, h), **f32)
            err = lib.paged_decode_grid(*head, part_acc.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
                                        B, h, hd, P, page_size, _POOL_KINDS[q.dtype], stream)
            launches = 2  # the per-page partials, then the merge
    if err != 0:
        raise KernelLaunchError(f"paged_decode_{impl} launch failed: cudaError {err}")
    _count(f"paged_decode_{impl}", launches)
    return acc, m, l


def _paged_lib() -> ctypes.CDLL:
    lib = _build.load("paged_decode")
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, n_ptrs in (("paged_decode_stream", 8), ("paged_decode_grid", 11)):
        fn = getattr(lib, name)
        if fn.restype is not ctypes.c_int or not fn.argtypes:
            fn.argtypes = [p] * n_ptrs + [i] * 6 + [p]
            fn.restype = ctypes.c_int
    return lib
