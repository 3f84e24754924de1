"""The w8a8 compute lane: weight and activation int8 matmul / conv.

The counterpart of ``seldon_core_tpu/ops/w8a8.py``.  ``ops/surgery.py``
rests the weights int8 (compute stays in the compute dtype); this module
also quantises the activation and runs an int8 x int8 product with
int32 accumulation, then rescales: symmetric per-tensor activation
scales from a calibration pass (else dynamic, per token or per sample),
symmetric per-output-channel weight scales.

* **modules** ``W8A8Dense`` / ``W8A8Conv`` — ``nn.Linear`` and the
  ResNet's ``ConvSame`` with the same ``state_dict`` (the calibrated
  activation abs-max is the non-persistent buffer ``act_scale``; 0 means
  uncalibrated, so dynamic).  ``enable=False`` is the plain layer.
* **calibration** ``calibrate_act_scales`` — sample batches through the
  module; every enabled layer records its input abs-max; the maxima
  become the static scales.
* **primitives** ``w8a8_matmul`` / ``w8a8_conv`` — quantise -> integer
  GEMM (``torch._int_mm``, cuBLASLt on the card, int32 out) -> rescale,
  in the JAX package's layouts: (..., K) @ (K, N), NHWC / HWIO.
* **frozen weights** ``W8A8Dense.freeze`` — a layer handed its int8
  kernel and steps once (the paged engine does, at construction) reads
  them on every call instead of re-quantising its float weight;
  ``weight_quantizations()`` counts every weight quantisation, so a
  caller can show none happens per step.
* **audit** ``int8_lowering_report`` — the GEMMs one call runs under
  ``torch.profiler``, sorted into int8, integer-widened and float.

The convolution is an im2col GEMM: PyTorch has no int8 convolution.  The
int8 input is zero-padded (flax ``SAME`` pads, asymmetric where flax's
are), unfolded into a (B*Ho*Wo, kh*kw*C) int8 matrix in the kernel's
HWIO order, and multiplied by the (kh*kw*C, N) int8 kernel.  Each integer
GEMM adds one to ``launch_counts()["w8a8_int_mm"]``: the evidence that the
int path ran (the JAX package audits its HLO for the same purpose).
"""

from __future__ import annotations

import re
import threading
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from seldon_core_tpu_torch.models.resnet import ConvSame, same_pads
from seldon_core_tpu_torch.ops import kernels

__all__ = [
    "ACT_SCALES",
    "ACT_STATS",
    "quantize_activation",
    "w8a8_matmul",
    "w8a8_conv",
    "W8A8Dense",
    "W8A8Conv",
    "calibrate_act_scales",
    "act_scale_table",
    "quantize_weight",
    "weight_quantizations",
    "int8_lowering_report",
]

# the flax variable collections these map to: the calibrated scales (the
# layers' ``act_scale`` buffers here) and the calibration pass's sink
ACT_SCALES = "act_scales"
ACT_STATS = "act_stats"

_EPS = 1e-8  # all-zero activations quantise to zeros, not NaNs
_MM_ROWS_MIN = 17  # torch._int_mm on CUDA takes more than 16 rows
_MM_ALIGN = 8      # ... and K, N multiples of 8

_WQ_LOCK = threading.Lock()
_WQ_COUNT = 0  # weight quantisations since import (weight_quantizations())


def weight_quantizations() -> int:
    """Weight quantisations run since import: the evidence that a lane
    with frozen weights quantises no weight per call."""
    with _WQ_LOCK:
        return _WQ_COUNT


# ---------------------------------------------------------------------------
# primitives — quantize -> int8 GEMM (int32 accum) -> rescale
# ---------------------------------------------------------------------------


def quantize_activation(x: torch.Tensor, scale: Optional[torch.Tensor] = None,
                        reduce_axes: Optional[Sequence[int]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 activation quantisation: ``(x_q int8, step f32)``.

    ``scale`` is the calibrated per-tensor abs-max (0 or None: dynamic).
    The dynamic abs-max reduces over ``reduce_axes`` only (default the
    last axis: per token / per sample), never the batch axis, so one
    request's grid never depends on what it is batched with.  ``step =
    max(absmax, 1e-8) / 127`` in float32, ``x_q = clip(round(x / step),
    -127, 127)`` with round half to even; ``step`` keeps dims.
    """
    xf = x.float()
    if reduce_axes is None:
        reduce_axes = (xf.dim() - 1,)
    dyn = xf.abs().amax(dim=tuple(reduce_axes), keepdim=True)
    absmax = dyn if scale is None else torch.where(scale > 0, scale, dyn)
    step = torch.clamp_min(absmax, _EPS) / 127.0
    xq = torch.clamp(torch.round(xf / step), -127, 127).to(torch.int8)
    return xq, step


def _quantize_weight_last_axis(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 of (..., N): ``(w_q, step (N,))``,
    ``step = (absmax or 1) / 127`` — recomputed from the float32 kernel
    as the JAX package does, so a kernel that went through the at-rest
    surgery and an f32 dequant gives the same integers back, and the same
    steps as JAX's to the bit (``127 * s / 127`` need not be ``s``)."""
    global _WQ_COUNT
    with _WQ_LOCK:
        _WQ_COUNT += 1
    wf = w.float()
    absmax = wf.abs().amax(dim=tuple(range(wf.dim() - 1)))
    step = torch.where(absmax > 0, absmax, torch.ones_like(absmax)) / 127.0
    wq = torch.clamp(torch.round(wf / step), -127, 127).to(torch.int8)
    return wq, step


def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32, exact, through
    ``torch._int_mm``; rows, K and N are zero-padded to what it takes
    (zeros add nothing to a sum) and the padding sliced off.  ``b`` goes
    in column-major, the layout cuBLASLt's int8 GEMMs are built for (a
    row-major ``b`` ran 2.7x slower at ResNet-50's 3x3 shape, and some
    small shapes it refuses)."""
    m, k = a.shape
    n = b.shape[1]
    pm = max(_MM_ROWS_MIN - m, 0)
    pk, pn = -k % _MM_ALIGN, -n % _MM_ALIGN
    if pm or pk:
        a = F.pad(a, (0, pk, 0, pm))
    if pk or pn:
        b = F.pad(b.t(), (0, pk, 0, pn)).t()
    if b.stride(0) != 1 or b.stride(1) != b.shape[0]:
        b = b.t().contiguous().t()
    acc = torch._int_mm(a.contiguous(), b)
    kernels._count("w8a8_int_mm")
    return acc[:m, :n] if (pm or pn) else acc


def _int_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """(..., K) int8 @ (K, N) int8 -> (..., N) int32."""
    lead = xq.shape[:-1]
    return _int_mm(xq.reshape(-1, xq.shape[-1]), wq).reshape(*lead, wq.shape[-1])


Padding = Union[str, Sequence[Tuple[int, int]]]


def _conv_pads(padding: Padding, size: Tuple[int, int], kernel: Tuple[int, int],
               strides: Tuple[int, int]) -> Tuple[Tuple[int, int], ...]:
    if isinstance(padding, str):
        if padding == "SAME":
            return tuple(same_pads(s, k, st) for s, k, st in zip(size, kernel, strides))
        if padding == "VALID":
            return ((0, 0), (0, 0))
        raise ValueError(f"padding must be 'SAME', 'VALID' or ((lo, hi), (lo, hi)), got {padding!r}")
    return tuple((int(lo), int(hi)) for lo, hi in padding)


def _int_conv(xq: torch.Tensor, wq: torch.Tensor, strides: Sequence[int], padding: Padding) -> torch.Tensor:
    """NHWC int8 x HWIO int8 -> NHWC int32, exact: zero-pad, im2col into
    a (B*Ho*Wo, kh*kw*C) int8 matrix in the kernel's order, one GEMM."""
    B, H, W, C = xq.shape
    kh, kw, _, N = wq.shape
    sh, sw = strides
    (pt, pb), (pl, pr) = _conv_pads(padding, (H, W), (kh, kw), (sh, sw))
    if pt or pb or pl or pr:
        xq = F.pad(xq, (0, 0, pl, pr, pt, pb))
    xq = xq.contiguous()
    Hp, Wp = H + pt + pb, W + pl + pr
    Ho, Wo = (Hp - kh) // sh + 1, (Wp - kw) // sw + 1
    sB, sH, sW, sC = xq.stride()
    cols = xq.as_strided((B, Ho, Wo, kh, kw, C), (sB, sH * sh, sW * sw, sH, sW, sC))
    # (N, kh*kw*C) rows: a view when the kernel lies OHWI (channels_last OIHW)
    wmat = wq.permute(3, 0, 1, 2).reshape(N, kh * kw * C).t()
    acc = _int_mm(cols.reshape(B * Ho * Wo, kh * kw * C), wmat)
    return acc.reshape(B, Ho, Wo, N)


def w8a8_matmul(x: torch.Tensor, w: torch.Tensor, act_scale: Optional[torch.Tensor] = None,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``y = x @ w`` through the int8 path.

    x: (..., K) float; w: (K, N) float (quantised here: exact for kernels
    that round-tripped the at-rest surgery through f32); ``act_scale``:
    the calibrated per-tensor abs-max, or None for dynamic per-token
    scales (abs-max over K only).  int8 x int8 with int32 accumulation,
    then ``acc * (step_x * step_w)`` in f32, cast to ``out_dtype``
    (default x's dtype).
    """
    wq, sw = _quantize_weight_last_axis(w)
    return w8a8_matmul_quantized(x, wq, sw, act_scale, out_dtype)


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A (K, N) float kernel as ``w8a8_matmul`` quantises it: ``(w_q,
    step (N,))``, ``w_q`` laid out column-major, as ``torch._int_mm``
    takes its second operand, so a frozen layer's calls copy nothing."""
    wq, sw = _quantize_weight_last_axis(w)
    return wq.t().contiguous().t(), sw


def w8a8_matmul_quantized(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
                          act_scale: Optional[torch.Tensor] = None,
                          out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``w8a8_matmul`` with the kernel already quantised (``quantize_weight``):
    the activation quantised, one int8 GEMM, the rescale."""
    out_dtype = out_dtype or x.dtype
    xq, sx = quantize_activation(x, act_scale)
    acc = _int_matmul(xq, wq)
    return (acc.float() * (sx * sw)).to(out_dtype)


def w8a8_conv(x: torch.Tensor, w: torch.Tensor, strides: Sequence[int], padding: Padding,
              act_scale: Optional[torch.Tensor] = None, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """NHWC / HWIO conv through the int8 path (per-output-channel scales).

    x: (B, H, W, C); w: (kh, kw, C, N); ``padding`` ``"SAME"`` (flax's,
    asymmetric where flax's is), ``"VALID"`` or ((lo, hi), (lo, hi)).
    Dynamic activation scales are per sample (abs-max over H, W, C,
    never the batch axis); the rescale broadcasts the (B, 1, 1, 1)
    activation steps and the (N,) weight steps over the NHWC output.
    """
    out_dtype = out_dtype or x.dtype
    xq, sx = quantize_activation(x, act_scale, reduce_axes=(1, 2, 3))
    wq, sw = _quantize_weight_last_axis(w)
    acc = _int_conv(xq, wq, tuple(strides), padding)
    return (acc.float() * (sx * sw)).to(out_dtype)


# ---------------------------------------------------------------------------
# modules — state_dict identical to nn.Linear / ConvSame
# ---------------------------------------------------------------------------


class _W8A8Mixin:
    """The activation-scale buffer and the calibration sink."""

    def _init_w8a8(self, enable: bool, device) -> None:
        self.enable = bool(enable)
        # non-persistent: the state_dict stays the plain layer's
        self.register_buffer("act_scale", torch.zeros((), dtype=torch.float32, device=device), persistent=False)
        self.observed: Optional[torch.Tensor] = None  # running input abs-max while calibrating
        self.observing = False

    def _observe(self, x: torch.Tensor) -> None:
        if self.observing:
            m = x.detach().float().abs().amax()
            self.observed = m if self.observed is None else torch.maximum(self.observed, m)


class W8A8Dense(nn.Linear, _W8A8Mixin):
    """``nn.Linear`` with int8 x int8 compute (same ``state_dict``).

    ``forward`` casts like flax's ``nn.Dense(dtype)``: ``enable=False``
    computes ``x @ w.T + b`` in ``dtype``; enabled, ``w8a8_matmul`` on the
    (in, out) kernel, the bias added in float32, the result in ``dtype``.
    """

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.bfloat16, device=None, enable: bool = True):
        super().__init__(in_features, out_features, bias=bias, dtype=dtype, device=device)
        self.requires_grad_(False)
        self.dtype = dtype
        self._init_w8a8(enable, device)
        self.frozen: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def freeze(self, wq: torch.Tensor, step: torch.Tensor) -> None:
        """Serve from ``(wq, step)``, ``quantize_weight`` of the (in, out)
        kernel, from now on: calls quantise no weight, and the float
        ``weight`` is dropped (an empty tensor stays under its name)."""
        self.frozen = (wq, step)
        self.weight = nn.Parameter(self.weight.new_empty((0,)), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        if not self.enable:
            b = None if self.bias is None else self.bias.to(self.dtype)
            return F.linear(x.to(self.dtype), w.to(self.dtype), b)
        self._observe(x)
        if self.frozen is not None:
            y = w8a8_matmul_quantized(x, *self.frozen, self.act_scale, self.dtype)
        else:
            y = w8a8_matmul(x, w.t(), self.act_scale, self.dtype)
        if self.bias is not None:
            y = (y.float() + self.bias.float()).to(self.dtype)
        return y


class W8A8Conv(ConvSame, _W8A8Mixin):
    """The ResNet's ``ConvSame`` (bias-free, flax ``SAME`` or explicit
    pads) with int8 x int8 compute; same ``state_dict``.  Takes and
    returns NCHW-shaped tensors like ``ConvSame`` (channels_last on the
    card, so the NHWC views it computes on are free)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, padding: Optional[int] = None,
                 dtype: torch.dtype = torch.bfloat16, device=None, enable: bool = True):
        super().__init__(cin, cout, kernel, stride, padding, dtype=dtype, device=device)
        self._init_w8a8(enable, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.enable:
            return super().forward(x)
        self._observe(x)
        pads = "SAME" if self.padding is None else ((self.padding, self.padding),) * 2
        w = self.weight.permute(2, 3, 1, 0)  # OIHW -> HWIO
        y = w8a8_conv(x.permute(0, 2, 3, 1), w, (self.stride, self.stride), pads, self.act_scale, self.dtype)
        return y.permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# calibration — sample batches -> static per-tensor scales
# ---------------------------------------------------------------------------


def calibrate_act_scales(module: nn.Module, batches: Iterable[torch.Tensor], margin: float = 1.0) -> int:
    """Static PTQ calibration: run ``batches`` through ``module``, take
    each enabled w8a8 layer's largest input abs-max over them, and store
    that abs-max (times ``margin``) in the layer's ``act_scale`` (the
    quantisers divide by 127 themselves).  Returns the number of layers
    calibrated (0 when the module has none).  Batches come from the same
    preprocessing the serving path applies."""
    layers = [m for m in module.modules() if isinstance(m, _W8A8Mixin) and m.enable]
    if not layers:
        return 0
    for m in layers:
        m.observing, m.observed = True, None
    try:
        with torch.inference_mode():
            for x in batches:
                module(x)
    finally:
        for m in layers:
            m.observing = False
    n = 0
    for m in layers:
        if m.observed is not None:
            m.act_scale.copy_(m.observed * margin if margin != 1.0 else m.observed)
            m.observed = None
            n += 1
    return n


def act_scale_table(module: nn.Module) -> Dict[str, float]:
    """Each enabled w8a8 layer's ``act_scale`` by module name, in module
    order (0.0 = a dynamic per-sample scale), read with one device sync."""
    layers = [(name, m) for name, m in module.named_modules() if isinstance(m, _W8A8Mixin) and m.enable]
    if not layers:
        return {}
    values = torch.stack([m.act_scale.float() for _, m in layers]).cpu().tolist()
    return {name: v for (name, _), v in zip(layers, values)}


# ---------------------------------------------------------------------------
# audit — did the integer path run?
# ---------------------------------------------------------------------------

# the leaf GEMM / convolution ops of the dispatcher (wrappers such as
# aten::linear, aten::matmul and aten::einsum reach one of these)
_GEMM_OPS = frozenset(("aten::_int_mm", "aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm", "aten::mv",
                       "aten::addmv", "aten::dot", "aten::convolution"))
_INT8_TYPES = frozenset(("signed char", "char", "int8"))
_WIDE_INT_TYPES = frozenset(("short", "int", "long", "long int", "int16", "int32", "int64"))
# device kernels that are GEMMs (cuBLAS / cuBLASLt / CUTLASS names), and
# which of them take int8 operands
_GEMM_KERNEL = re.compile(r"gemm|xmma|cutlass|cublas|matmul", re.IGNORECASE)
_INT8_KERNEL = re.compile(r"i8|s8|int8|imma|igemm", re.IGNORECASE)


def int8_lowering_report(fn: Callable, *args) -> Dict[str, Any]:
    """Run ``fn(*args)`` once under ``torch.profiler`` and sort every
    GEMM / convolution it ran by operand type: the JAX package's report,
    read from the profiler instead of optimised HLO.

    On a CUDA card the device kernels decide: a GEMM kernel whose name
    marks int8 operands (cuBLASLt's ``..._i8...`` / ``imma`` kernels)
    counts as int8, any other GEMM kernel as float.  Without device
    kernels the dispatcher's leaf ops decide: ``aten::_int_mm`` (or a
    GEMM on int8 inputs) is int8, a GEMM on wider integers is
    integer-widened, the rest float.  Verdicts: ``"int8"`` (at least one
    int8 GEMM), ``"int-widened"``, ``"float-upcast"`` (only float GEMMs:
    the quantised lane did not run) or ``"no-ops"``;
    ``int8_majority`` also asks that the int8 GEMMs outnumber the float
    ones.  ``evidence`` holds up to 8 of the profiler's own names, int8
    first."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, record_shapes=True) as prof:
        fn(*args)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    kernels_seen: List[Tuple[str, str]] = []
    ops_seen: List[Tuple[str, str]] = []
    for ev in prof.events():
        name = ev.name
        if ev.device_type != torch.autograd.DeviceType.CPU:
            if _GEMM_KERNEL.search(name):
                kernels_seen.append(("s8" if _INT8_KERNEL.search(name) else "float", name))
            continue
        if name not in _GEMM_OPS:
            continue
        dtypes = set(getattr(ev, "input_dtypes", None) or ())
        if name == "aten::_int_mm" or dtypes & _INT8_TYPES:
            kind = "s8"
        elif dtypes & _WIDE_INT_TYPES:
            kind = "int_wide"
        else:
            kind = "float"
        ops_seen.append((kind, f"{name} {sorted(d for d in dtypes if d)}"))
    seen = kernels_seen or ops_seen
    counts = {"s8": 0, "int_wide": 0, "float": 0}
    for kind, _ in seen:
        counts[kind] += 1
    evidence: List[str] = []
    for want in ("s8", "int_wide", "float"):
        for kind, line in seen:
            if kind == want and line[:160] not in evidence and len(evidence) < 8:
                evidence.append(line[:160])
    if counts["s8"]:
        verdict = "int8"
    elif counts["int_wide"]:
        verdict = "int-widened"
    elif counts["float"]:
        verdict = "float-upcast"
    else:
        verdict = "no-ops"
    return {
        "verdict": verdict,
        "int8_ops": counts["s8"],
        "int_widened_ops": counts["int_wide"],
        "float_ops": counts["float"],
        "int8_majority": counts["s8"] > 0 and counts["s8"] >= counts["float"],
        "backend": "cuda" if kernels_seen else "cpu",
        "evidence": evidence,
    }
