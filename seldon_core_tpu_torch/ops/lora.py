"""Batched multi-LoRA: a gathered grouped matmul over a slot-granular
adapter pool.

The port's counterpart of ``seldon_core_tpu/ops/lora.py`` (S-LoRA's
paged adapter pool, Punica's batched grouped matmul), on one device:

* **Pool-shaped storage** — every low-rank factor lives in one buffer
  per projection target, ``A: (layers, slots, d_in, r)`` /
  ``B: (layers, slots, r, d_out)``, where a *slot* is the weight-paging
  unit the engine's adapter table refcounts and LRU-reclaims.  Slot 0 is
  the zero adapter — all-zero factors, so a lane with no adapter gets a
  delta of exactly 0.0 through the same code.
* **Gathered grouped matmul** — :func:`lora_delta` picks each lane's
  factors by its slot index and computes ``x @ A_i @ B_i`` for every lane
  in two batched einsums; a batch mixing several adapters is one call.
  The qkv delta of a decode step folds into the paged-decode kernel K4
  instead (``ops.kernels.paged_attention_decode(lora=...)``).

Scaling (``alpha / rank``) is folded into B when the adapter is made, so
serving carries no scale term and offline merging is plain
``W + A @ B``.  Under a tensor-parallel mesh the pool's buffers are laid
out by :meth:`LoraPool.shardings` (JAX ``AdapterTable.shardings``):
column-parallel targets shard B's output dim, row-parallel targets A's
input dim, indivisible dims replicate.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch

# The decode projections adapters decorate; the embeddings and the head
# stay base-only (the classic LoRA target set).
LORA_TARGETS: Tuple[str, ...] = ("qkv", "attn_proj", "mlp_in", "mlp_out")
# targets whose base layer is column-parallel under the JAX specs (output
# dim sharded); the others are row-parallel
_COLUMN_PARALLEL = ("qkv", "mlp_in")


def target_dims(d_model: int, mlp_ratio: int = 4) -> Dict[str, Tuple[int, int]]:
    """``target -> (d_in, d_out)`` for the paged transformer blocks."""
    return {
        "qkv": (d_model, 3 * d_model),
        "attn_proj": (d_model, d_model),
        "mlp_in": (d_model, mlp_ratio * d_model),
        "mlp_out": (mlp_ratio * d_model, d_model),
    }


def lora_delta(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-lane low-rank delta ``(x @ A[idx]) @ B[idx]``.

    ``x``: (B, L, d_in) activations; ``a``: (slots, d_in, r); ``b``:
    (slots, r, d_out); ``idx``: (B,) per-lane slot ids.  The factors are
    cast to ``x``'s dtype and the rank-r intermediate keeps it, as in the
    JAX package, so a zero adapter is bitwise ``y + 0.0 == y``.

    A multi-token segment of several rows (a prefill group) is computed
    row by row, so a row's delta is the same bits whichever rows share
    its group: batched over the group, a bf16 adapter row came out
    differently from the same prompt prefilled alone on an H100, and the
    stream's later tokens followed.  Decode steps (L = 1) always run the
    engine's full slot width, so they stay one batched call."""
    if x.shape[0] > 1 and x.shape[1] > 1:
        return torch.cat([lora_delta(x[i:i + 1], a, b, idx[i:i + 1]) for i in range(x.shape[0])])
    idx = idx.long()
    ga = a[idx].to(x.dtype)  # (B, d_in, r)
    gb = b[idx].to(x.dtype)  # (B, r, d_out)
    xa = torch.einsum("bld,bdr->blr", x, ga)
    return torch.einsum("blr,bro->blo", xa, gb)


def make_lora_params(
    seed: int,
    *,
    num_layers: int,
    d_model: int,
    rank: int = 8,
    alpha: float = 8.0,
    mlp_ratio: int = 4,
    targets: Sequence[str] = LORA_TARGETS,
) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """Deterministic synthetic adapter, numpy: per target ``A ~ N(0,
    1/d_in)`` and ``B ~ N(0, 1/rank)`` (both non-zero, so the adapter
    visibly changes outputs), ``alpha / rank`` folded into B.  The same
    seed gives the JAX package's factors bit for bit."""
    dims = target_dims(d_model, mlp_ratio)
    rng = np.random.default_rng(seed)
    out: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    scale = float(alpha) / float(rank)
    for t in targets:
        d_in, d_out = dims[t]
        a = rng.normal(0.0, 1.0 / np.sqrt(d_in), (num_layers, d_in, rank)).astype(np.float32)
        b = rng.normal(0.0, 1.0 / np.sqrt(rank), (num_layers, rank, d_out)).astype(np.float32) * scale
        out[t] = (a, b)
    return out


def adapter_bytes(params: Dict[str, Tuple[Any, Any]]) -> int:
    """Host bytes of one adapter's factor set (the registry's budget unit)."""
    return int(sum(np.asarray(a).nbytes + np.asarray(b).nbytes for a, b in params.values()))


def merge_lora(state_dict: Dict[str, Any], adapter: Dict[str, Tuple[Any, Any]],
               num_layers: int) -> Dict[str, Any]:
    """Offline-merged weights ``W + A @ B`` of every block projection of a
    ``TransformerLM`` state_dict (torch ``Linear`` weights are (d_out,
    d_in), so the product is added transposed).  An engine serving the
    merged weights with no adapter is the reference for one serving the
    base weights with this adapter selected (float32).  Returns a new
    dict; the input is not changed."""
    merged = dict(state_dict)
    for i in range(num_layers):
        for t, (a, b) in adapter.items():
            key = f"blocks.{i}.{t}.weight"
            w = merged[key]
            dw = (np.asarray(a[i], np.float32) @ np.asarray(b[i], np.float32)).T
            merged[key] = (w.float() + torch.from_numpy(np.ascontiguousarray(dw))).to(w.dtype)
    return merged


def _as_f32(factor: Any) -> torch.Tensor:
    if torch.is_tensor(factor):
        return factor.detach().to(torch.float32)
    return torch.from_numpy(np.asarray(factor, np.float32))


class LoraPool:
    """Device-resident slot-granular adapter pool for one engine.

    ``slots = max_adapters + 1`` (slot 0 = the zero adapter, never
    allocated).  The buffers are float32 tensors on ``device`` that the
    engine passes to its model every call; :meth:`install` overwrites a
    whole slot row in place between calls, so shapes never change with
    adapter churn.
    """

    def __init__(self, *, num_layers: int, d_model: int, max_adapters: int, rank: int = 8,
                 mlp_ratio: int = 4, targets: Sequence[str] = LORA_TARGETS, device: Any = "cpu",
                 mesh: Any = None, model_axis: str = "model"):
        self.num_layers = int(num_layers)
        self.d_model = int(d_model)
        self.max_adapters = int(max_adapters)
        self.slots = self.max_adapters + 1
        self.rank = int(rank)
        self.targets = tuple(targets)
        self.mesh = mesh
        self._dims = target_dims(d_model, mlp_ratio)
        self.buffers: Dict[str, Tuple[Any, Any]] = {}
        specs = self.shardings(mesh, model_axis) if mesh is not None else None
        for t in self.targets:
            d_in, d_out = self._dims[t]
            shapes = ((self.num_layers, self.slots, d_in, self.rank), (self.num_layers, self.slots, self.rank, d_out))
            if mesh is None:
                self.buffers[t] = tuple(torch.zeros(s, dtype=torch.float32, device=device) for s in shapes)
            else:
                from seldon_core_tpu_torch.parallel.sharding import ShardedTensor

                self.buffers[t] = tuple(ShardedTensor.zeros(mesh, s, spec, torch.float32)
                                        for s, spec in zip(shapes, specs[t]))

    def shardings(self, mesh: Any, model_axis: str = "model") -> Dict[str, Tuple[Any, Any]]:
        """The (A, B) partition specs of every target under ``mesh`` (JAX
        ``ops/lora.py:227-245``): a column-parallel target shards B's
        output dim with A replicated, a row-parallel one A's input dim
        with B replicated, and an indivisible dim replicates both."""
        from seldon_core_tpu_torch.parallel.sharding import P

        axis = mesh.axis_size(model_axis) if mesh is not None else 1
        out: Dict[str, Tuple[Any, Any]] = {}
        for t in self.targets:
            d_in, d_out = self._dims[t]
            if axis <= 1:
                out[t] = (P(), P())
            elif t in _COLUMN_PARALLEL and d_out % axis == 0:
                out[t] = (P(), P(None, None, None, model_axis))
            elif t not in _COLUMN_PARALLEL and d_in % axis == 0:
                out[t] = (P(None, None, model_axis, None), P())
            else:
                out[t] = (P(), P())
        return out

    def device_args(self) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
        """The factor buffers the engine passes to its model."""
        return dict(self.buffers)

    def install(self, slot: int, params: Dict[str, Any]) -> None:
        """Write one adapter's factors into ``slot`` (1-based; slot 0 is the
        reserved zero adapter).  Every target is validated (present, right
        rank and dims) before the first write, so a partial or wrong-rank
        adapter raises a precise ``ValueError`` with the slot untouched."""
        if not 1 <= slot < self.slots:
            raise ValueError(f"adapter slot {slot} out of range 1..{self.slots - 1}")
        staged = {}
        for t in self.targets:
            d_in, d_out = self._dims[t]
            pair = params.get(t)
            if pair is None:
                raise ValueError(f"adapter is missing factors for target {t!r} "
                                 f"(pool targets: {', '.join(self.targets)})")
            a, b = (_as_f32(f) for f in pair)
            want_a = (self.num_layers, d_in, self.rank)
            want_b = (self.num_layers, self.rank, d_out)
            if tuple(a.shape) != want_a or tuple(b.shape) != want_b:
                raise ValueError(f"target {t!r} factors shaped A{tuple(a.shape)}/B{tuple(b.shape)} do not fit "
                                 f"the pool's A{want_a}/B{want_b} (layers, dims, rank={self.rank})")
            staged[t] = (a, b)
        for t, (a, b) in staged.items():
            a_buf, b_buf = self.buffers[t]
            if self.mesh is not None:
                a_buf.put(1, torch.tensor([slot]), a[:, None])
                b_buf.put(1, torch.tensor([slot]), b[:, None])
                continue
            a_buf[:, slot].copy_(a)
            b_buf[:, slot].copy_(b)

    def hbm_bytes(self) -> int:
        """Device bytes the pool holds (under a mesh, the distinct shards)."""
        if self.mesh is not None:
            return sum(a.distinct_nbytes() + b.distinct_nbytes() for a, b in self.buffers.values())
        return sum(a.nbytes + b.nbytes for a, b in self.buffers.values())
