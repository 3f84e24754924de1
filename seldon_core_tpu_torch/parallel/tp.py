"""The paged transformer LM's programs over a serving mesh.

What GSPMD derives for the JAX package's sharded paged engine, written
out (``parallel/__init__.py`` has the design).  :class:`MeshPagedLM` has
the call signature of ``models.paged.PagedTransformerLM`` and computes
what it computes, position by position:

* **rows over ``data``**: a call's batch splits into contiguous row
  groups, one a data position (all on the first when the engine's lanes
  do not divide, as the JAX engine replicates them);
* **weights over ``model``** by JAX's specs (``sharding.param_spec`` of
  the flax-layout view).  Every dense layer ends with its output whole
  on each model position: a column-parallel layer (output dim sharded)
  all-gathers its slices, a row-parallel one (input dim sharded)
  all-reduces its partial products and adds the bias once, a replicated
  one computes whole.  So the fused ``qkv`` output is gathered before
  heads are split, whatever its column split;
* **attention by heads**: model position ``j`` attends with its slice of
  the heads, against its head shard of the pool, and the heads' outputs
  are all-gathered before the output projection;
* **the pool's pages over ``data``**: a lane reads a page from the data
  position that holds it (each holder gives its rows or zeros and the
  sum has one nonzero term, so the read is exact), and a write lands on
  the holder only; with the pages replicated (``SELDON_TPU_SEQ_SHARD=0``)
  every replica takes every write;
* the vocabulary-sharded embedding looks a token up on the position that
  holds its row (zeros elsewhere) and all-reduces.

A LoRA adapter's delta is computed on the whole input with the whole
factors (gathered from their shards) and added to the whole output, as
the one-device block adds it.  No kernel runs here: the mesh engine's
lanes are the gather lane and the ring chunk, as in the JAX engine.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from seldon_core_tpu_torch.models.transformer import LN_EPS, cached_attention
from seldon_core_tpu_torch.models.transformer import head_scale as _head_scale
from seldon_core_tpu_torch.ops.lora import lora_delta
from seldon_core_tpu_torch.ops.surgery import QuantizedKernel
from seldon_core_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh
from seldon_core_tpu_torch.parallel.sharding import (P, ShardedTensor, all_gather, all_reduce, param_spec,
                                                     quantized_spec)


class MeshGrid:
    """A serving mesh's data groups and model positions: ``pos(i, j)`` is
    the position of data index ``i`` and model index ``j`` (an axis the
    mesh lacks has size 1)."""

    def __init__(self, mesh: Mesh, data_axis: str = DATA_AXIS, model_axis: str = MODEL_AXIS):
        self.mesh, self.data_axis, self.model_axis = mesh, data_axis, model_axis
        self.dp, self.tp = mesh.axis_size(data_axis), mesh.axis_size(model_axis)
        for axis in mesh.axis_names:
            if axis not in (data_axis, model_axis) and mesh.axis_size(axis) > 1:
                raise ValueError(f"serving mesh axis {axis!r} is neither {data_axis!r} nor {model_axis!r}")

    def pos(self, i: int, j: int) -> Tuple[int, ...]:
        out = []
        for axis in self.mesh.axis_names:
            out.append(i if axis == self.data_axis else j if axis == self.model_axis else 0)
        return tuple(out)

    def dev(self, i: int, j: int) -> torch.device:
        return self.mesh.device(self.pos(i, j))

    def rows(self, batch: int, sharded: bool) -> List[slice]:
        """The contiguous row groups of a ``batch``-row call, one a data
        index (empty groups allowed)."""
        if not sharded or self.dp == 1:
            return [slice(0, batch)] + [slice(batch, batch)] * (self.dp - 1)
        base, extra = divmod(batch, self.dp)
        out, off = [], 0
        for i in range(self.dp):
            n = base + (1 if i < extra else 0)
            out.append(slice(off, off + n))
            off += n
        return out


class LaneKV:
    """K or V of one call over the mesh: ``parts[(i, j)]`` holds data
    group ``i``'s rows (``rows[i]`` of the call's batch) at model index
    ``j``'s heads, (layers, rows, L, heads_j, head_dim)."""

    def __init__(self, grid: MeshGrid, rows: List[slice], parts: Dict[Tuple[int, int], torch.Tensor]):
        self.grid, self.rows, self.parts = grid, rows, parts

    @classmethod
    def zeros(cls, grid: MeshGrid, rows: List[slice], layers: int, width: int, heads_j: int, head_dim: int,
              dtype: torch.dtype) -> "LaneKV":
        parts = {}
        for i, r in enumerate(rows):
            if r.stop <= r.start:
                continue
            for j in range(grid.tp):
                parts[(i, j)] = torch.zeros((layers, r.stop - r.start, width, heads_j, head_dim), dtype=dtype,
                                            device=grid.dev(i, j))
        return cls(grid, rows, parts)

    def set_column(self, t: int, new: "LaneKV") -> None:
        """Column ``t`` of every part from ``new``'s one-token parts."""
        for key, part in self.parts.items():
            part[:, :, t] = new.parts[key][:, :, 0]


def write_kv_mesh(pk: ShardedTensor, pv: ShardedTensor, new_k: LaneKV, new_v: LaneKV, page: torch.Tensor,
                  row: torch.Tensor, pages_sharded: bool) -> None:
    """Write a call's K/V into the sharded pools at (page, row) (B, S)
    targets: each write lands on the data position that holds its page
    (every replica when the pages replicate), on the model position of
    its heads."""
    grid = new_k.grid
    per_shard = pk.shape[1] // grid.dp if pages_sharded else pk.shape[1]
    for (i, j), part_k in new_k.parts.items():
        r = new_k.rows[i]
        if r.stop <= r.start:
            continue
        part_v = new_v.parts[(i, j)]
        L, nb, S = part_k.shape[:3]
        tail = part_k.shape[3:]
        pg = page[r].reshape(-1).cpu()
        rw = row[r].reshape(-1).cpu()
        vals_k = part_k.reshape(L, nb * S, *tail)
        vals_v = part_v.reshape(L, nb * S, *tail)
        seen = set()
        for p in range(grid.dp):
            tk = pk.local(grid.pos(p, j))
            if id(tk) in seen:
                continue
            seen.add(id(tk))
            tv = pv.local(grid.pos(p, j))
            if pages_sharded:
                sel = ((pg >= p * per_shard) & (pg < (p + 1) * per_shard)).nonzero().reshape(-1)
                if sel.numel() == 0:
                    continue
                lp, lr = (pg[sel] - p * per_shard).to(tk.device), rw[sel].to(tk.device)
                sel_d = sel.to(vals_k.device)
                tk[:, lp, lr] = vals_k[:, sel_d].to(tk.device)
                tv[:, lp, lr] = vals_v[:, sel_d].to(tv.device)
            else:
                lp, lr = pg.to(tk.device), rw.to(tk.device)
                tk[:, lp, lr] = vals_k.to(tk.device)
                tv[:, lp, lr] = vals_v.to(tv.device)


class MeshPagedLM:
    """``PagedTransformerLM``'s forward and ring step over a serving mesh
    (see the module docstring).  ``state`` is the LM's float32
    ``state_dict``; ``qkernels`` the int8-at-rest kernels of an int8w
    engine (``QuantizedKernel`` by key, laid out by JAX's paired specs and
    dequantised per position for one device call, :meth:`materialized`).
    ``lanes_sharded``: split a call's rows over ``data``."""

    def __init__(self, state: Dict[str, torch.Tensor], *, vocab_size: int, d_model: int, num_layers: int,
                 num_heads: int, max_len: int, dtype: torch.dtype, mesh: Mesh, pool_spec: P,
                 lanes_sharded: bool, model_axis: str = MODEL_AXIS, data_axis: str = DATA_AXIS,
                 min_weight_size: int = 16_384, qkernels: Optional[Dict[str, QuantizedKernel]] = None,
                 precision: str = "bf16"):
        self.grid = MeshGrid(mesh, data_axis, model_axis)
        self.mesh, self.dtype = mesh, dtype
        self.vocab_size, self.d_model, self.num_layers = int(vocab_size), int(d_model), int(num_layers)
        self.num_heads, self.head_dim, self.max_len = int(num_heads), int(d_model) // int(num_heads), int(max_len)
        self.lanes_sharded = bool(lanes_sharded)
        self.pool_spec = P(*pool_spec)
        self.heads_sharded = self.pool_spec.axis_of(3) == model_axis
        self.pages_sharded = self.pool_spec.axis_of(1) == data_axis
        self.heads_j = self.num_heads // self.grid.tp if self.heads_sharded else self.num_heads
        tp = self.grid.tp
        qkernels = dict(qkernels or {})
        # w8a8: every projection and the head serve int8 x int8 from the
        # integers and steps of the (in, out) kernel (the one-device
        # W8A8Dense's freeze), laid out as the torch weight's spec
        # transposed; an int8-at-rest kernel is requantised from its f32
        # dequant, which gives its integers back
        self.specs: Dict[str, Any] = {}
        self.w8a8: Dict[str, Tuple[ShardedTensor, ShardedTensor]] = {}
        if precision == "w8a8":
            from seldon_core_tpu_torch.ops.w8a8 import quantize_weight

            for key in [k for k in state if _is_projection(k)]:
                qk = qkernels.pop(key, None)
                w = qk.dequantize(torch.float32) if qk is not None else state[key].float()
                spec = param_spec(key, w.shape, tp, model_axis, min_weight_size)
                wq, sw = quantize_weight(w.t())
                wq_spec = P(spec.axis_of(1), spec.axis_of(0)) if spec else P()
                wq_st = ShardedTensor.from_tensor(mesh, wq, wq_spec)
                for pos in mesh.positions():  # column-major, as torch._int_mm takes its second operand
                    wq_st.shards[pos] = wq_st.shards[pos].t().contiguous().t()
                sw_spec = P(spec.axis_of(0)) if spec.axis_of(0) else P()
                self.w8a8[key] = (wq_st, ShardedTensor.from_tensor(mesh, sw, sw_spec))
                self.specs[key] = wq_st.spec
        self.params: Dict[str, ShardedTensor] = {}
        for key, t in state.items():
            if key in qkernels or key in self.w8a8:
                continue
            t = t.float() if ".ln" in f".{key}" else t.to(dtype)
            self.specs[key] = param_spec(key, t.shape, tp, model_axis, min_weight_size)
            self.params[key] = ShardedTensor.from_tensor(mesh, t, self.specs[key])
        self.qkernels: Dict[str, QuantizedKernel] = {}
        for key, qk in qkernels.items():
            spec = quantized_spec(tuple(qk.q.shape), tp, model_axis, min_weight_size, out_dim=0)
            self.specs[key] = spec
            self.qkernels[key] = QuantizedKernel(ShardedTensor.from_tensor(mesh, qk.q.cpu(), spec.q),
                                                 ShardedTensor.from_tensor(mesh, qk.scale.cpu(), spec.scale))
        self._dequantized: Dict[str, ShardedTensor] = {}
        self._full_cache: Dict[Tuple[str, int, int], torch.Tensor] = {}

    # ---- weights -------------------------------------------------------------

    def weight_bytes(self) -> int:
        """Bytes of the distinct tensors the positions hold (int8 kernels
        and their scales at rest)."""
        total = sum(t.distinct_nbytes() for t in self.params.values())
        for qk in self.qkernels.values():
            total += qk.q.distinct_nbytes() + qk.scale.distinct_nbytes()
        for wq, sw in self.w8a8.values():
            total += wq.distinct_nbytes() + sw.distinct_nbytes()
        return total

    @contextlib.contextmanager
    def materialized(self):
        """The int8w kernels dequantised to the compute dtype on every
        position for one device call."""
        if not self.qkernels:
            yield
            return
        for key, qk in self.qkernels.items():
            shards = qk.q.shards.copy()
            for pos in self.mesh.positions():
                q, s = qk.q.local(pos), qk.scale.local(pos)
                shards[pos] = (q.float() * s.to(q.device).reshape(-1, *([1] * (q.dim() - 1)))).to(self.dtype)
            self._dequantized[key] = ShardedTensor(self.mesh, qk.q.spec, shards, qk.q.shape, self.dtype)
        try:
            yield
        finally:
            self._dequantized.clear()

    def _weight(self, key: str) -> ShardedTensor:
        if key in self.params:
            return self.params[key]
        if key in self._dequantized:
            return self._dequantized[key]
        raise RuntimeError(f"{key} rests int8: run the call inside MeshPagedLM.materialized()")

    def _full(self, key: str, i: int, j: int) -> torch.Tensor:
        """Parameter ``key`` whole on position (i, j): its model slices
        all-gathered when it is sharded (cached: these never change)."""
        ck = (key, i, j)
        got = self._full_cache.get(ck)
        if got is None:
            st = self.params[key]
            dims = [d for d, a in enumerate(st.spec) if a == self.grid.model_axis]
            parts = [st.local(self.grid.pos(i, jj)) for jj in range(self.grid.tp)]
            got = all_gather(parts, dims[0], self.grid.dev(i, j)) if dims else parts[j].to(self.grid.dev(i, j))
            self._full_cache[ck] = got
        return got

    def _gather_factor(self, st: ShardedTensor, i: int, j: int) -> torch.Tensor:
        dims = [d for d, a in enumerate(st.spec) if a == self.grid.model_axis]
        parts = [st.local(self.grid.pos(i, jj)) for jj in range(self.grid.tp)]
        return all_gather(parts, dims[0], self.grid.dev(i, j)) if dims else parts[j].to(self.grid.dev(i, j))

    # ---- layers ----------------------------------------------------------------

    def _embed(self, i: int, key: str, ids: torch.Tensor) -> List[torch.Tensor]:
        st = self.params[key]
        g = self.grid
        dims = [d for d, a in enumerate(st.spec) if a == g.model_axis]
        parts = []
        for j in range(g.tp):
            w = st.local(g.pos(i, j))
            idx = ids.to(w.device)
            if dims and dims[0] == 0:
                n = w.shape[0]
                local = idx - j * n
                hit = (local >= 0) & (local < n)
                e = F.embedding(local.clamp(0, n - 1), w)
                parts.append(torch.where(hit[..., None], e, torch.zeros((), dtype=e.dtype, device=e.device)))
            else:
                parts.append(F.embedding(idx, w))
        if not dims:
            return parts
        if dims[0] == 0:
            return [all_reduce(parts, g.dev(i, j)) for j in range(g.tp)]
        return [all_gather(parts, -1, g.dev(i, j)) for j in range(g.tp)]

    def _ln(self, i: int, prefix: str, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        return [F.layer_norm(x.float(), (self.d_model,), self._full(f"{prefix}.weight", i, j),
                             self._full(f"{prefix}.bias", i, j), eps=LN_EPS) for j, x in enumerate(xs)]

    def _dense(self, i: int, prefix: str, xs: List[torch.Tensor], lora_ab=None, adapter_idx=None):
        """Dense layer ``prefix`` on the whole input at every model
        position, its output whole at every model position (see the module
        docstring), plus the adapter delta."""
        g = self.grid
        if f"{prefix}.weight" in self.w8a8:
            return self._dense_w8a8(i, prefix, xs, lora_ab, adapter_idx)
        W = self._weight(f"{prefix}.weight")
        dims = [d for d, a in enumerate(W.spec) if a == g.model_axis]
        d = dims[0] if dims else None
        parts = []
        for j in range(g.tp):
            w = W.local(g.pos(i, j))
            x = xs[j].to(w.dtype)
            if d is None:
                parts.append(F.linear(x, w, self._full(f"{prefix}.bias", i, j)))
            elif d == 0:
                n = w.shape[0]
                parts.append(F.linear(x, w, self._full(f"{prefix}.bias", i, j)[j * n:(j + 1) * n]))
            else:
                n = w.shape[1]
                parts.append(F.linear(x[..., j * n:(j + 1) * n], w))
        if d is None:
            outs = parts
        elif d == 0:
            outs = [all_gather(parts, -1, g.dev(i, j)) for j in range(g.tp)]
        else:
            outs = [all_reduce(parts, g.dev(i, j)) + self._full(f"{prefix}.bias", i, j) for j in range(g.tp)]
        if lora_ab is not None:
            for j in range(g.tp):
                a, b = lora_ab[j]
                outs[j] = outs[j] + lora_delta(xs[j], a, b, adapter_idx[j]).to(outs[j].dtype)
        return outs

    def _dense_w8a8(self, i: int, prefix: str, xs: List[torch.Tensor], lora_ab=None, adapter_idx=None):
        """:meth:`_dense` in int8 x int8, as ``W8A8Dense`` computes it: the
        whole input quantised per token at every model position, an int8
        GEMM on the position's slice of the integers, the rescale and the
        bias in float32.  A row-parallel layer all-reduces its int32
        partial products before the rescale, so the sum is exact and the
        output is the one-device layer's bit for bit."""
        from seldon_core_tpu_torch.ops.w8a8 import _int_matmul, quantize_activation

        g = self.grid
        WQ, SW = self.w8a8[f"{prefix}.weight"]
        dims = [d for d, a in enumerate(WQ.spec) if a == g.model_axis]
        d = dims[0] if dims else None  # 0: the input dim (row-parallel), 1: the output dim
        parts, steps = [], []
        for j in range(g.tp):
            pos = g.pos(i, j)
            wq, sw = WQ.local(pos), SW.local(pos)
            xq, sx = quantize_activation(xs[j])
            steps.append(sx)
            if d == 0:
                n = wq.shape[0]
                parts.append(_int_matmul(xq[..., j * n:(j + 1) * n].contiguous(), wq))
                continue
            y = (_int_matmul(xq, wq).float() * (sx * sw)).to(self.dtype)
            bias = self._full(f"{prefix}.bias", i, j)
            if d == 1:
                n = wq.shape[1]
                bias = bias[j * n:(j + 1) * n]
            parts.append((y.float() + bias.float()).to(self.dtype))
        if d is None:
            outs = parts
        elif d == 1:
            outs = [all_gather(parts, -1, g.dev(i, j)) for j in range(g.tp)]
        else:
            outs = []
            for j in range(g.tp):
                acc = all_reduce(parts, g.dev(i, j))
                y = (acc.float() * (steps[j] * SW.local(g.pos(i, j)))).to(self.dtype)
                outs.append((y.float() + self._full(f"{prefix}.bias", i, j).float()).to(self.dtype))
        if lora_ab is not None:
            for j in range(g.tp):
                a, b = lora_ab[j]
                outs[j] = outs[j] + lora_delta(xs[j], a, b, adapter_idx[j]).to(outs[j].dtype)
        return outs

    def _heads(self, j: int) -> slice:
        if not self.heads_sharded:
            return slice(0, self.num_heads)
        return slice(j * self.heads_j, (j + 1) * self.heads_j)

    def _split(self, qkv: torch.Tensor, j: int):
        B, L, d3 = qkv.shape
        shape = (B, L, self.num_heads, self.head_dim)
        q, k, v = (t.reshape(shape)[:, :, self._heads(j)] for t in qkv.split(d3 // 3, dim=-1))
        return q, k, v

    def _join_heads(self, i: int, attn: List[torch.Tensor]) -> List[torch.Tensor]:
        """Every model position's head outputs (B, L, h_j, hd) -> the whole
        (B, L, d) on each position."""
        g = self.grid
        B, L = attn[0].shape[:2]
        if not self.heads_sharded:
            return [a.reshape(B, L, self.d_model) for a in attn]
        return [all_gather(attn, 2, g.dev(i, j)).reshape(B, L, self.d_model) for j in range(g.tp)]

    def _mlp_tail(self, i: int, l: int, xs, attn, lora_l, ai):
        p = f"blocks.{l}"
        proj = self._dense(i, f"{p}.attn_proj", attn, _take(lora_l, "attn_proj"), ai)
        xs = [x + a for x, a in zip(xs, proj)]
        h = self._dense(i, f"{p}.mlp_in", self._ln(i, f"{p}.ln1", xs), _take(lora_l, "mlp_in"), ai)
        h = [F.gelu(t, approximate="tanh") for t in h]
        out = self._dense(i, f"{p}.mlp_out", h, _take(lora_l, "mlp_out"), ai)
        return [x + o for x, o in zip(xs, out)]

    def _logits(self, i: int, xs: List[torch.Tensor]) -> torch.Tensor:
        return self._dense(i, "head", self._ln(i, "ln_f", xs))[0].float()

    # ---- the pool ----------------------------------------------------------------

    def gather_pages(self, pool: ShardedTensor, tb: torch.Tensor, i: int, j: int,
                     layer: Optional[int] = None) -> torch.Tensor:
        """Pages ``tb`` (nb, P) of one layer (or every layer) at position
        (i, j)'s heads, on its device: (nb, P, ps, h_j, hd), or (layers,
        nb, P, ps, h_j, hd)."""
        g = self.grid
        dev = g.dev(i, j)
        if not self.pages_sharded:
            t = pool.local(g.pos(i, j))
            t = t if layer is None else t[layer]
            idx = tb.to(t.device).long()
            return (t[:, idx] if layer is None else t[idx]).to(dev)
        per = pool.shape[1] // g.dp
        acc = None
        for p in range(g.dp):
            t = pool.local(g.pos(p, j))
            t = t if layer is None else t[layer]
            loc = tb.to(t.device).long() - p * per
            hit = (loc >= 0) & (loc < per)
            loc = loc.clamp(0, per - 1)
            got = t[:, loc] if layer is None else t[loc]
            mask = hit[..., None, None, None]
            if layer is None:
                mask = mask[None]
            got = torch.where(mask, got, torch.zeros((), dtype=got.dtype, device=got.device)).to(dev)
            acc = got if acc is None else acc + got
        return acc

    # ---- forwards ----------------------------------------------------------------

    def _overlaps(self, buckets, r: slice):
        """Each bucket's part of row group ``r``: (table rows, group-local
        slice)."""
        out = []
        for tb, sl in buckets:
            lo, hi = max(sl.start, r.start), min(sl.stop, r.stop)
            if lo < hi:
                out.append((tb[lo - sl.start:hi - sl.start], slice(lo - r.start, hi - r.start)))
        return out

    def _lora_parts(self, lora, i: int):
        """Per target, every model position's whole (A, B) of group ``i``."""
        if lora is None:
            return None
        return {t: [(self._gather_factor(a, i, j), self._gather_factor(b, i, j)) for j in range(self.grid.tp)]
                for t, (a, b) in lora.items()}

    def __call__(self, *args, cache: Optional["MeshDecodeCache"] = None, **kwargs):
        if cache is not None:
            return self.forward_cached(*args, cache=cache)
        return self.forward(*args, **kwargs)

    # ---- the contiguous decode cache (models/generate.py) ------------------------

    def init_cache(self, batch: int) -> "MeshDecodeCache":
        """A zero :class:`MeshDecodeCache` for ``batch`` rows: rows over
        ``data`` when dp divides them, heads over ``model``."""
        g = self.grid
        rows = g.rows(batch, batch % g.dp == 0)
        parts = {}
        for i, r in enumerate(rows):
            for j in range(g.tp):
                shape = (r.stop - r.start, self.max_len, self.heads_j, self.head_dim)
                parts[(i, j)] = ([torch.zeros(shape, dtype=self.dtype, device=g.dev(i, j))
                                  for _ in range(self.num_layers)],
                                 [torch.zeros(shape, dtype=self.dtype, device=g.dev(i, j))
                                  for _ in range(self.num_layers)])
        return MeshDecodeCache(rows, parts)

    def forward_cached(self, tokens, positions, cache: "MeshDecodeCache") -> torch.Tensor:
        """``TransformerLM.forward(..., cache=)`` over the mesh: this call's
        K/V written at slots ``cache.index``.. of each position's part, then
        attention over every slot under the causal mask (JAX
        ``_cached_attention``) -> float32 logits (B, L, vocab) on the first
        position's device; ``cache.index`` advances."""
        g = self.grid
        seg_len, index = tokens.shape[1], cache.index
        masks = {}
        for j in range(g.tp):
            for i in range(g.dp):
                dev = g.dev(i, j)
                q_pos = index + torch.arange(seg_len, device=dev)
                masks[(i, j)] = torch.arange(self.max_len, device=dev)[None, :] <= q_pos[:, None]

        def attend(i, j, layer, r, q, k, v):
            ck, cv = cache.parts[(i, j)][0][layer], cache.parts[(i, j)][1][layer]
            ck[:, index:index + seg_len] = k
            cv[:, index:index + seg_len] = v
            return cached_attention(q, ck, cv, masks[(i, j)])

        logits, _, _ = self._run(cache.rows, tokens.long(), positions, attend, keep_kv=False)
        cache.index += seg_len
        return logits

    def forward(self, tokens, positions, pages_k, pages_v, block_tables, lengths, *, use_kernel: bool = False,
                select: Optional[torch.Tensor] = None, kv_scales=None, lora=None, adapter_idx=None):
        """``PagedTransformerLM.forward`` on the gather lane over the mesh:
        -> ``(logits, new_k, new_v)``, the float32 logits whole on the
        first position's device and the K/V as :class:`LaneKV`."""
        if kv_scales is not None:
            raise ValueError("a mesh engine's pool is never int8")
        from seldon_core_tpu_torch.models.paged import _bucket_slices

        g = self.grid
        rows = g.rows(tokens.shape[0], self.lanes_sharded)
        buckets = _bucket_slices(block_tables)
        overlaps = [self._overlaps(buckets, r) for r in rows]
        lens = {(i, j): lengths[r].to(g.dev(i, j)) for i, r in enumerate(rows) for j in range(g.tp)}

        def attend(i, j, layer, r, q, k, v):
            return self._attend(i, j, layer, q, k, v, pages_k, pages_v, overlaps[i], lens[(i, j)])

        logits, nk, nv = self._run(rows, torch.remainder(tokens.long(), self.vocab_size), positions, attend,
                                   lora=lora, adapter_idx=adapter_idx, select=select)
        return logits, LaneKV(g, rows, nk), LaneKV(g, rows, nv)

    def _run(self, rows: List[slice], ids: torch.Tensor, positions: torch.Tensor, attend, *, lora=None,
             adapter_idx=None, select: Optional[torch.Tensor] = None, keep_kv: bool = True):
        """The LM's layers for every data group of ``rows``: the embeddings,
        then each block's LayerNorm and ``qkv``, ``attend(i, j, layer,
        rows_i, q, k, v)`` at model position ``j``'s heads, the output
        projection and the MLP, then the head (at ``select``'s position of
        each row when given) -> ``(float32 logits on the first position's
        device, {(i, j): K (layers, rows_i, L, h_j, hd)}, the same for V)``,
        the K/V parts only with ``keep_kv``."""
        g = self.grid
        out_dev = g.dev(0, 0)
        logits, nk, nv = [], {}, {}
        for i, r in enumerate(rows):
            if r.stop <= r.start:
                continue
            pos = positions.long().expand(r.stop - r.start, -1) if positions.dim() == 1 else positions[r].long()
            xs = [a + b for a, b in zip(self._embed(i, "tok_embed.weight", ids[r]),
                                        self._embed(i, "pos_embed.weight", pos))]
            ai = [adapter_idx[r].to(g.dev(i, j)) for j in range(g.tp)] if adapter_idx is not None else None
            lora_i = self._lora_parts(lora, i)
            ks = {j: [] for j in range(g.tp)}
            vs = {j: [] for j in range(g.tp)}
            for l in range(self.num_layers):
                lora_l = _layer(lora_i, l)
                p = f"blocks.{l}"
                qkv = self._dense(i, f"{p}.qkv", self._ln(i, f"{p}.ln0", xs), _take(lora_l, "qkv"), ai)
                attn = []
                for j in range(g.tp):
                    q, k, v = self._split(qkv[j], j)
                    attn.append(attend(i, j, l, r, q, k, v))
                    if keep_kv:
                        ks[j].append(k)
                        vs[j].append(v)
                xs = self._mlp_tail(i, l, xs, self._join_heads(i, attn), lora_l, ai)
            if select is not None:
                sel = select[r].long()
                xs = [x[torch.arange(x.shape[0], device=x.device), sel.to(x.device)][:, None] for x in xs]
            logits.append(self._logits(i, xs).to(out_dev))
            if keep_kv:
                for j in range(g.tp):
                    nk[(i, j)] = torch.stack(ks[j])
                    nv[(i, j)] = torch.stack(vs[j])
        return torch.cat(logits, dim=0), nk, nv

    def _attend(self, i, j, layer, q, k, v, pages_k, pages_v, overlaps, lengths):
        """The gather lane's attention at position (i, j)'s heads (the
        ``PagedTransformerBlock`` arithmetic)."""
        from seldon_core_tpu_torch.models.paged import gather_attention

        scale = _head_scale(self.head_dim, q.dtype)
        outs = [gather_attention(q[sl], k[sl], v[sl], self.gather_pages(pages_k, tb, i, j, layer),
                                 self.gather_pages(pages_v, tb, i, j, layer), lengths[sl], scale)
                for tb, sl in overlaps]
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)

    # ---- the ring chunk ------------------------------------------------------------

    def ring_context(self, pages_k: ShardedTensor, pages_v: ShardedTensor, split_tables: Sequence[torch.Tensor],
                     batch: int):
        """Each position's context for a ring chunk, gathered once: (i, j)
        -> [(group-local slice, ctx_k, ctx_v) a bucket], ctx (layers, nb,
        C, h_j, hd)."""
        g = self.grid
        rows = g.rows(batch, self.lanes_sharded)
        from seldon_core_tpu_torch.models.paged import _bucket_slices

        buckets = _bucket_slices(tuple(split_tables))
        ctx = {}
        for i, r in enumerate(rows):
            for j in range(g.tp):
                parts = []
                for tb, sl in self._overlaps(buckets, r):
                    ck = self.gather_pages(pages_k, tb, i, j)
                    cv = self.gather_pages(pages_v, tb, i, j)
                    L, nb, Pn, ps = ck.shape[:4]
                    parts.append((sl, ck.reshape(L, nb, Pn * ps, self.heads_j, self.head_dim),
                                  cv.reshape(L, nb, Pn * ps, self.heads_j, self.head_dim)))
                ctx[(i, j)] = parts
        return rows, ctx

    def ring_buffers(self, rows: List[slice], steps: int) -> Tuple[LaneKV, LaneKV]:
        return tuple(LaneKV.zeros(self.grid, rows, self.num_layers, steps, self.heads_j, self.head_dim, self.dtype)
                     for _ in range(2))

    def forward_ring(self, tokens, positions, rows: List[slice], ctx, ring_k: LaneKV, ring_v: LaneKV, step: int,
                     len0, *, lora=None, adapter_idx=None):
        """``PagedTransformerLM.forward_ring`` over the mesh: one decode
        step against the gathered context, the chunk's ring and the
        current token -> ``(logits, new_k, new_v)``."""
        g = self.grid
        l0 = {(i, j): len0[r].to(g.dev(i, j)) for i, r in enumerate(rows) for j in range(g.tp)}

        def attend(i, j, layer, r, q, k, v):
            return self._attend_ring(q, k, v, ctx[(i, j)], layer, ring_k.parts[(i, j)][layer],
                                     ring_v.parts[(i, j)][layer], step, l0[(i, j)])

        logits, nk, nv = self._run(rows, torch.remainder(tokens.long(), self.vocab_size), positions, attend,
                                   lora=lora, adapter_idx=adapter_idx)
        return logits, LaneKV(g, rows, nk), LaneKV(g, rows, nv)

    def _attend_ring(self, q, k, v, ctx, layer, ring_k, ring_v, step, len0):
        """The ring chunk's attention (``PagedTransformerBlock.forward_ring``
        arithmetic) at one position's heads."""
        from seldon_core_tpu_torch.models.paged import ring_step_attention

        scale = _head_scale(self.head_dim, q.dtype)
        outs = [ring_step_attention(q[sl], k[sl], v[sl], ck[layer], cv[layer], ring_k[sl], ring_v[sl], step, len0[sl],
                                    scale) for sl, ck, cv in ctx]
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)


class MeshDecodeCache:
    """:class:`models.transformer.DecodeCache` over a mesh: ``parts[(i,
    j)]`` is (keys, values), per layer (rows, max_len, heads_j,
    head_dim), and ``index`` the slot the next call writes first."""

    def __init__(self, rows: List[slice], parts, index: int = 0):
        self.rows, self.parts, self.index = rows, parts, int(index)

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for ks, vs in self.parts.values() for t in (*ks, *vs))


def _is_projection(key: str) -> bool:
    """The LM's dense kernels a w8a8 model serves int8 x int8: every
    block's four projections and the head."""
    parts = key.split(".")
    return key == "head.weight" or (len(parts) == 4 and parts[0] == "blocks" and parts[3] == "weight"
                                    and parts[2] in ("qkv", "attn_proj", "mlp_in", "mlp_out"))


def _layer(lora_i, l: int):
    if lora_i is None:
        return None
    return {t: [(a[l], b[l]) for a, b in parts] for t, parts in lora_i.items()}


def _take(lora_l, target: str):
    if lora_l is None:
        return None
    return lora_l.get(target)
