"""Sharding layouts: how parameters, pools and activations map onto a mesh.

The port's counterpart of ``seldon_core_tpu/parallel/sharding.py``.  The
JAX package annotates shardings and lets GSPMD insert the collectives;
here a sharded tensor is explicit: a :class:`ShardedTensor` holds one
tensor a mesh position, and the collectives (:func:`all_gather`,
:func:`all_reduce`, :func:`ppermute`) are plain functions on per-position
tensors, run by the one process that drives every position.

* :class:`P` is a partition spec: a tuple of axis names or ``None``, one
  entry a tensor dimension (missing trailing entries are ``None``).
* :func:`infer_param_specs` is the JAX package's heuristic, spec for
  spec: a leaf of at least ``min_weight_size`` elements shards its
  largest dimension that divides the model-axis size (ties go to the
  first such dimension), smaller leaves replicate, and a
  :class:`ops.surgery.QuantizedKernel` gets paired specs.
* :func:`shard_params` puts one shard a position along that dimension,
  replicated over the other axes: a sharded leaf gets its own tensor at
  every position, a replicated one is kept once per distinct device.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from seldon_core_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh, mesh_shape

logger = logging.getLogger(__name__)


class P(tuple):
    """A partition spec: ``P()`` replicates, ``P(None, "model")`` shards
    dimension 1 over the ``model`` axis.  Equal, as a tuple, to the JAX
    ``PartitionSpec`` of the same entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"

    def axis_of(self, dim: int) -> Optional[str]:
        return self[dim] if dim < len(self) else None


class NamedSharding:
    """A spec bound to a mesh (the JAX ``NamedSharding``'s counterpart)."""

    def __init__(self, mesh: Mesh, spec: P):
        self.mesh, self.spec = mesh, P(*spec)

    def __eq__(self, other) -> bool:
        return isinstance(other, NamedSharding) and self.mesh == other.mesh and self.spec == other.spec

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh.shape}, {self.spec!r})"


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def data_sharded(mesh: Mesh, axis: str = DATA_AXIS) -> NamedSharding:
    """Batch dim sharded, everything else replicated."""
    return NamedSharding(mesh, P(axis))


# ---------------------------------------------------------------------------
# collectives: plain functions on per-position tensors
# ---------------------------------------------------------------------------

def all_gather(parts: Sequence[torch.Tensor], dim: int, device) -> torch.Tensor:
    """The concatenation of ``parts`` along ``dim``, on ``device``."""
    if len(parts) == 1:
        return parts[0].to(device)
    return torch.cat([p.to(device) for p in parts], dim=dim)


def all_reduce(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The sum of ``parts`` on ``device``, added in position order (a fixed
    order, so the bits never depend on which position asks)."""
    out = parts[0].to(device)
    for p in parts[1:]:
        out = out + p.to(device)
    return out


def ppermute(parts: Sequence[torch.Tensor], perm: Iterable[Tuple[int, int]],
             devices: Sequence[torch.device]) -> List[Optional[torch.Tensor]]:
    """``out[dst] = parts[src]`` moved to ``devices[dst]`` for every
    ``(src, dst)`` pair of ``perm``; a position no pair names gets None."""
    out: List[Optional[torch.Tensor]] = [None] * len(parts)
    for src, dst in perm:
        out[dst] = parts[src].to(devices[dst])
    return out


# ---------------------------------------------------------------------------
# the sharded-tensor holder
# ---------------------------------------------------------------------------

def _shard_slices(shape: Sequence[int], spec: P, mesh: Mesh, pos: Tuple[int, ...]) -> Tuple[slice, ...]:
    sizes = mesh_shape(mesh)
    out = []
    for dim, n in enumerate(shape):
        axis = spec.axis_of(dim)
        if axis is None:
            out.append(slice(None))
            continue
        parts = sizes.get(axis, 1)
        chunk = n // parts
        i = mesh.coord(pos, axis)
        out.append(slice(i * chunk, (i + 1) * chunk))
    return tuple(out)


def check_spec(shape: Sequence[int], spec: P, mesh: Mesh) -> None:
    """ValueError when ``spec`` cannot lay ``shape`` out on ``mesh`` (the
    rejections JAX's ``device_put`` raises: rank, an unknown axis, an
    indivisible dimension)."""
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec!r} has more entries than the rank {len(shape)} of shape {tuple(shape)}")
    sizes = mesh_shape(mesh)
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        if axis not in sizes:
            raise ValueError(f"spec {spec!r} names axis {axis!r}, not one of the mesh's {tuple(sizes)}")
        if shape[dim] % sizes[axis]:
            raise ValueError(f"dimension {dim} of shape {tuple(shape)} is not divisible by mesh axis "
                             f"{axis!r} of size {sizes[axis]}")


class ShardedTensor:
    """One tensor a mesh position, laid out by ``spec``.

    ``shards`` is a numpy object array in the mesh's shape; a position's
    entry is its local tensor on its own device.  Positions that share
    a device and the same slice share one tensor object (a replicated
    leaf is kept once per distinct device); positions whose slices
    differ each hold their own."""

    def __init__(self, mesh: Mesh, spec: P, shards: np.ndarray, shape: Sequence[int], dtype: torch.dtype):
        self.mesh, self.spec, self.shards = mesh, P(*spec), shards
        self.shape = torch.Size(shape)
        self.dtype = dtype

    @classmethod
    def from_tensor(cls, mesh: Mesh, tensor: torch.Tensor, spec: P) -> "ShardedTensor":
        """Slice ``tensor`` onto ``mesh``: each position gets its slice on
        its device (ValueError for a spec the shape rejects)."""
        if not torch.is_tensor(tensor):
            raise TypeError(f"cannot shard a {type(tensor).__name__}")
        spec = P(*spec)
        check_spec(tensor.shape, spec, mesh)
        shards = np.empty(mesh.devices.shape, dtype=object)
        cache: Dict[Tuple, torch.Tensor] = {}
        for pos in mesh.positions():
            sl = _shard_slices(tensor.shape, spec, mesh, pos)
            dev = mesh.device(pos)
            key = (str(dev), tuple((s.start, s.stop) for s in sl))
            if key not in cache:
                sharded = any(s != slice(None) for s in sl)
                cache[key] = tensor[sl].to(dev).contiguous() if sharded else tensor.to(dev)
            shards[pos] = cache[key]
        return cls(mesh, spec, shards, tensor.shape, tensor.dtype)

    @classmethod
    def zeros(cls, mesh: Mesh, shape: Sequence[int], spec: P, dtype: torch.dtype) -> "ShardedTensor":
        """Zeros created already sharded: each position allocates only its
        own slice (never the whole tensor on one device first)."""
        spec = P(*spec)
        check_spec(shape, spec, mesh)
        shards = np.empty(mesh.devices.shape, dtype=object)
        cache: Dict[Tuple, torch.Tensor] = {}
        for pos in mesh.positions():
            sl = _shard_slices(shape, spec, mesh, pos)
            local = tuple(len(range(*s.indices(n))) for s, n in zip(sl, shape))
            dev = mesh.device(pos)
            key = (str(dev), tuple((s.start, s.stop) for s in sl))
            if key not in cache:
                cache[key] = torch.zeros(local, dtype=dtype, device=dev)
            shards[pos] = cache[key]
        return cls(mesh, spec, shards, shape, dtype)

    def local(self, pos: Tuple[int, ...]) -> torch.Tensor:
        return self.shards[pos]

    def local_shape(self) -> Tuple[int, ...]:
        return tuple(self.shards.flat[0].shape)

    def position_nbytes(self, pos: Tuple[int, ...]) -> int:
        t = self.shards[pos]
        return t.numel() * t.element_size()

    def distinct_nbytes(self) -> int:
        """Bytes of the distinct tensors behind every position."""
        seen, total = set(), 0
        for t in self.shards.flat:
            if id(t) not in seen:
                seen.add(id(t))
                total += t.numel() * t.element_size()
        return total

    def full(self, device=None) -> torch.Tensor:
        """The global tensor assembled on ``device`` (default the first
        position's): an all-gather along every sharded dimension."""
        device = device if device is not None else self.mesh.devices.flat[0]
        sizes = mesh_shape(self.mesh)
        grid = self.shards
        # fold the mesh axes one at a time: gather along the tensor dim an
        # axis shards, take index 0 of an axis no dim names
        out = grid
        for axis_idx in reversed(range(len(self.mesh.axis_names))):
            axis = self.mesh.axis_names[axis_idx]
            dims = [d for d, a in enumerate(self.spec) if a == axis]
            new = np.empty(out.shape[:axis_idx] + out.shape[axis_idx + 1:], dtype=object)
            for idx in np.ndindex(*new.shape):
                parts = [out[idx[:axis_idx] + (k,) + idx[axis_idx:]] for k in range(sizes[axis])]
                new[idx] = all_gather(parts, dims[0], device) if dims else parts[0].to(device)
            out = new
        return out.reshape(()).item() if out.shape else out.item()

    def _blocks(self):
        """Each distinct local tensor once, with its global slices."""
        seen = set()
        for pos in self.mesh.positions():
            t = self.shards[pos]
            if id(t) in seen:
                continue
            seen.add(id(t))
            yield t, _shard_slices(self.shape, self.spec, self.mesh, pos)

    def take(self, dim: int, index: torch.Tensor, device=None) -> torch.Tensor:
        """The global tensor's entries ``index`` along ``dim`` (every other
        dimension whole), assembled on ``device``: each position gives
        the rows it holds."""
        device = device if device is not None else self.mesh.devices.flat[0]
        idx = torch.as_tensor(index).reshape(-1).long().cpu()
        shape = list(self.shape)
        shape[dim] = idx.numel()
        out = torch.zeros(shape, dtype=self.dtype, device=device)
        for t, sl in self._blocks():
            lo, hi, _ = sl[dim].indices(self.shape[dim])
            sel = ((idx >= lo) & (idx < hi)).nonzero().reshape(-1)
            if sel.numel() == 0:
                continue
            src = t.index_select(dim, (idx[sel] - lo).to(t.device)).to(device)
            view = out[tuple(slice(None) if d == dim else s for d, s in enumerate(sl))]
            view.index_copy_(dim, sel.to(device), src)
        return out

    def put(self, dim: int, index: torch.Tensor, value: torch.Tensor) -> None:
        """Write ``value`` at entries ``index`` along ``dim`` (every other
        dimension whole): each position takes the rows it holds."""
        idx = torch.as_tensor(index).reshape(-1).long().cpu()
        for t, sl in self._blocks():
            lo, hi, _ = sl[dim].indices(self.shape[dim])
            sel = ((idx >= lo) & (idx < hi)).nonzero().reshape(-1)
            if sel.numel() == 0:
                continue
            part = value[tuple(slice(None) if d == dim else s for d, s in enumerate(sl))]
            part = part.index_select(dim, sel.to(part.device)).to(device=t.device, dtype=t.dtype)
            t.index_copy_(dim, (idx[sel] - lo).to(t.device), part)

    def __getitem__(self, key):
        """``x[:, index]``: :meth:`take` along dimension 1."""
        if isinstance(key, tuple) and len(key) == 2 and key[0] == slice(None):
            return self.take(1, key[1])
        raise TypeError(f"ShardedTensor supports x[:, index] only, got {key!r}")

    def __setitem__(self, key, value) -> None:
        """``x[:, index] = value``: :meth:`put` along dimension 1."""
        if isinstance(key, tuple) and len(key) == 2 and key[0] == slice(None):
            return self.put(1, key[1], value)
        raise TypeError(f"ShardedTensor supports x[:, index] = value only, got {key!r}")

    def __repr__(self) -> str:
        return f"ShardedTensor(shape={tuple(self.shape)}, spec={self.spec!r}, mesh={self.mesh.shape})"


# ---------------------------------------------------------------------------
# the parameter heuristic and placement
# ---------------------------------------------------------------------------

def _is_quantized(x) -> bool:
    from seldon_core_tpu_torch.ops.surgery import QuantizedKernel

    return isinstance(x, QuantizedKernel)


def tree_map(fn: Callable, tree: Any, *rest: Any, is_leaf: Optional[Callable[[Any], bool]] = None) -> Any:
    """``fn`` over the leaves of nested dicts, lists and tuples (a P is a
    leaf, as is anything ``is_leaf`` accepts)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, P):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        out = [tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf) for i, v in enumerate(tree)]
        return type(tree)(out)
    return fn(tree, *rest)


def dense_spec(shape: Sequence[int], axis_size: int, model_axis: str = MODEL_AXIS,
               min_weight_size: int = 16_384, prefer: Optional[int] = None) -> P:
    """The JAX heuristic for one array: at least ``min_weight_size``
    elements, its largest dimension that divides ``axis_size`` (ties to
    the lower dimension; ``prefer`` is tried first), else replicated."""
    shape = tuple(int(s) for s in shape)
    if axis_size <= 1 or not shape or int(np.prod(shape)) < min_weight_size:
        return P()
    order = sorted(range(len(shape)), key=lambda d: shape[d], reverse=True)
    if prefer is not None:
        order.remove(prefer)
        order.insert(0, prefer)
    for dim in order:
        if shape[dim] % axis_size == 0 and shape[dim] >= axis_size:
            entries: List[Optional[str]] = [None] * len(shape)
            entries[dim] = model_axis
            return P(*entries)
    return P()


def quantized_spec(q_shape: Sequence[int], axis_size: int, model_axis: str = MODEL_AXIS,
                   min_weight_size: int = 16_384, out_dim: int = 0):
    """Paired specs of a quantised kernel: ``q`` prefers its output-channel
    dimension ``out_dim`` (the port's ``QuantizedKernel`` keeps it first,
    flax last); the ``(N,)`` scale follows it when ``q`` shards there and
    replicates otherwise (JAX ``sharding.py:63-75``)."""
    from seldon_core_tpu_torch.ops.surgery import QuantizedKernel

    q_spec = dense_spec(q_shape, axis_size, model_axis, min_weight_size, prefer=out_dim % len(q_shape))
    if q_spec and q_spec.axis_of(out_dim % len(q_shape)) == model_axis:
        return QuantizedKernel(q_spec, P(model_axis))
    return QuantizedKernel(q_spec, P())


def infer_param_specs(params: Any, mesh: Mesh, model_axis: str = MODEL_AXIS, min_weight_size: int = 16_384):
    """Tensor-parallel partition specs for a parameter tree, the JAX
    package's rule leaf for leaf (a flax-layout tree gives JAX's specs).
    A :class:`ops.surgery.QuantizedKernel` leaf (``q`` in the port's
    layout, output channel first) gets ``QuantizedKernel(q_spec,
    scale_spec)``."""
    axis_size = mesh_shape(mesh).get(model_axis, 1)

    def spec_for(x):
        if _is_quantized(x):
            return quantized_spec(tuple(x.q.shape), axis_size, model_axis, min_weight_size, out_dim=0)
        return dense_spec(tuple(getattr(x, "shape", ())), axis_size, model_axis, min_weight_size)

    return tree_map(spec_for, params, is_leaf=_is_quantized)


def _flax_view(key: str, shape: Sequence[int]) -> Optional[tuple]:
    """The permutation taking a port tensor to its flax layout (and back
    for a spec): dense (out, in) -> (in, out), conv OIHW -> HWIO;
    ``None`` for leaves whose layouts agree."""
    if not key.endswith("weight") or len(shape) not in (2, 4) or "embed" in key:
        return None
    return (1, 0) if len(shape) == 2 else (2, 3, 1, 0)


def param_spec(key: str, shape: Sequence[int], axis_size: int, model_axis: str = MODEL_AXIS,
               min_weight_size: int = 16_384) -> P:
    """JAX's spec for the flax leaf behind a port parameter, in the port's
    layout (a dense or conv kernel's spec transposed back)."""
    perm = _flax_view(key, shape)
    if perm is None:
        return dense_spec(shape, axis_size, model_axis, min_weight_size)
    flax_shape = [shape[p] for p in perm]
    flax_spec = dense_spec(flax_shape, axis_size, model_axis, min_weight_size)
    if not flax_spec:
        return P()
    entries: List[Optional[str]] = [None] * len(shape)
    for flax_dim, port_dim in enumerate(perm):
        entries[port_dim] = flax_spec.axis_of(flax_dim)
    return P(*entries)


def _put(x, spec: P, mesh: Mesh):
    """One leaf placed by ``spec``; a rejected spec degrades to replicated
    with a WARN and a leaf that cannot be placed stays on the host with a
    WARN.  Only spec rejections degrade (ValueError / TypeError): a
    device out-of-memory error propagates, since retrying replicated
    needs more memory."""
    tensor = torch.from_numpy(np.asarray(x)) if isinstance(x, np.ndarray) else x
    try:
        return ShardedTensor.from_tensor(mesh, tensor, spec)
    except (TypeError, ValueError):
        if tuple(spec) != ():
            logger.warning("parameter leaf %s (shape %s) rejected spec %s — falling back to replicated",
                           type(x).__name__, tuple(getattr(x, "shape", ())) or "?", spec)
            try:
                return ShardedTensor.from_tensor(mesh, tensor, P())
            except (TypeError, ValueError):
                pass
        logger.warning("parameter leaf %s is not device-placeable — leaving it host-side", type(x).__name__)
        return x


def shard_params(params: Any, mesh: Mesh, specs: Optional[Any] = None, model_axis: str = MODEL_AXIS,
                 min_weight_size: int = 16_384):
    """Place a parameter tree on ``mesh`` by tensor-parallel specs: a tree
    of :class:`ShardedTensor` (a quantised kernel's ``q`` and ``scale``
    each one), with the JAX package's degrade rules (:func:`_put`)."""
    from seldon_core_tpu_torch.ops.surgery import QuantizedKernel

    if specs is None:
        specs = infer_param_specs(params, mesh, model_axis=model_axis, min_weight_size=min_weight_size)

    def put(x, spec):
        if _is_quantized(x):
            return QuantizedKernel(_put(x.q, spec.q, mesh), _put(x.scale, spec.scale, mesh))
        return _put(x, spec, mesh)

    return tree_map(put, params, specs, is_leaf=_is_quantized)


def pool_spec(mesh: Optional[Mesh], *, num_pages: int, num_heads: int, model_axis: str = MODEL_AXIS,
              data_axis: str = DATA_AXIS, seq_shard: bool = True) -> P:
    """The K/V pool's spec on ``mesh`` (JAX ``sharding.py:201-243``): heads
    (dim 3) over ``model`` when ``num_heads`` divides it, pages (dim 1)
    over ``data`` when sequence sharding is on and ``num_pages`` divides
    it; each refusal WARNs as in the JAX package."""
    if mesh is None:
        return P()
    shape = mesh_shape(mesh)
    axis_size = shape.get(model_axis, 1)
    dp_size = shape.get(data_axis, 1)
    if axis_size > 1 and num_heads % axis_size == 0:
        heads_entry = model_axis
    else:
        if axis_size > 1:
            logger.warning(
                "KV pool NOT sharded over (%r, %r): num_heads=%d is not divisible by mesh axis %r size %d — "
                "every device will hold the full head dim (no per-device memory win). Pick a head count "
                "divisible by the model-axis size.", data_axis, model_axis, num_heads, model_axis, axis_size)
        heads_entry = None
    if dp_size > 1 and seq_shard and num_pages % dp_size == 0:
        pages_entry = data_axis
    else:
        if dp_size > 1 and seq_shard:
            logger.warning(
                "KV pool NOT sharded over (%r, %r): num_pages=%d is not divisible by mesh axis %r size %d — "
                "every device will hold the full page dim (no long-context capacity win). Pick a pool size "
                "divisible by the data-axis size.", data_axis, model_axis, num_pages, data_axis, dp_size)
        pages_entry = None
    return P(None, pages_entry, None, heads_entry)


def shard_decode_state(params: Any, mesh: Optional[Mesh], *, pool_shape: Sequence[int], dtype: torch.dtype,
                       model_axis: str = MODEL_AXIS, data_axis: str = DATA_AXIS, min_weight_size: int = 16_384,
                       num_heads: Optional[int] = None, seq_shard: bool = True, device=None):
    """Serving-mesh layout for the paged decode lanes: tensor-parallel
    parameter specs and K/V pools sharded on both mesh axes (heads over
    ``model``, pages over ``data``; see :func:`pool_spec`), created
    already sharded.  ``mesh=None`` is the one-device case: the
    parameters moved to ``device`` and plain zero pools there.

    Returns ``(params, pool_k, pool_v)``."""
    if mesh is None:
        moved = tree_map(lambda x: x.to(device) if torch.is_tensor(x) else x, params)
        return (moved, torch.zeros(tuple(pool_shape), dtype=dtype, device=device),
                torch.zeros(tuple(pool_shape), dtype=dtype, device=device))
    params = shard_params(params, mesh, model_axis=model_axis, min_weight_size=min_weight_size)
    spec = pool_spec(mesh, num_pages=pool_shape[1], num_heads=pool_shape[3] if num_heads is None else num_heads,
                     model_axis=model_axis, data_axis=data_axis, seq_shard=seq_shard)
    return (params, ShardedTensor.zeros(mesh, pool_shape, spec, dtype),
            ShardedTensor.zeros(mesh, pool_shape, spec, dtype))


def sharding_tree(specs: Any, mesh: Mesh):
    """Specs -> :class:`NamedSharding` leaves."""
    from seldon_core_tpu_torch.ops.surgery import QuantizedKernel

    def named(spec):
        if _is_quantized(spec):
            return QuantizedKernel(NamedSharding(mesh, spec.q), NamedSharding(mesh, spec.scale))
        return NamedSharding(mesh, spec)

    return tree_map(named, specs, is_leaf=_is_quantized)
