"""Sharded training step (dp + tp over a named mesh).

The port's counterpart of ``seldon_core_tpu/parallel/train.py``.  The
JAX trainer is one jit program over the mesh; here one process drives
every position explicitly:

* the batch is split over ``data``: each data position runs the module
  on its rows, with its own copy of the weights, through a
  :class:`MeshBatch` (one tensor a data position; every torch call on it
  runs once a position);
* parameters are laid out by ``infer_param_specs`` (the JAX specs of
  the flax-layout view) over ``model``, as are the AdamW moments: a data
  group gathers its full weights from the model positions before the
  forward, and each model position updates only its own slice;
* BatchNorm statistics are taken over the **global** batch, as the JAX
  program's in-program reduction does: the sums and sums of squares of
  every data position are all-reduced before any position normalises,
  and the running statistics move with flax's momentum (0.9 for the
  ResNets);
* gradients are all-reduced over ``data`` before the step; the step is
  ``torch.optim.AdamW`` with optax's ``adamw`` defaults set explicitly
  (weight decay 1e-4, eps 1e-8; torch's default decay is 1e-2).

The JAX package has no custom gradient on any Pallas kernel, so the
backward is autograd through the port's modules; a kernel without a
backward raises when its input needs a gradient.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from seldon_core_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh, mesh_shape
from seldon_core_tpu_torch.parallel.sharding import (P, ShardedTensor, _shard_slices, all_gather, all_reduce,
                                                     param_spec)

# optax.adamw's defaults (torch.optim.AdamW's weight decay default is 1e-2)
ADAMW_WEIGHT_DECAY = 1e-4
ADAMW_EPS = 1e-8
ADAMW_BETAS = (0.9, 0.999)


def cross_entropy_loss(logits: torch.Tensor, labels) -> torch.Tensor:
    """Mean softmax cross-entropy, in float32 (the JAX package's)."""
    log_probs = F.log_softmax(logits.float(), dim=-1)
    labels = torch.as_tensor(labels, device=logits.device).long()
    one_hot = F.one_hot(labels, logits.shape[-1]).float()
    return -(one_hot * log_probs).sum(dim=-1).mean()


def _find(obj) -> Optional["MeshBatch"]:
    if isinstance(obj, MeshBatch):
        return obj
    if isinstance(obj, (list, tuple)):
        for x in obj:
            found = _find(x)
            if found is not None:
                return found
    if isinstance(obj, dict):
        for x in obj.values():
            found = _find(x)
            if found is not None:
                return found
    return None


def _pick(obj, i: int):
    if isinstance(obj, MeshBatch):
        return obj.parts[i]
    if isinstance(obj, tuple):
        return tuple(_pick(x, i) for x in obj)
    if isinstance(obj, list):
        return [_pick(x, i) for x in obj]
    if isinstance(obj, dict):
        return {k: _pick(v, i) for k, v in obj.items()}
    return obj


class MeshBatch(torch.Tensor):
    """A value laid out over a mesh's data positions: ``parts[i]`` is data
    position ``i``'s tensor on its device.  Every torch call on a
    ``MeshBatch`` runs once a position on that position's parts and
    returns a ``MeshBatch`` of the results (a non-tensor result, such as a
    shape, is the first position's).  ``batch_norm`` is the exception
    when ``norm`` is set: it calls ``norm(args, kwargs)``, which sees
    every position at once (the trainer's global-batch statistics)."""

    parts: List[torch.Tensor]

    @staticmethod
    def __new__(cls, parts: Sequence[torch.Tensor], norm=None):
        obj = torch.Tensor._make_subclass(cls, torch.empty(0, dtype=parts[0].dtype))
        obj.parts = list(parts)
        obj.norm = norm
        return obj

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ctx = _find(args)
        if ctx is None:
            ctx = _find(kwargs)
        if ctx.norm is not None and func in (F.batch_norm, torch.batch_norm):
            return ctx.norm(args, kwargs)
        outs = []
        with torch._C.DisableTorchFunctionSubclass():
            for i in range(len(ctx.parts)):
                outs.append(func(*_pick(args, i), **_pick(kwargs, i)))
        return cls._wrap(outs, ctx.norm)

    @classmethod
    def _wrap(cls, outs, norm):
        first = outs[0]
        if isinstance(first, torch.Tensor):
            return cls(outs, norm)
        if isinstance(first, (tuple, list)) and first and all(isinstance(x, torch.Tensor) for x in first):
            return type(first)(cls([o[k] for o in outs], norm) for k in range(len(first)))
        return first

    def __repr__(self) -> str:
        return f"MeshBatch({[tuple(p.shape) for p in self.parts]})"


class ShardedTrainer:
    """Sharded train state and a train step for one module.

    ``module``: a port ``nn.Module`` whose ``forward`` takes a batch
    (``ResNet``, ``MLPClassifier`` ...); it is the program, its own
    tensors are not trained.  ``params`` (a ``state_dict``) sets the
    initial weights, as the tests carry the JAX module's through
    ``models/convert.py``; without it the module is initialised in
    flax's scheme from a ``torch.Generator`` seeded with ``seed``.
    ``example_input`` is one unbatched example (kept for the JAX
    signature; the port's modules need no shape to initialise)."""

    def __init__(self, module: torch.nn.Module, example_input: np.ndarray, mesh: Mesh,
                 learning_rate: float = 1e-3, data_axis: str = DATA_AXIS, model_axis: str = MODEL_AXIS,
                 has_batch_stats: bool = True, seed: int = 0, min_weight_size: int = 16_384,
                 params: Optional[Dict[str, torch.Tensor]] = None, bn_momentum: float = 0.9):
        self.module = module
        self.mesh = mesh
        self.example_shape = tuple(np.shape(example_input))
        self.data_axis, self.model_axis = data_axis, model_axis
        self.has_batch_stats = has_batch_stats
        self.bn_momentum = float(bn_momentum)
        self.learning_rate = float(learning_rate)
        self.step = 0
        # the last step's gradients, all-reduced over data (name -> tensor)
        self.grads: Dict[str, torch.Tensor] = {}
        if params is None:
            gen = torch.Generator().manual_seed(int(seed))
            module.reset_parameters(gen)
            params = module.state_dict()
        state = {k: v.detach().to("cpu") for k, v in params.items()}
        names = dict(module.named_parameters())
        buffers = dict(module.named_buffers())
        self.param_keys = [k for k in state if k in names]
        self.stat_keys = [k for k in state if k in buffers and ("running" in k)] if has_batch_stats else []
        axis_size = mesh_shape(mesh).get(model_axis, 1)
        self.specs = {k: param_spec(k, state[k].shape, axis_size, model_axis, min_weight_size)
                      for k in self.param_keys}
        self.params = {k: ShardedTensor.from_tensor(mesh, state[k].float().clone(), self.specs[k])
                       for k in self.param_keys}
        self.batch_stats = {k: ShardedTensor.from_tensor(mesh, state[k].float().clone(), P())
                            for k in self.stat_keys}
        # the data positions: each runs its rows at model coordinate 0
        self._data_pos = self._positions_along(data_axis)
        self._opt_tensors = self._distinct_shards()
        self.opt = torch.optim.AdamW(self._opt_tensors, lr=self.learning_rate, betas=ADAMW_BETAS,
                                     eps=ADAMW_EPS, weight_decay=ADAMW_WEIGHT_DECAY, foreach=False)

    # ---- layout helpers --------------------------------------------------------

    def _positions_along(self, axis: str) -> List[tuple]:
        n = mesh_shape(self.mesh).get(axis, 1)
        out = []
        for i in range(n):
            pos = [0] * len(self.mesh.axis_names)
            if axis in self.mesh.axis_names:
                pos[self.mesh.axis_names.index(axis)] = i
            out.append(tuple(pos))
        return out

    def _model_group(self, data_pos: tuple) -> List[tuple]:
        """The positions of ``data_pos``'s model group, in axis order."""
        if self.model_axis not in self.mesh.axis_names:
            return [data_pos]
        a = self.mesh.axis_names.index(self.model_axis)
        out = []
        for j in range(self.mesh.devices.shape[a]):
            pos = list(data_pos)
            pos[a] = j
            out.append(tuple(pos))
        return out

    def _distinct_shards(self) -> List[torch.Tensor]:
        seen, out = set(), []
        for sharded in self.params.values():
            for t in sharded.shards.flat:
                if id(t) not in seen:
                    seen.add(id(t))
                    out.append(t)
        return out

    def _gather_full(self, sharded: ShardedTensor, data_pos: tuple) -> torch.Tensor:
        """A data group's full copy of one parameter on its device: the
        model positions' slices all-gathered along the sharded dim."""
        dev = self.mesh.device(data_pos)
        dims = [d for d, a in enumerate(sharded.spec) if a == self.model_axis]
        parts = [sharded.local(p) for p in self._model_group(data_pos)]
        return all_gather(parts, dims[0], dev) if dims else parts[0].to(dev)

    def _split_rows(self, arr: np.ndarray, dtype) -> List[torch.Tensor]:
        n = len(self._data_pos)
        if arr.shape[0] % n:
            raise ValueError(f"batch of {arr.shape[0]} rows does not divide over {n} data positions")
        rows = arr.shape[0] // n
        return [torch.as_tensor(arr[i * rows:(i + 1) * rows], dtype=dtype).to(self.mesh.device(pos))
                for i, pos in enumerate(self._data_pos)]

    # ---- BatchNorm over the global batch ---------------------------------------

    def _global_norm(self, args, kwargs):
        """flax ``BatchNorm(use_running_average=False)``: mean and
        ``max(0, mean(x^2) - mean^2)`` over the global batch (sums
        all-reduced across the data positions), ``(x - mean) * (rsqrt(var +
        eps) * scale) + bias`` on every position, and the running
        statistics moved by ``momentum``."""
        names = ("input", "running_mean", "running_var", "weight", "bias", "training", "momentum", "eps")
        a = dict(zip(names, args))
        a.update(kwargs)
        x, rm, rv, w, b, eps = a["input"], a["running_mean"], a["running_var"], a["weight"], a["bias"], a["eps"]
        parts = x.parts
        dev0 = parts[0].device
        axes = [0] + list(range(2, parts[0].dim()))
        count = sum(p.numel() // p.shape[1] for p in parts)
        mean = all_reduce([p.sum(dim=axes) for p in parts], dev0) / count
        mean2 = all_reduce([(p * p).sum(dim=axes) for p in parts], dev0) / count
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        shape = [1, -1] + [1] * (parts[0].dim() - 2)
        outs = []
        for i, p in enumerate(parts):
            m_i, v_i = mean.to(p.device).reshape(shape), var.to(p.device).reshape(shape)
            mul = torch.rsqrt(v_i + eps) * _pick(w, i).reshape(shape)
            outs.append((p - m_i) * mul + _pick(b, i).reshape(shape))
        with torch.no_grad():
            mom = self.bn_momentum
            for stats, batch in ((rm, mean), (rv, var)):
                seen = set()
                for t in (stats.parts if isinstance(stats, MeshBatch) else [stats]):
                    if id(t) not in seen:
                        seen.add(id(t))
                        t.copy_(mom * t + (1.0 - mom) * batch.detach().to(t.device))
        return MeshBatch(outs, x.norm)

    # ---- the steps --------------------------------------------------------------

    def _bound(self, train: bool):
        """``{name: MeshBatch}`` of every data position's leaf copies (and
        the statistics' replicas) for ``functional_call``."""
        leaves: Dict[str, List[torch.Tensor]] = {}
        bound: Dict[str, MeshBatch] = {}
        norm = self._global_norm if train else None
        for k, sharded in self.params.items():
            copies = []
            for pos in self._data_pos:
                t = self._gather_full(sharded, pos).detach()
                copies.append(t.requires_grad_(train))
            leaves[k] = copies
            bound[k] = MeshBatch(copies, norm)
        for k, sharded in self.batch_stats.items():
            bound[k] = MeshBatch([sharded.local(pos) for pos in self._data_pos], norm)
        return bound, leaves

    def train_batch(self, images: np.ndarray, labels: np.ndarray) -> Dict[str, float]:
        """One step on ``images`` / ``labels``: the loss and accuracy of the
        global batch before the update, and the step count."""
        images = np.asarray(images, np.float32)
        labels = np.asarray(labels)
        xs = self._split_rows(images, torch.float32)
        ys = self._split_rows(labels, torch.long)
        bound, leaves = self._bound(train=True)
        x = MeshBatch(xs, self._global_norm)
        logits = torch.func.functional_call(self.module, bound, (x,))
        parts = logits.parts
        dev0 = parts[0].device
        total = images.shape[0]
        nll = [-(F.one_hot(y, p.shape[-1]).float() * F.log_softmax(p.float(), dim=-1)).sum()
               for p, y in zip(parts, ys)]
        loss = all_reduce(nll, dev0) / total
        correct = all_reduce([(torch.argmax(p, -1) == y).float().sum() for p, y in zip(parts, ys)], dev0)
        loss.backward()
        self.grads = {}
        with torch.no_grad():
            for k, sharded in self.params.items():
                # gradients all-reduced over data, then each position keeps
                # the slice its shard holds
                grad = all_reduce([c.grad for c in leaves[k]], dev0)
                self.grads[k] = grad
                for pos in self.mesh.positions():
                    t = sharded.local(pos)
                    sl = _shard_slices(sharded.shape, sharded.spec, self.mesh, pos)
                    t.grad = grad[sl].to(t.device).contiguous()
            self.opt.step()
            self.opt.zero_grad(set_to_none=True)
        self.step += 1
        return {"loss": float(loss.detach()), "accuracy": float(correct) / total, "step": self.step}

    @torch.no_grad()
    def predict_batch(self, images: np.ndarray) -> np.ndarray:
        """Eval-mode logits (running statistics) of ``images``, rows in order."""
        xs = self._split_rows(np.asarray(images, np.float32), torch.float32)
        bound, _ = self._bound(train=False)
        out = torch.func.functional_call(self.module, bound, (MeshBatch(xs),))
        return torch.cat([p.float().cpu() for p in out.parts], dim=0).numpy()

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The trained weights and statistics as the module's ``state_dict``
        (float32 CPU tensors)."""
        out = {k: v.full(torch.device("cpu")).clone() for k, v in self.params.items()}
        out.update({k: v.full(torch.device("cpu")).clone() for k, v in self.batch_stats.items()})
        return out

    def serving_variables(self) -> Dict[str, Any]:
        """The trained variables in flax's layout (``{"params": ...}`` plus
        ``"batch_stats"`` when the module has them), as the JAX trainer
        hands them to ``JaxServer``; ``utils/serialization.to_bytes`` of
        this is a ``model_uri`` ``CudaServer`` loads."""
        from seldon_core_tpu_torch.models.convert import flax_variables

        variables = flax_variables(self.module, self.state_dict())
        if not (self.has_batch_stats and self.batch_stats):
            variables.pop("batch_stats", None)
        return variables
