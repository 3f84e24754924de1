"""Device meshes: a grid of ``torch.device`` positions with named axes.

The port's counterpart of ``seldon_core_tpu/parallel/mesh.py``.  A
:class:`Mesh` is ``axis_names`` plus a numpy object array of
``torch.device`` in the grid's shape.  Positions may repeat a device: a
``{"data": 2, "model": 2}`` mesh of four ``cuda:0`` positions runs the
sharded programs on one card, as the JAX package's tests run theirs on
forced host devices (see ``parallel/__init__.py`` for the design).

Conventions, as in the JAX package:

* ``data``  -- batch-dimension sharding (replica groups);
* ``model`` -- tensor-parallel parameter sharding.

The serving knobs keep the JAX package's precedence (mesh > ``mesh_axes``
> ``tp=`` / ``dp=`` > ``SELDON_TPU_TP`` / ``SELDON_TPU_DP``), its degrade
order (the data axis shrinks first) and its messages.  The device count
they degrade against is the number of distinct CUDA devices.
"""

from __future__ import annotations

import logging
import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from seldon_core_tpu_torch.runtime import knobs

logger = logging.getLogger(__name__)

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """Named axes over a grid of ``torch.device`` positions.

    ``devices`` is a numpy object array whose shape is the grid's (one
    dimension per axis, in ``axis_names`` order).  A device may fill
    several positions; each position still holds its own shards."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh grid of rank {devices.ndim} needs {devices.ndim} axis names, "
                             f"got {tuple(axis_names)}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"duplicate mesh axis names {tuple(axis_names)}")
        self.devices = devices
        self.axis_names: Tuple[str, ...] = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def positions(self) -> Iterator[Tuple[int, ...]]:
        """Every position's grid index, in row-major order."""
        return np.ndindex(*self.devices.shape)

    def device(self, pos: Tuple[int, ...]) -> torch.device:
        return self.devices[pos]

    def distinct_devices(self) -> List[torch.device]:
        """The mesh's devices, each once, in row-major order."""
        out: List[torch.device] = []
        for d in self.devices.flat:
            if d not in out:
                out.append(d)
        return out

    def coord(self, pos: Tuple[int, ...], axis: str) -> int:
        """``pos``'s index along ``axis`` (0 when the mesh lacks it)."""
        if axis not in self.axis_names:
            return 0
        return int(pos[self.axis_names.index(axis)])

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh) and self.axis_names == other.axis_names
                and self.devices.shape == other.devices.shape
                and all(a == b for a, b in zip(self.devices.flat, other.devices.flat)))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def available_devices() -> List[torch.device]:
    """The host's distinct CUDA devices (none without a card)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def create_mesh(axes: Optional[Dict[str, int]] = None, devices: Optional[Sequence] = None) -> Mesh:
    """Build a :class:`Mesh`.

    ``axes`` maps axis name -> size; a size of -1 means "everything left"
    (at most one axis).  Axis order is the grid order: list ``data``
    before ``model`` (the :func:`resolve_mesh` convention).  Default (no
    ``axes``): every device on ``data``.

    ``devices`` defaults to every CUDA device of the host; with no card
    and no ``devices`` this raises (a mesh never falls back to the CPU).
    An explicit list may repeat a device, and may name the CPU."""
    if devices is None:
        devices = available_devices()
        if not devices:
            raise RuntimeError("create_mesh: no CUDA device on this host and no devices given "
                               "(a mesh never falls back to the CPU)")
    devices = [d if isinstance(d, torch.device) else torch.device(d) for d in devices]
    if axes is None:
        axes = {DATA_AXIS: len(devices)}
    sizes = dict(axes)
    wildcards = [k for k, v in sizes.items() if v == -1]
    if len(wildcards) > 1:
        raise ValueError("at most one mesh axis may be -1")
    fixed = math.prod(v for v in sizes.values() if v != -1)
    if wildcards:
        if len(devices) % fixed:
            raise ValueError(f"{len(devices)} devices not divisible by {fixed}")
        sizes[wildcards[0]] = len(devices) // fixed
    total = math.prod(sizes.values())
    if total > len(devices):
        raise ValueError(f"mesh {sizes} needs {total} devices, have {len(devices)}")
    grid = np.empty((total,), dtype=object)
    for i, d in enumerate(devices[:total]):
        grid[i] = d
    return Mesh(grid.reshape(tuple(sizes.values())), tuple(sizes.keys()))


def single_device_mesh(device=None) -> Mesh:
    """Degenerate one-position mesh so sharded code paths run anywhere."""
    return create_mesh({DATA_AXIS: 1}, devices=None if device is None else [device])


def mesh_from_axes(mesh_axes, devices: Optional[Sequence] = None) -> Optional[Mesh]:
    """``{"model": 4}`` -> Mesh, or None when ``mesh_axes`` is falsy."""
    return create_mesh(dict(mesh_axes), devices=devices) if mesh_axes else None


def _resolve_degree(value: Optional[int], knob: str, what: str) -> int:
    if value is None or int(value) == 0:
        raw = (knobs.raw(knob, "") or "").strip()
        value = int(raw) if raw else 1
        if value == 0:
            value = 1
    value = int(value)
    if value < 1:
        raise ValueError(f"{what} degree must be >= 1, got {value}")
    return value


def resolve_tp(tp: Optional[int] = None) -> int:
    """Tensor-parallel degree: an explicit ``tp`` wins (``1`` forces one
    device even with the knob exported); ``None`` / ``0`` defers to
    ``SELDON_TPU_TP``, where unset, empty and ``0`` all mean 1."""
    return _resolve_degree(tp, "SELDON_TPU_TP", "tensor-parallel")


def resolve_dp(dp: Optional[int] = None) -> int:
    """Data-parallel degree: :func:`resolve_tp`'s twin over ``SELDON_TPU_DP``."""
    return _resolve_degree(dp, "SELDON_TPU_DP", "data-parallel")


def resolve_mesh(mesh: Optional[Mesh] = None, mesh_axes: Optional[Dict[str, int]] = None,
                 tp: Optional[int] = None, dp: Optional[int] = None, *, strict: bool = False,
                 data_axis: str = DATA_AXIS, model_axis: str = MODEL_AXIS,
                 devices: Optional[Sequence] = None) -> Optional[Mesh]:
    """The serving-mesh precedence home: ``{"data": D, "model": M}``.

    1. an explicit ``mesh`` is returned as is;
    2. ``mesh_axes`` is built as given (:func:`create_mesh`, over
       ``devices`` when given);
    3. ``tp=`` / ``dp=``;
    4. ``SELDON_TPU_TP`` / ``SELDON_TPU_DP`` (unset / ``0`` = 1).

    A size-1 axis is dropped, and ``dp=tp=1`` gives ``None`` (the
    one-device engine).  The mesh is data-major.  With fewer distinct
    CUDA devices than ``dp*tp`` the data axis shrinks first; when even
    ``tp`` does not fit the mesh degrades to one device.  Both WARN
    naming both axes; ``strict=True`` raises instead."""
    if mesh is not None:
        return mesh
    if mesh_axes:
        return create_mesh(dict(mesh_axes), devices=devices)
    tp = resolve_tp(tp)
    dp = resolve_dp(dp)
    if dp <= 1:
        return tp_mesh(tp, axis=model_axis, strict=strict)
    devs = available_devices()
    avail = len(devs)
    if tp > avail:
        msg = (f"serving mesh ({data_axis}={dp}, {model_axis}={tp}) needs {dp * tp} devices but the host "
               f"exposes {avail} and even the model axis alone does not fit — degrading to single-chip "
               f"({data_axis}=1, {model_axis}=1)")
        if strict:
            raise ValueError(msg)
        logger.warning(msg)
        return None
    if dp * tp > avail:
        fit = max(1, avail // tp)
        msg = (f"serving mesh ({data_axis}={dp}, {model_axis}={tp}) needs {dp * tp} devices but the host "
               f"exposes {avail} — shrinking the data axis first: ({data_axis}={fit}, {model_axis}={tp})")
        if strict:
            raise ValueError(msg)
        logger.warning(msg)
        dp = fit
        if dp <= 1:
            return tp_mesh(tp, axis=model_axis, strict=strict)
    axes = {data_axis: dp}
    if tp > 1:
        axes[model_axis] = tp
    return create_mesh(axes, devices=devs[: dp * tp])


def tp_mesh(tp: Optional[int] = None, *, axis: str = MODEL_AXIS, strict: bool = False) -> Optional[Mesh]:
    """``{"model": tp}`` serving mesh over distinct CUDA devices, or
    ``None`` when tensor parallelism is off.  With fewer devices than the
    degree it degrades to one device (``None``) with a WARN;
    ``strict=True`` raises instead."""
    tp = resolve_tp(tp)
    if tp <= 1:
        return None
    devs = available_devices()
    if len(devs) < tp:
        msg = (f"tensor-parallel degree {tp} needs {tp} devices but the host exposes {len(devs)} — "
               f"degrading to single-chip (tp=1)")
        if strict:
            raise ValueError(msg)
        logger.warning(msg)
        return None
    return create_mesh({axis: tp}, devices=devs[:tp])


def mesh_shape(mesh: Mesh) -> Dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.devices.shape))
