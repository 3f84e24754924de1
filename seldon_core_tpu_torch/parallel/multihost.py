"""Multi-host support over ``torch.distributed``.

The port's counterpart of ``seldon_core_tpu/parallel/multihost.py``.
Within one process a mesh is driven explicitly (``parallel/mesh.py``);
across processes the JAX package joins the ``jax.distributed`` runtime,
and the port joins a ``torch.distributed`` process group instead (gloo
on the CPU, NCCL on CUDA).  Cross-host graph edges stay at the engine's
remote transports, as in the JAX package.

The arguments default from the names the repo's deployments set:
``JAX_COORDINATOR_ADDRESS`` (``host:port``), ``JAX_NUM_PROCESSES`` and
``JAX_PROCESS_ID``.  :func:`global_mesh` spans every process's positions;
each process holds the tensors of its own, and a reduction over the
whole mesh (:func:`psum`) adds the local positions first and then
all-reduces across the processes.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from seldon_core_tpu_torch.parallel.mesh import Mesh, available_devices, create_mesh
from seldon_core_tpu_torch.parallel.sharding import all_reduce

logger = logging.getLogger(__name__)

_LOCAL: List[torch.device] = []


def _env_int(name: str) -> Optional[int]:
    raw = os.environ.get(name)
    return int(raw) if raw else None


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() else None


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, local_devices: Optional[Sequence] = None,
               backend: Optional[str] = None) -> bool:
    """Join the process group (idempotent); True when more than one
    process runs.

    ``local_devices`` are this process's mesh positions (default its
    CUDA devices; the CPU tests pass CPU positions).  With no coordinator
    and no process count this is a single process and nothing is joined.
    ``backend`` defaults to NCCL when the positions are CUDA devices,
    gloo otherwise."""
    global _LOCAL
    coordinator_address = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    num_processes = num_processes or _env_int("JAX_NUM_PROCESSES")
    process_id = process_id if process_id is not None else _env_int("JAX_PROCESS_ID")
    devs = [torch.device(d) for d in local_devices] if local_devices is not None else available_devices()
    _LOCAL = devs
    dist = _dist()
    if dist is not None and dist.is_initialized():
        return dist.get_world_size() > 1
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("multihost.initialize needs a coordinator address, a process count and a process id "
                         "(arguments or JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID)")
    if backend is None:
        backend = "nccl" if devs and all(d.type == "cuda" for d in devs) else "gloo"
    addr = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend=backend, init_method=addr, world_size=int(num_processes),
                            rank=int(process_id))
    return dist.get_world_size() > 1


def _world() -> tuple:
    dist = _dist()
    if dist is not None and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _local_counts() -> List[int]:
    """Every process's count of local positions, in rank order."""
    _rank, world = _world()
    if world == 1:
        return [len(_LOCAL)]
    dist = _dist()
    counts = [None] * world
    dist.all_gather_object(counts, len(_LOCAL))
    return [int(c) for c in counts]


class GlobalMesh(Mesh):
    """A mesh over every process's positions: ``process_ids`` (the grid's
    shape) names the process that holds each position; this process
    drives the positions whose id is its rank."""

    def __init__(self, devices: np.ndarray, axis_names, process_ids: np.ndarray, rank: int):
        super().__init__(devices, axis_names)
        self.process_ids = process_ids
        self.rank = rank

    def local_positions(self) -> List[tuple]:
        return [pos for pos in self.positions() if self.process_ids[pos] == self.rank]


def global_mesh(axes: Dict[str, int]) -> GlobalMesh:
    """A mesh over every position of every process (call after
    :func:`initialize`); axis sizes follow :func:`create_mesh`.  Positions
    are ordered by process rank, then by each process's local order."""
    rank, _world_size = _world()
    counts = _local_counts()
    devices, owners = [], []
    for r, n in enumerate(counts):
        for i in range(n):
            # another process's position is named by its local index; only
            # the owner ever touches its tensors
            devices.append(_LOCAL[i] if r == rank else torch.device("meta"))
            owners.append(r)
    mesh = create_mesh(axes, devices=devices)
    ids = np.asarray(owners[: mesh.size]).reshape(mesh.devices.shape)
    return GlobalMesh(mesh.devices, mesh.axis_names, ids, rank)


def psum(values: Dict[tuple, torch.Tensor], mesh: GlobalMesh) -> torch.Tensor:
    """The sum over every position of ``mesh`` of ``values`` (this
    process's positions -> their tensors): the local positions are
    all-reduced in position order, then the processes' sums are
    all-reduced by ``torch.distributed``."""
    local = [values[pos] for pos in mesh.local_positions()]
    device = local[0].device
    total = all_reduce(local, device).clone()
    _rank, world = _world()
    if world > 1:
        _dist().all_reduce(total)
    return total


def host_info() -> Dict[str, int]:
    rank, world = _world()
    counts = _local_counts()
    return {
        "process_index": rank,
        "process_count": world,
        "local_devices": len(_LOCAL),
        "global_devices": int(sum(counts)),
    }
