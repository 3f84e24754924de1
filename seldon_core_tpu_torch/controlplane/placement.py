"""Device placement — graph nodes onto CUDA cards.

The reference's scheduler is Kubernetes: one container per graph node,
kube-scheduler picks machines.  Here the schedulable resource is the
CUDA device set of this host (``range(torch.cuda.device_count())``):
each predictor gets a device group sized by its ``mesh_axes`` request
(or one device), chosen round-robin so co-deployed predictors don't
contend for the same card (the multi-tenancy concern of SURVEY §7
"hard parts").  :meth:`PredictorPlacement.build_mesh` turns a group into
the port's ``parallel.mesh.Mesh`` over those cards.

With no card and no ``device_ids`` the planner raises
:class:`DeploymentSpecError`: there is no quiet CPU plan.  A caller
that serves on the CPU passes ``device_ids`` itself (the tests pass
``[0]``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from seldon_core_tpu_torch.controlplane.spec import DeploymentSpecError, TpuDeployment


def cuda_device_ids() -> List[int]:
    """The ids of this host's CUDA cards; raises when there is none."""
    import torch

    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise DeploymentSpecError(
            "no CUDA device to place the deployment on; pass device_ids explicitly "
            "(e.g. Deployer(device_ids=[0])) to plan a CPU deployment")
    return list(range(count))


@dataclass
class PredictorPlacement:
    predictor: str
    device_ids: List[int]
    mesh_axes: Optional[Dict[str, int]] = None

    def build_mesh(self):
        """The port's ``Mesh`` over this placement's CUDA devices (JAX
        ``placement.py:27-37``): shaped by ``mesh_axes``, else one ``data``
        axis over the group.  A device id the host's cards do not have
        fails placement."""
        import torch

        from seldon_core_tpu_torch.parallel.mesh import create_mesh

        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        missing = [i for i in self.device_ids if not 0 <= int(i) < count]
        if missing:
            raise DeploymentSpecError(
                f"predictor {self.predictor!r}: devices {missing} are not among this host's {count} CUDA "
                "devices")
        devices = [torch.device("cuda", int(i)) for i in self.device_ids]
        if self.mesh_axes:
            return create_mesh(dict(self.mesh_axes), devices=devices)
        return create_mesh({"data": len(devices)}, devices=devices)


@dataclass
class PlacementPlan:
    placements: Dict[str, PredictorPlacement] = field(default_factory=dict)

    def for_predictor(self, name: str) -> Optional[PredictorPlacement]:
        return self.placements.get(name)


def plan_placement(dep: TpuDeployment, device_ids: Optional[List[int]] = None) -> PlacementPlan:
    """Assign device groups to predictors.

    Explicit ``deviceIds`` on a predictor are honoured (after checking
    they exist and don't collide); others are packed round-robin.
    A ``mesh_axes`` request sizes the group to the mesh volume.
    """
    if device_ids is None:
        device_ids = cuda_device_ids()
    available = list(device_ids)
    plan = PlacementPlan()

    # explicit claims first
    for p in dep.predictors:
        if p.device_ids:
            missing = [i for i in p.device_ids if i not in available]
            if missing:
                raise DeploymentSpecError(
                    f"predictor {p.name!r} claims unavailable devices {missing}"
                )
            for i in p.device_ids:
                available.remove(i)
            plan.placements[p.name] = PredictorPlacement(p.name, list(p.device_ids), p.mesh_axes)

    # size-derived assignment for the rest; wrap around (time-sliced
    # sharing) when demand exceeds supply — cards multiplex predictors
    cursor = 0
    pool = available if available else list(device_ids)
    for p in dep.predictors:
        if p.name in plan.placements:
            continue
        want = math.prod(p.mesh_axes.values()) if p.mesh_axes else 1
        if want > len(pool):
            raise DeploymentSpecError(
                f"predictor {p.name!r} wants {want} devices, only {len(pool)} available"
            )
        ids = [pool[(cursor + i) % len(pool)] for i in range(want)]
        cursor = (cursor + want) % len(pool)
        plan.placements[p.name] = PredictorPlacement(p.name, ids, p.mesh_axes)
    return plan
