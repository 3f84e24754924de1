"""Spec defaulting + validation — the "webhook" stage.

The reference runs every SeldonDeployment through a mutating webhook
(port assignment, image/host defaulting) and a validating webhook
(graph cross-checks, traffic sums) before the reconciler sees it
(reference: seldondeployment_webhook.go:137-351 Default,
:358-446 validate).  Same two passes here, pure functions over the
spec.

Two rules of the port beside the JAX package's:

* **The server's name (C26).**  Specs written for the JAX package name
  ``implementation: JAX_SERVER``; the port serves the same parameters
  as ``CUDA_SERVER`` (``models/cudaserver.py``).  :func:`apply_defaults`
  rewrites each such node, logs it and records it in the spec's
  ``status["rewrites"]``.  The graph registry keeps no ``JAX_SERVER``.
  A ``component_class`` under the JAX package (``seldon_core_tpu.``)
  is a validation error: a worker of the port never imports it.

A predictor's ``mesh_axes`` sizes its device group at placement, as in
the JAX package.
"""

from __future__ import annotations

import logging
from typing import List

from seldon_core_tpu_torch.controlplane.spec import DeploymentSpecError, TpuDeployment
from seldon_core_tpu_torch.engine.graph import GraphSpecError, UnitSpec, validate_graph

logger = logging.getLogger(__name__)

DEFAULT_HTTP_PORT = 8000
DEFAULT_GRPC_PORT = 5001
# per-node microservice ports assigned from this base, mirroring the
# reference's 9000+ scheme (reference: seldondeployment_webhook.go:137-351)
NODE_PORT_BASE = 9000

# C26: implementation names of the JAX package -> the port's
RENAMED_IMPLEMENTATIONS = {"JAX_SERVER": "CUDA_SERVER"}
JAX_PACKAGE_PREFIX = "seldon_core_tpu."


def apply_defaults(dep: TpuDeployment) -> TpuDeployment:
    """Fill ports, traffic weights, and per-node endpoints in place."""
    if dep.http_port is None:
        dep.http_port = DEFAULT_HTTP_PORT
    if dep.grpc_port is None:
        dep.grpc_port = DEFAULT_GRPC_PORT

    live = [p for p in dep.predictors if not p.shadow]
    # traffic defaulting: all-zero -> even split (the reference requires
    # explicit weights only when >1 predictor; we're more forgiving)
    if live and all(p.traffic == 0.0 for p in live):
        for p in live:
            p.traffic = 100.0 / len(live)

    rewrites = dep.status.setdefault("rewrites", [])
    for predictor in dep.predictors:
        for unit in predictor.graph.walk():
            new = RENAMED_IMPLEMENTATIONS.get((unit.implementation or "").upper())
            if new is not None:
                note = f"predictor {predictor.name!r} node {unit.name!r}: {unit.implementation} -> {new}"
                logger.info("implementation rewritten (C26): %s", note)
                rewrites.append(note)
                unit.implementation = new

    # assign deterministic ports to remote (endpoint-less but
    # externally-served) nodes: nodes with component/implementation run
    # in-process and need none
    next_port = NODE_PORT_BASE
    for predictor in dep.predictors:
        for unit in predictor.graph.walk():
            if unit.endpoint is not None and unit.endpoint.port == 0:
                unit.endpoint.port = next_port
                next_port += 1
    return dep


def validate(dep: TpuDeployment) -> List[str]:
    """Return a list of violations (empty = valid).

    Mirrors the reference's validating webhook rules: unique predictor
    names, per-graph structural checks, traffic weights summing to ~100
    when more than one live predictor exists
    (reference: seldondeployment_webhook.go:385-399).
    """
    problems: List[str] = []
    if not dep.predictors:
        problems.append("deployment has no predictors")
    names = [p.name for p in dep.predictors]
    if len(set(names)) != len(names):
        problems.append(f"duplicate predictor names: {names}")
    for p in dep.predictors:
        if p.replicas < 1:
            problems.append(f"predictor {p.name!r}: replicas must be >= 1")
        try:
            validate_graph(p.graph)
        except GraphSpecError as e:
            problems.append(f"predictor {p.name!r}: {e}")
        for unit in p.graph.walk():
            if (unit.component_class or "").startswith(JAX_PACKAGE_PREFIX):
                problems.append(
                    f"predictor {p.name!r} node {unit.name!r}: component_class {unit.component_class!r} "
                    "belongs to the JAX package; a worker of the PyTorch port never imports it "
                    "(name the seldon_core_tpu_torch class)")
    live = [p for p in dep.predictors if not p.shadow]
    if len(live) > 1:
        total = sum(p.traffic for p in live)
        if abs(total - 100.0) > 1.0:
            problems.append(f"traffic weights of live predictors sum to {total}, expected 100")
    return problems


def default_and_validate(dep: TpuDeployment) -> TpuDeployment:
    dep = apply_defaults(dep)
    problems = validate(dep)
    if problems:
        raise DeploymentSpecError("; ".join(problems))
    return dep
