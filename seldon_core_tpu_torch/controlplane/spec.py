"""Deployment specification — the declarative API of the framework.

``TpuDeployment`` plays the role of the reference's SeldonDeployment CR
(reference: proto/seldon_deployment.proto:11-161,
operator/api/v1alpha2/seldondeployment_types.go): a named deployment
owning one or more **predictors**, each with an inference graph, a
replica count, and a traffic weight; plus deployment-wide annotations
for cross-cutting knobs (timeouts, max message sizes — the reference's
annotation system, reference: SURVEY §5.6).

Instead of pods, a predictor's resources are **CUDA devices**: each
predictor may pin device ids, and the placement planner assigns cards,
a group sized by the predictor's ``mesh_axes`` (``controlplane/placement.py``).

Loadable from YAML/JSON:

    name: image-classifier
    predictors:
      - name: main
        traffic: 90
        replicas: 1
        graph:
          name: clf
          type: MODEL
          implementation: CUDA_SERVER
          parameters:
            - {name: model, value: resnet50, type: STRING}
      - name: canary
        traffic: 10
        graph: { ... }
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from seldon_core_tpu_torch.engine.graph import GraphSpecError, UnitSpec, validate_graph


class DeploymentSpecError(ValueError):
    pass


@dataclass
class PredictorSpec:
    name: str
    graph: UnitSpec
    replicas: int = 1
    traffic: float = 0.0  # percent; 0 everywhere -> defaulted to even split
    shadow: bool = False
    labels: Dict[str, str] = field(default_factory=dict)
    # device resourcing
    device_ids: List[int] = field(default_factory=list)
    mesh_axes: Optional[Dict[str, int]] = None
    # explainer config, e.g. {"type": "integrated_gradients", "steps": 16}
    # (reference analogue: the Explainer CRD message,
    # proto/seldon_deployment.proto:45-51)
    explainer: Optional[Dict[str, Any]] = None
    # autoscaling policy consumed by controlplane.autoscaler.HpaSpec
    # (reference analogue: hpaSpec -> HorizontalPodAutoscaler,
    # operator/controllers/seldondeployment_controller.go:92-114)
    hpa: Optional[Dict[str, Any]] = None

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PredictorSpec":
        if "name" not in d:
            raise DeploymentSpecError("predictor missing 'name'")
        if "graph" not in d:
            raise DeploymentSpecError(f"predictor {d['name']!r} missing 'graph'")
        return cls(
            name=d["name"],
            graph=UnitSpec.from_dict(d["graph"]),
            replicas=int(d.get("replicas", 1)),
            traffic=float(d.get("traffic", 0.0)),
            shadow=bool(d.get("shadow", False)),
            labels=dict(d.get("labels", {})),
            device_ids=list(d.get("deviceIds", d.get("device_ids", []))),
            mesh_axes=d.get("meshAxes", d.get("mesh_axes")),
            explainer=d.get("explainer"),
            hpa=d.get("hpa", d.get("hpaSpec")),
        )

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "name": self.name,
            "graph": self.graph.to_dict(),
            "replicas": self.replicas,
            "traffic": self.traffic,
        }
        if self.shadow:
            out["shadow"] = True
        if self.labels:
            out["labels"] = self.labels
        if self.device_ids:
            out["deviceIds"] = self.device_ids
        if self.mesh_axes:
            out["meshAxes"] = self.mesh_axes
        if self.explainer:
            out["explainer"] = self.explainer
        if self.hpa:
            out["hpa"] = self.hpa
        return out


@dataclass
class TpuDeployment:
    name: str
    predictors: List[PredictorSpec] = field(default_factory=list)
    annotations: Dict[str, str] = field(default_factory=dict)
    namespace: str = "default"
    # gateway ports (defaulted like the reference webhook defaults
    # engine ports, reference: seldondeployment_webhook.go:137-351)
    http_port: Optional[int] = None
    grpc_port: Optional[int] = None
    # what the webhook changed (controlplane/defaulting.py): not part of
    # the spec's dict, reported by Deployer.status
    status: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TpuDeployment":
        if "name" not in d:
            raise DeploymentSpecError("deployment missing 'name'")
        predictors = [PredictorSpec.from_dict(p) for p in d.get("predictors", [])]
        return cls(
            name=d["name"],
            predictors=predictors,
            annotations={k: str(v) for k, v in d.get("annotations", {}).items()},
            namespace=d.get("namespace", "default"),
            http_port=d.get("httpPort", d.get("http_port")),
            grpc_port=d.get("grpcPort", d.get("grpc_port")),
        )

    @classmethod
    def from_yaml(cls, text: str) -> "TpuDeployment":
        import yaml

        return cls.from_dict(yaml.safe_load(text))

    @classmethod
    def load(cls, path: str) -> "TpuDeployment":
        with open(path) as f:
            text = f.read()
        if path.endswith(".json"):
            return cls.from_dict(json.loads(text))
        return cls.from_yaml(text)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "namespace": self.namespace,
            "predictors": [p.to_dict() for p in self.predictors],
            "annotations": self.annotations,
            "httpPort": self.http_port,
            "grpcPort": self.grpc_port,
        }

    def annotation_float(self, key: str, default: float) -> float:
        try:
            return float(self.annotations[key])
        except (KeyError, ValueError):
            return default
