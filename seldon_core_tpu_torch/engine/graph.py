"""Inference-graph specification.

The declarative graph of node roles the reference encodes in its CRD
(reference: proto/seldon_deployment.proto:82-161 ``PredictiveUnit``):
a recursive tree of MODEL / ROUTER / COMBINER / TRANSFORMER /
OUTPUT_TRANSFORMER nodes.  Each node is served either

* **in-process** (``component`` — a live TPUComponent; co-located graph
  edges then cost a function call, not a network hop), or
* **remotely** (``endpoint`` — REST or gRPC microservice, for cross-host
  / DCN edges), or
* by a **builtin** implementation (``implementation`` — registry name,
  the reference's in-engine hardcoded units,
  reference: PredictorConfigBean.java:20-60).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

MODEL = "MODEL"
ROUTER = "ROUTER"
COMBINER = "COMBINER"
TRANSFORMER = "TRANSFORMER"
OUTPUT_TRANSFORMER = "OUTPUT_TRANSFORMER"
UNKNOWN_TYPE = "UNKNOWN_TYPE"

UNIT_TYPES = (MODEL, ROUTER, COMBINER, TRANSFORMER, OUTPUT_TRANSFORMER, UNKNOWN_TYPE)

# node methods
TRANSFORM_INPUT = "TRANSFORM_INPUT"
TRANSFORM_OUTPUT = "TRANSFORM_OUTPUT"
ROUTE = "ROUTE"
AGGREGATE = "AGGREGATE"
SEND_FEEDBACK = "SEND_FEEDBACK"

# Which methods each node type exercises during graph execution
# (reference: PredictorConfigBean.java:20-60; note a MODEL's
# TRANSFORM_INPUT maps onto its predict endpoint).
TYPE_METHODS: Dict[str, List[str]] = {
    MODEL: [TRANSFORM_INPUT, SEND_FEEDBACK],
    TRANSFORMER: [TRANSFORM_INPUT],
    OUTPUT_TRANSFORMER: [TRANSFORM_OUTPUT],
    ROUTER: [ROUTE, SEND_FEEDBACK],
    COMBINER: [AGGREGATE],
    UNKNOWN_TYPE: [],
}

REST = "REST"
GRPC = "GRPC"


class GraphSpecError(ValueError):
    pass


@dataclass
class Endpoint:
    host: str = "localhost"
    port: int = 9000
    transport: str = GRPC  # REST | GRPC


@dataclass
class UnitSpec:
    """One node of the inference graph."""

    name: str
    type: str = MODEL
    implementation: str = ""  # builtin registry name, or ""
    children: List["UnitSpec"] = field(default_factory=list)
    component: Optional[Any] = None  # in-process user object
    component_class: str = ""  # dotted path "pkg.module.Class" to instantiate
    endpoint: Optional[Endpoint] = None  # remote microservice
    parameters: List[Dict[str, Any]] = field(default_factory=list)
    methods: List[str] = field(default_factory=list)  # only for UNKNOWN_TYPE
    model_uri: str = ""
    image: str = ""  # recorded into meta.requestPath
    # TPU placement hints consumed by the control plane
    device_ids: List[int] = field(default_factory=list)
    sharding: Optional[Dict[str, Any]] = None
    # run this node out-of-process: the deployer spawns a supervised
    # microservice worker and fills in `endpoint` (the DCN edge — the
    # reference's engine->microservice pod-network hop)
    remote: bool = False
    # degraded answer path: an alternate subtree the executor runs
    # instead of this node when its breaker is open or its retries
    # exhaust (502/503); the answer is tagged `degraded` / `fallback_for`
    # in meta so callers can tell it from a primary answer
    fallback: Optional["UnitSpec"] = None

    def node_methods(self) -> List[str]:
        if self.type == UNKNOWN_TYPE:
            return self.methods
        return TYPE_METHODS[self.type]

    def has_method(self, method: str) -> bool:
        return method in self.node_methods()

    def walk(self):
        """Every node of the subtree, INCLUDING fallback subtrees — so
        validation, client construction, placement and remote-worker
        spawning all see fallback nodes exactly like primaries (a
        fallback that was never built would fail at the worst moment:
        while its primary is down)."""
        yield self
        for child in self.children:
            yield from child.walk()
        if self.fallback is not None:
            yield from self.fallback.walk()

    def clone(self) -> "UnitSpec":
        """Structural copy: fresh UnitSpec nodes, shared leaf values.

        In-process ``component`` objects are shared by reference (they
        may hold live device buffers); everything the control plane
        mutates per generation (``endpoint`` fills for remote workers)
        lands on the copy, so re-applying one spec object never bleeds
        endpoints between generations.
        """
        import dataclasses

        return dataclasses.replace(
            self,
            children=[c.clone() for c in self.children],
            parameters=list(self.parameters),
            device_ids=list(self.device_ids),
            # endpoints are mutated by defaulting (port fill) — copy them
            endpoint=dataclasses.replace(self.endpoint) if self.endpoint else None,
            fallback=self.fallback.clone() if self.fallback else None,
        )

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "UnitSpec":
        """Parse the JSON/YAML graph form (CRD-equivalent)."""
        if "name" not in d:
            raise GraphSpecError(f"graph node missing 'name': {d!r}")
        unit_type = d.get("type", MODEL).upper()
        if unit_type not in UNIT_TYPES:
            raise GraphSpecError(f"unknown unit type {unit_type!r} for node {d['name']!r}")
        endpoint = None
        if "endpoint" in d:
            e = d["endpoint"]
            endpoint = Endpoint(
                host=e.get("host", "localhost"),
                port=int(e.get("port", 9000)),
                transport=e.get("transport", e.get("type", GRPC)).upper(),
            )
        return cls(
            name=d["name"],
            type=unit_type,
            implementation=d.get("implementation", ""),
            children=[cls.from_dict(c) for c in d.get("children", [])],
            component_class=d.get("componentClass", d.get("component_class", "")),
            endpoint=endpoint,
            parameters=list(d.get("parameters", [])),
            methods=[m.upper() for m in d.get("methods", [])],
            model_uri=d.get("modelUri", d.get("model_uri", "")),
            image=d.get("image", ""),
            device_ids=list(d.get("deviceIds", d.get("device_ids", []))),
            sharding=d.get("sharding"),
            remote=bool(d.get("remote", False)),
            fallback=cls.from_dict(d["fallback"]) if d.get("fallback") else None,
        )

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"name": self.name, "type": self.type}
        if self.implementation:
            out["implementation"] = self.implementation
        if self.component_class:
            out["componentClass"] = self.component_class
        if self.endpoint:
            out["endpoint"] = {
                "host": self.endpoint.host,
                "port": self.endpoint.port,
                "transport": self.endpoint.transport,
            }
        if self.parameters:
            out["parameters"] = self.parameters
        if self.methods:
            out["methods"] = self.methods
        if self.model_uri:
            out["modelUri"] = self.model_uri
        if self.image:
            out["image"] = self.image
        if self.remote:
            out["remote"] = True
        if self.children:
            out["children"] = [c.to_dict() for c in self.children]
        if self.fallback is not None:
            out["fallback"] = self.fallback.to_dict()
        return out


def validate_graph(root: UnitSpec) -> None:
    """Structural validation (reference: seldondeployment_webhook.go:358-446).

    * node names unique (fallback subtrees included — `walk` yields them)
    * COMBINER needs >= 1 child; ROUTER needs >= 1 child
    * every node must be executable: a component, component_class,
      endpoint, or builtin implementation (or be a no-method pass-through)
    * a fallback must be able to stand in for its primary: its subtree
      obeys the same rules, and a fallback node may not declare its own
      fallback (one degradation step: a chain would hide how degraded an
      answer is)
    """
    seen = set()
    for unit in root.walk():
        if unit.name in seen:
            raise GraphSpecError(f"duplicate node name {unit.name!r}")
        seen.add(unit.name)
        if unit.type == COMBINER and not unit.children:
            raise GraphSpecError(f"COMBINER {unit.name!r} has no children")
        if unit.type == ROUTER and not unit.children:
            raise GraphSpecError(f"ROUTER {unit.name!r} has no children")
        if unit.fallback is not None and unit.fallback.fallback is not None:
            raise GraphSpecError(
                f"fallback {unit.fallback.name!r} of {unit.name!r} declares "
                "its own fallback: only one degradation step is allowed"
            )
        executable = (
            unit.component is not None
            or unit.component_class
            or unit.endpoint is not None
            or unit.implementation
        )
        if unit.node_methods() and not executable:
            raise GraphSpecError(
                f"node {unit.name!r} ({unit.type}) has no component/endpoint/implementation"
            )
