"""The graph executor — per-request orchestration of an inference graph.

Replicates the reference engine's execution algebra
(reference: PredictiveUnitBean.java:106-199 getOutputAsync):

1. record this node in ``requestPath``
2. ``transform_input`` (a MODEL's predict) -> merge meta (puid kept,
   tags latest-wins, per-node metrics collected then cleared from the
   message — reference: PredictiveUnitBean.java:370-388 mergeMeta)
3. leaf -> transformed input is the output
4. ``route``: ROUTER picks one branch, -1/no router means all children
   (reference: PredictiveUnitBean.java:151-169); branch recorded in
   ``routing``
5. children execute concurrently (asyncio fan-out)
6. ``aggregate``: COMBINER merges, default takes the single child output
7. ``transform_output`` -> merge meta
8. at the top: routing map, request path, and all collected node metrics
   are folded into the response meta
   (reference: PredictiveUnitBean.java:72-93 getOutput)

Feedback walks the same tree following the recorded routing map
(reference: PredictiveUnitBean.java:206-246).

Every node method call is a ``node.<unit>.<method>`` span and a
``node_call`` event to the ``observer`` hook (``utils/metrics.py``
``PrometheusObserver``: the reference's engine -> node histograms);
collected node metrics and feedback rewards are observer events too.

A node with a ``fallback`` subtree degrades instead of failing: when its
breaker is open or its retries are spent transiently (502 / 503), the
fallback answers, tagged ``degraded`` / ``fallback_for`` in meta, and a
``node_fallback`` event and ``seldon_tpu_graph_fallbacks_total`` count
it.  A spent deadline and a deterministic error are never absorbed.
"""

from __future__ import annotations

import asyncio
import importlib
import logging
import time
from typing import Any, Awaitable, Callable, Dict, List, Optional

import numpy as np

from seldon_core_tpu_torch.engine import units as builtin_units
from seldon_core_tpu_torch.engine.graph import (
    AGGREGATE,
    REST,
    ROUTE,
    SEND_FEEDBACK,
    TRANSFORM_INPUT,
    TRANSFORM_OUTPUT,
    UnitSpec,
    validate_graph,
)
from seldon_core_tpu_torch.engine.transport import (
    CircuitBreaker,
    GrpcClient,
    LocalClient,
    NodeClient,
    RestClient,
    breakers_enabled,
)
from seldon_core_tpu_torch.runtime.component import MicroserviceError
from seldon_core_tpu_torch.runtime.message import InternalFeedback, InternalMessage
from seldon_core_tpu_torch.runtime.params import parse_parameters
from seldon_core_tpu_torch.utils.metrics import increment_counter
from seldon_core_tpu_torch.utils.tracing import maybe_span

logger = logging.getLogger(__name__)

# observers: (event, unit_name, payload) -> None; used by metrics
Observer = Callable[[str, str, Any], None]

def _instantiate_component(unit: UnitSpec) -> Any:
    """Materialise the in-process component for a unit, if any."""
    if unit.component is not None:
        return unit.component
    kwargs = parse_parameters(unit.parameters)
    if unit.implementation:
        return builtin_units.make_builtin(unit.implementation, **kwargs)
    if unit.component_class:
        module_name, _, class_name = unit.component_class.rpartition(".")
        module = importlib.import_module(module_name)
        return getattr(module, class_name)(**kwargs)
    return None


def build_client(unit: UnitSpec, annotations: Optional[Dict[str, str]] = None) -> Optional[NodeClient]:
    """Pick the transport for a unit: in-process beats remote.

    `annotations` carries the deployment's cross-cutting knobs; the
    remote transports honour the reference's timeout/retry annotations
    (reference: InternalPredictionService.java:80-98):
    seldon.io/rest-connection-timeout (ms), seldon.io/rest-read-timeout
    (ms), seldon.io/rest-retries, seldon.io/grpc-read-timeout (ms),
    seldon.io/grpc-retries (attempt budget for transient statuses).

    Failure containment: seldon.io/breaker ("0" / "off" / "false" turns
    circuit breaking off for this deployment), seldon.io/breaker-failures
    (consecutive transient failures to trip, default 5),
    seldon.io/breaker-reset-ms (open -> half-open cooldown, default 1000),
    seldon.io/breaker-probes (concurrent half-open probes, default 2),
    and seldon.io/hedge-ms (hedging delay of idempotent unary calls;
    unset / 0 = off).  The breaker is the endpoint's shared one, keyed
    ``host:port`` for the remote lanes and ``local:<unit>`` in-process.
    """
    ann = annotations or {}

    def _ms(key: str, default_s: float) -> float:
        try:
            return float(ann[key]) / 1000.0
        except (KeyError, ValueError):
            return default_s

    def _int(key: str, default: int) -> int:
        try:
            return int(ann[key])
        except (KeyError, ValueError):
            return default

    def _breaker(key: str):
        """The annotation-configured shared breaker of an endpoint, or
        False (off) when annotation or environment disable it."""
        if not breakers_enabled() or str(ann.get("seldon.io/breaker", "1")).lower() in ("0", "off", "false"):
            return False
        return CircuitBreaker.for_endpoint(
            key,
            failures=_int("seldon.io/breaker-failures", 5),
            reset_s=_ms("seldon.io/breaker-reset-ms", 1.0),
            probes=_int("seldon.io/breaker-probes", 2),
        )

    hedge_ms = _ms("seldon.io/hedge-ms", 0.0) * 1000.0

    if not unit.remote:
        # in-process beats remote — unless the node is declared remote,
        # in which case implementation/component_class describe what the
        # worker process runs, not something to instantiate here
        component = _instantiate_component(unit)
        if component is not None:
            if hasattr(component, "load"):
                component.load()
            return LocalClient(unit, component, breaker=_breaker(f"local:{unit.name}"))
    elif unit.endpoint is None:
        raise MicroserviceError(
            f"node {unit.name!r} is remote but has no endpoint — start its microservice and set one "
            "(the control plane that spawns workers is ROADMAP.md §A item 13)",
            status_code=500,
            reason="BAD_GRAPH",
        )
    if unit.endpoint is not None:
        breaker = _breaker(f"{unit.endpoint.host}:{unit.endpoint.port}")
        if unit.endpoint.transport == REST:
            return RestClient(
                unit,
                connect_timeout_s=_ms("seldon.io/rest-connection-timeout", 2.0),
                read_timeout_s=_ms("seldon.io/rest-read-timeout", 5.0),
                retries=_int("seldon.io/rest-retries", 3),
                breaker=breaker,
                hedge_ms=hedge_ms,
            )
        return GrpcClient(
            unit,
            deadline_s=_ms("seldon.io/grpc-read-timeout", 5.0),
            retries=_int("seldon.io/grpc-retries", 3),
            breaker=breaker,
            hedge_ms=hedge_ms,
        )
    return None


class GraphExecutor:
    """Executes one predictor's graph; owns the node clients.

    ``clients`` injects ready-made clients by node name (a
    ``BalancedClient`` over a node's replicas); every other node gets
    ``build_client``'s."""

    def __init__(self, root: UnitSpec, clients: Optional[Dict[str, NodeClient]] = None,
                 observer: Optional[Observer] = None, annotations: Optional[Dict[str, str]] = None):
        validate_graph(root)
        self.root = root
        self.observer = observer
        self.clients: Dict[str, NodeClient] = {}
        for unit in root.walk():
            if clients is not None and unit.name in clients:
                self.clients[unit.name] = clients[unit.name]
                continue
            client = build_client(unit, annotations)
            if client is not None:
                self.clients[unit.name] = client
        # fail fast on unexecutable nodes with methods
        for unit in root.walk():
            if unit.node_methods() and unit.name not in self.clients:
                raise MicroserviceError(
                    f"no client available for node {unit.name!r}", status_code=500, reason="BAD_GRAPH"
                )

    # ------------------------------------------------------------------ util

    def _emit(self, event: str, unit: str, payload: Any = None) -> None:
        if self.observer is not None:
            try:
                self.observer(event, unit, payload)
            except Exception:  # noqa: BLE001 — observers must never break the data plane
                logger.exception("observer failed for %s/%s", event, unit)

    async def _timed(self, unit: UnitSpec, method: str, coro: Awaitable, puid: str):
        """One node method call: a span and a ``node_call`` event (the
        reference's engine -> node client histograms and per-node spans,
        reference: PredictiveUnitBean.java:77-78)."""
        start = time.perf_counter()
        with maybe_span(f"node.{unit.name}.{method}", trace_id=puid, unit_type=unit.type):
            result = await coro
        self._emit("node_call", unit.name, (method, time.perf_counter() - start))
        return result

    def component(self, name: str) -> Optional[Any]:
        """The live in-process component of a node, if local."""
        client = self.clients.get(name)
        return client.component if isinstance(client, LocalClient) else None

    @staticmethod
    def _merge_meta(latest: InternalMessage, previous: List[InternalMessage], puid: str) -> None:
        """Reference mergeMeta: keep puid, union tags with latest-wins,
        clear per-message metrics (they were already collected)."""
        tags: Dict[str, Any] = {}
        for prev in previous:
            tags.update(prev.meta.tags)
        tags.update(latest.meta.tags)
        latest.meta.puid = puid
        latest.meta.tags = tags
        latest.meta.metrics = []

    def _collect_metrics(self, msg: Optional[InternalMessage], unit: UnitSpec,
                         metrics: Dict[str, List[Dict]]) -> None:
        if msg is not None and msg.meta.metrics:
            self._emit("node_metrics", unit.name, msg.meta.metrics)
            metrics.setdefault(unit.name, []).extend(msg.meta.metrics)

    @staticmethod
    def _branch_index(routing_msg: InternalMessage, unit: UnitSpec) -> int:
        try:
            branch = int(np.asarray(routing_msg.host_payload()).ravel()[0])
        except (ValueError, IndexError, TypeError) as e:
            raise MicroserviceError(
                f"router {unit.name!r} returned undecodable routing", status_code=500,
                reason="ENGINE_INVALID_ROUTING",
            ) from e
        if branch < -1 or branch >= len(unit.children):
            raise MicroserviceError(
                f"router {unit.name!r} returned invalid branch {branch} for {len(unit.children)} children",
                status_code=500,
                reason="ENGINE_INVALID_ROUTING",
            )
        return branch

    # --------------------------------------------------------------- predict

    async def predict(self, request: InternalMessage) -> InternalMessage:
        """Execute the full graph for one request."""
        puid = request.meta.puid
        routing: Dict[str, int] = {}
        request_path: Dict[str, str] = {}
        metrics: Dict[str, List[Dict]] = {}
        response = await self._execute(self.root, request, puid, routing, request_path, metrics)
        response.meta.routing.update(routing)
        response.meta.request_path.update(request_path)
        response.meta.metrics = [m for mlist in metrics.values() for m in mlist]
        response.meta.puid = puid
        return response

    @staticmethod
    def _fallback_worthy(e: Exception) -> bool:
        """Failures a fallback route may absorb: the primary's breaker is
        open (CIRCUIT_OPEN), its retries were spent transiently (502), or
        it shed transiently (503).  A deterministic error would fail the
        same way on the fallback, a remote 4xx / plain 500 included (the
        transports re-raise those as 502 with ``transient=False``; absent
        means transient, so a bare component 503 such as SHED still
        degrades).  A spent deadline (504) leaves no budget for a second
        subtree."""
        if not isinstance(e, MicroserviceError):
            return False
        if e.reason == "DEADLINE_EXCEEDED":
            return False
        if e.status_code not in (502, 503):
            return False
        return getattr(e, "transient", True)

    async def _execute(
        self,
        unit: UnitSpec,
        msg: InternalMessage,
        puid: str,
        routing: Dict[str, int],
        request_path: Dict[str, str],
        metrics: Dict[str, List[Dict]],
    ) -> InternalMessage:
        if unit.fallback is None:
            return await self._execute_primary(unit, msg, puid, routing, request_path, metrics)
        try:
            return await self._execute_primary(unit, msg, puid, routing, request_path, metrics)
        except MicroserviceError as e:
            if not self._fallback_worthy(e):
                raise
            logger.warning("node %s failed (%s: %s); taking fallback route %s", unit.name, e.reason, e,
                           unit.fallback.name)
            self._emit("node_fallback", unit.name, e.reason)
            increment_counter("seldon_tpu_graph_fallbacks_total",
                              "requests answered by a fallback route because the "
                              "primary's breaker was open or its retries exhausted")
            out = await self._execute(unit.fallback, msg, puid, routing, request_path, metrics)
            # a degraded answer must be told apart from a primary one
            out.meta.tags["degraded"] = True
            out.meta.tags["fallback_for"] = unit.name
            return out

    async def _execute_primary(
        self,
        unit: UnitSpec,
        msg: InternalMessage,
        puid: str,
        routing: Dict[str, int],
        request_path: Dict[str, str],
        metrics: Dict[str, List[Dict]],
    ) -> InternalMessage:
        client = self.clients.get(unit.name)
        request_path[unit.name] = unit.image or unit.implementation or unit.component_class or "local"

        # 1. input transform (a MODEL's predict)
        if unit.has_method(TRANSFORM_INPUT):
            transformed = await self._timed(unit, "transform_input", client.transform_input(msg), puid)
            self._collect_metrics(transformed, unit, metrics)
            self._merge_meta(transformed, [msg], puid)
        else:
            transformed = msg

        # 2. leaf
        if not unit.children:
            return transformed

        # 3. routing
        if unit.has_method(ROUTE):
            routing_msg = await self._timed(unit, "route", client.route(transformed), puid)
            self._collect_metrics(routing_msg, unit, metrics)
            branch = self._branch_index(routing_msg, unit)
        else:
            branch = -1
        routing[unit.name] = branch
        selected = unit.children if branch == -1 else [unit.children[branch]]

        # 4. concurrent fan-out to children
        child_outputs: List[InternalMessage] = list(
            await asyncio.gather(
                *(self._execute(child, transformed, puid, routing, request_path, metrics) for child in selected)
            )
        )

        # 5. aggregation
        if unit.has_method(AGGREGATE):
            aggregated = await self._timed(unit, "aggregate", client.aggregate(child_outputs), puid)
        else:
            if len(child_outputs) != 1:
                raise MicroserviceError(
                    f"node {unit.name!r} received {len(child_outputs)} child outputs but has no combiner",
                    status_code=500,
                    reason="ENGINE_MISSING_COMBINER",
                )
            aggregated = child_outputs[0]
        self._collect_metrics(aggregated, unit, metrics)
        self._merge_meta(aggregated, child_outputs, puid)

        # 6. output transform
        if unit.has_method(TRANSFORM_OUTPUT):
            out = await self._timed(unit, "transform_output", client.transform_output(aggregated), puid)
            self._collect_metrics(out, unit, metrics)
            self._merge_meta(out, [aggregated], puid)
        else:
            out = aggregated
        return out

    # -------------------------------------------------------------- feedback

    async def send_feedback(self, feedback: InternalFeedback) -> None:
        await self._feedback(self.root, feedback)

    async def _feedback(self, unit: UnitSpec, feedback: InternalFeedback) -> None:
        # follow the routing recorded at predict time
        routing = -1
        if feedback.response is not None:
            routing = feedback.response.meta.routing.get(unit.name, -1)
        if routing == -1:
            children = unit.children
        elif 0 <= routing < len(unit.children):
            children = [unit.children[routing]]
        else:
            children = []

        child_tasks = [asyncio.ensure_future(self._feedback(child, feedback)) for child in children]

        if unit.has_method(SEND_FEEDBACK):
            client = self.clients.get(unit.name)
            if client is not None:
                await client.send_feedback(feedback)

        if child_tasks:
            await asyncio.gather(*child_tasks)
        self._emit("node_feedback", unit.name, feedback.reward)

    # ------------------------------------------------------------- readiness

    async def ready(self) -> bool:
        """Graph readiness: every node answers
        (reference: SeldonGraphReadyChecker.java:20-50)."""
        checks = await asyncio.gather(*(c.ready() for c in self.clients.values()))
        return all(checks)

    async def close(self) -> None:
        await asyncio.gather(*(c.close() for c in self.clients.values()))
