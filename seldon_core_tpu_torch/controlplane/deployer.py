"""Deployer — the reconciler that materialises deployments.

Equivalent of the reference operator's reconcile loop
(reference: seldondeployment_controller.go:268-494 createComponents,
:1156-1211 Reconcile), re-imagined for a host with CUDA cards: instead
of creating k8s Deployments/Services it

1. runs the spec through defaulting + validation (the webhook stage),
2. plans device placement,
3. builds each predictor's graph executor in-process,
4. wires a ``Gateway`` with the spec's traffic weights + shadows,
5. on re-apply, performs a **rolling swap**: the new generation is
   built and readiness-checked while the old one still serves, then
   traffic cuts over atomically and the old generation drains
   (the reference gets this from k8s rolling updates, tested with
   fixed models — reference: testing/scripts/test_rolling_updates.py).

``serve_deployment()`` exposes the deployment on HTTP/gRPC ports;
``seldon-tpu-torch-deploy run spec.yaml`` (``python -m
seldon_core_tpu_torch.controlplane.deployer run spec.yaml``) is the
operator daemon.

**Device exclusivity (C27).**  An hpa predictor runs its graph root as N
subprocess replicas.  Several processes can share one CUDA card, each
with its own CUDA context (~0.5 GB on an H100), its own copy of the
weights and its own cuDNN workspace, so a ``CUDA_SERVER`` root
replicates on one card: ResNet-50 in bf16 costs a replica its context,
51 MB of weights and its activations at ``max_batch_size``.  The guard
(:func:`_reject_device_exclusive_root`) refuses hpa replicas only of a
class that sets ``device_exclusive``.  In the port only ``GenerativeLM``
(``models/generate.py``) sets it, as its JAX counterpart does.  Its
memory is not bounded by a pool: each call allocates a fresh decode
cache of batch x layers x max_len rows, so what a process takes from the
card follows its traffic, and replicas of it on one card would compete
for memory that nothing accounts.  That is a policy, not a measured
failure: two ``GenerativeLM`` processes on one card have not been shown
to run out of memory.  ``StreamingLM`` and ``DisaggregatedLM`` size
their page pools from ``max_slots`` (or ``num_pages``) once, at load, so
they replicate like ``CUDA_SERVER``.  ``max_replicas: 1`` (supervised
restart only) is always admitted.

**No quiet fallback.**  ``seldon.io/frontend: native`` serves through
the C++ ingress or raises; TLS or OAuth annotations still select the
Python front end with a warning, as the annotations' precedence.
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from seldon_core_tpu_torch.controlplane.defaulting import default_and_validate
from seldon_core_tpu_torch.controlplane.placement import PlacementPlan, plan_placement
from seldon_core_tpu_torch.controlplane.spec import DeploymentSpecError, TpuDeployment
from seldon_core_tpu_torch.engine.server import Gateway
from seldon_core_tpu_torch.engine.service import PredictorService

logger = logging.getLogger(__name__)


@dataclass
class Generation:
    """One materialised version of a deployment."""

    spec: TpuDeployment
    gateway: Gateway
    plan: PlacementPlan
    created_at: float = field(default_factory=time.time)
    generation: int = 0
    # hpa predictors: autoscaler loops + their replica sets, stopped
    # when the generation is drained/deleted
    autoscalers: List[Any] = field(default_factory=list)
    replicasets: List[Any] = field(default_factory=list)
    # supervisor for `remote: true` graph nodes (DCN-edge workers)
    supervisor: Optional[Any] = None
    # set once the generation is drained, closed and unloaded (a rolling
    # re-apply drains the old one in the background)
    drained: threading.Event = field(default_factory=threading.Event)

    def stop_loops(self) -> None:
        """Stop the autoscaler reconcile loops only — call before a
        drain so nothing respawns replicas, while the replica/worker
        processes keep serving the in-flight requests being drained."""
        for asc in self.autoscalers:
            asc.stop()

    def stop_processes(self) -> None:
        """Tear down replica and DCN-worker processes — after drain."""
        for rs in self.replicasets:
            rs.stop_all()
        if self.supervisor is not None:
            self.supervisor.stop_all()

    def stop_scaling(self) -> None:
        self.stop_loops()
        self.stop_processes()

    def unload_components(self) -> None:
        """Unload every in-process component this generation built — after
        drain: a drained ``CudaServer`` joins its batcher threads and
        returns its card memory, a generation component stops its engine
        loop.  A component object the spec carries (``unit.component``)
        is shared with every later generation (``UnitSpec.clone``), so it
        is left loaded."""
        for svc in [*self.gateway.predictors, *self.gateway.shadows]:
            for unit in svc.graph.walk():
                if unit.component is not None:
                    continue
                component = svc.executor.component(unit.name)
                unload = getattr(component, "unload", None) or getattr(component, "shutdown", None)
                if callable(unload):
                    try:
                        unload()
                    except Exception:  # noqa: BLE001 — the rest still unload
                        logger.exception("unloading %s/%s failed", svc.name, unit.name)


class WorkerView:
    """The out-of-process workers of one generation — the ``remote: true``
    nodes' supervisor and the hpa replica sets — as one ``processes``
    mapping with a Supervisor's ``health()``: the gateway's
    ``/debug/workers`` and ``/debug/fleet`` read it."""

    def __init__(self, supervisor: Optional[Any], replicasets: List[Any]):
        self.supervisor = supervisor
        self.replicasets = replicasets

    @property
    def processes(self) -> Dict[str, Any]:
        out: Dict[str, Any] = dict(self.supervisor.processes) if self.supervisor is not None else {}
        for rs in self.replicasets:
            out.update(rs.processes)
        return out

    def health(self) -> Dict[str, Dict]:
        from seldon_core_tpu_torch.controlplane.supervisor import worker_health

        return worker_health(self.processes)


class ManagedDeployment:
    """Holds the live generation; the serving layer reads through this
    indirection so a rolling swap is one attribute store."""

    def __init__(self, name: str):
        self.name = name
        self.current: Optional[Generation] = None
        self._lock = asyncio.Lock()

    @property
    def gateway(self) -> Gateway:
        if self.current is None:
            raise RuntimeError(f"deployment {self.name!r} has no live generation")
        return self.current.gateway


def build_generation(spec: TpuDeployment, device_ids: Optional[List[int]] = None) -> Generation:
    """Webhook + placement + executor construction for one spec."""
    import dataclasses

    # per-generation copy: defaulting and remote-worker endpoint fills
    # must not leak into the caller's spec object (rolling re-apply)
    spec = dataclasses.replace(
        spec,
        predictors=[dataclasses.replace(p, graph=p.graph.clone()) for p in spec.predictors],
        status={},
    )
    spec = default_and_validate(spec)
    plan = plan_placement(spec, device_ids=device_ids)
    weighted: List[Tuple[PredictorService, float]] = []
    shadows: List[PredictorService] = []
    autoscalers: List[Any] = []
    replicasets: List[Any] = []
    supervisor = None
    try:
        supervisor = _spawn_remote_workers(spec)
        for p in spec.predictors:
            from seldon_core_tpu_torch.utils.metrics import PrometheusObserver

            observer = PrometheusObserver(deployment_name=spec.name, predictor_name=p.name)
            clients = None
            scaled = None
            if p.hpa:
                scaled = _build_autoscaled_root(p, spec.annotations)
                clients = {p.graph.name: scaled[0]}
            svc = PredictorService(
                p.graph, name=p.name, observer=observer, annotations=spec.annotations,
                clients=clients,
                request_logger=_request_logger_from_annotations(spec.annotations),
            )
            if scaled is not None:
                balanced, rs, make_autoscaler = scaled
                # register the replica set before start(): a partial
                # spawn failure must reach the cleanup handler below
                replicasets.append(rs)
                asc = make_autoscaler(svc, observer)
                asc.start()  # spawns min_replicas synchronously, then loops
                autoscalers.append(asc)
            if p.explainer:
                _attach_explainer(svc, p.explainer)
            if p.shadow:
                shadows.append(svc)
            else:
                weighted.append((svc, p.traffic))
    except BaseException:
        # a later predictor failing must not leak earlier predictors'
        # autoscaler threads / replica or worker subprocesses
        for asc in autoscalers:
            asc.stop()
        for rs in replicasets:
            rs.stop_all()
        if supervisor is not None:
            supervisor.stop_all()
        raise
    workers = WorkerView(supervisor, replicasets) if supervisor is not None or replicasets else None
    return Generation(
        spec=spec,
        gateway=Gateway(
            weighted, shadows=shadows, supervisor=workers,
            request_logger=_gateway_logger_from_annotations(spec.annotations),
        ),
        plan=plan,
        autoscalers=autoscalers,
        replicasets=replicasets,
        supervisor=supervisor,
    )


def _request_logger_from_annotations(annotations):
    """Pair-logging sink from deployment annotations (the reference
    wires its engine to the logging service via
    ``message.logging.service``, PredictionService.java:169-202):

    * ``seldon.io/request-log-url``   — CloudEvents POSTs to a
      collector (e.g. ``seldon-tpu-reqlog serve``)
    * ``seldon.io/request-log-jsonl`` — append to a local JSONL file
      (ingestable by ``seldon-tpu-reqlog ingest``)
    * ``seldon.io/request-log-kafka`` — ``brokers/topic`` streamed via
      KafkaPairLogger (reference: the kafka/ integration manifests)
    """
    url = str(annotations.get("seldon.io/request-log-url", "") or "")
    path = str(annotations.get("seldon.io/request-log-jsonl", "") or "")
    kafka = str(annotations.get("seldon.io/request-log-kafka", "") or "")
    if url:
        from seldon_core_tpu_torch.utils.reqlogger import HttpPairLogger

        return HttpPairLogger(url)
    if path:
        from seldon_core_tpu_torch.utils.reqlogger import JsonlPairLogger

        return JsonlPairLogger(path)
    if kafka:
        from seldon_core_tpu_torch.utils.reqlogger import KafkaPairLogger

        brokers, _, topic = kafka.rpartition("/")
        if not brokers or not topic:
            raise DeploymentSpecError(
                "seldon.io/request-log-kafka must be 'brokers/topic', "
                f"got {kafka!r}")
        return KafkaPairLogger(bootstrap_servers=brokers, topic=topic)
    return None


def _gateway_logger_from_annotations(annotations):
    """Gateway-level pair sink: ``seldon.io/request-logger``
    names ONE sink that sees every finalized request/response pair
    (puid + traceparent + cost stamped) regardless of which predictor
    served it — the per-predictor annotations above keep logging graph
    traffic.  Sink spelling by spec shape:

    * ``http(s)://...``   — HttpPairLogger (CloudEvents POSTs)
    * ``kafka:brokers/topic`` — KafkaPairLogger
    * anything else       — a local JSONL file path
    """
    spec = str(annotations.get("seldon.io/request-logger", "") or "")
    if not spec:
        return None
    if spec.startswith(("http://", "https://")):
        from seldon_core_tpu_torch.utils.reqlogger import HttpPairLogger

        return HttpPairLogger(spec)
    if spec.startswith("kafka:"):
        from seldon_core_tpu_torch.utils.reqlogger import KafkaPairLogger

        brokers, _, topic = spec[len("kafka:"):].rpartition("/")
        if not brokers or not topic:
            raise DeploymentSpecError(
                "seldon.io/request-logger kafka spec must be "
                f"'kafka:brokers/topic', got {spec!r}")
        return KafkaPairLogger(bootstrap_servers=brokers, topic=topic)
    from seldon_core_tpu_torch.utils.reqlogger import JsonlPairLogger

    return JsonlPairLogger(spec)


def _spawn_remote_workers(spec: TpuDeployment):
    """Spawn a supervised microservice worker for every ``remote: true``
    graph node and fill in its endpoint — process placement emitting
    DCN edges (the reference analogue: the operator creating one
    Deployment+Service per graph container and stitching the engine to
    them over the pod network, seldondeployment_controller.go:268-494).

    Returns the Supervisor owning the workers, or None if the spec has
    no remote nodes.
    """
    import json

    from seldon_core_tpu_torch.controlplane.autoscaler import _free_port as free_port
    from seldon_core_tpu_torch.controlplane.supervisor import ProcessSpec, Supervisor
    from seldon_core_tpu_torch.engine.graph import GRPC, Endpoint
    from seldon_core_tpu_torch.engine.units import implementation_path

    remote_units = [
        (p, unit)
        for p in spec.predictors
        for unit in p.graph.walk()
        if unit.remote and unit.endpoint is None
    ]
    if not remote_units:
        return None

    ready_s = _worker_ready_s(spec.annotations, 30.0)
    supervisor = Supervisor()
    try:
        for p, unit in remote_units:
            if unit.component_class:
                component = unit.component_class
            elif unit.implementation:
                component = implementation_path(unit.implementation)
            else:
                raise DeploymentSpecError(
                    f"remote node {unit.name!r} has no implementation/"
                    "component_class to run out-of-process"
                )
            grpc_port = free_port()
            supervisor.add(
                ProcessSpec(
                    name=f"{spec.name}-{p.name}-{unit.name}",
                    component=component,
                    http_port=free_port(),
                    grpc_port=grpc_port,
                    parameters_json=json.dumps(unit.parameters or []),
                    api="BOTH",
                    # TLS terminates at the external gateway; internal DCN
                    # edges dial plaintext (the reference's in-cluster
                    # model), so workers must not inherit SELDON_TLS_*
                    env={"SELDON_TLS_CERT": "", "SELDON_TLS_KEY": "", "SELDON_TLS_CA": ""},
                ),
                wait_ready_s=ready_s,
            )
            unit.endpoint = Endpoint(host="127.0.0.1", port=grpc_port, transport=GRPC)
    except BaseException:
        supervisor.stop_all()
        raise
    return supervisor


def _worker_ready_s(annotations, default: float) -> float:
    """``seldon.io/worker-ready-timeout-s``: how long a supervised worker
    (a ``remote: true`` node, or an hpa replica in the port) may take to
    come ready.  Worker boot covers interpreter + framework import +
    model load + warmup, which can exceed the default on a busy host —
    the annotation mirrors the reference's readiness-gate tunables
    (initialDelaySeconds on the engine pod)."""
    raw = annotations.get("seldon.io/worker-ready-timeout-s")
    try:
        ready_s = float(raw if raw is not None else default)
    except (TypeError, ValueError):
        ready_s = float("nan")
    if not ready_s > 0:  # catches 0 (skips the gate), negatives, NaN
        raise DeploymentSpecError(
            f"seldon.io/worker-ready-timeout-s must be a positive number, got {raw!r}")
    return ready_s


def _reject_device_exclusive_root(predictor: str, component: str, hpa) -> None:
    """Device-exclusivity guard for hpa replica scaling (C27, the module
    docstring).

    Several processes can share one CUDA card, so only a class that sets
    ``device_exclusive`` (its memory is not bounded by a pool) is refused
    subprocess replicas; a pinned ``max_replicas=1`` (supervised restart
    only — exactly one process ever holds the card's memory) is fine.  An
    unimportable component class is the subprocess's problem, not this
    guard's — skip silently.
    """
    import importlib

    if getattr(hpa, "max_replicas", 2) <= 1:
        return
    module, _, cls = component.rpartition(".")
    try:
        klass = getattr(importlib.import_module(module), cls)
    except Exception:  # noqa: BLE001 — unimportable component: the
        # device-exclusivity probe is advisory; load reports the real error
        return
    if getattr(klass, "device_exclusive", False):
        raise DeploymentSpecError(
            f"predictor {predictor!r}: hpa subprocess replicas are not "
            f"possible for device-exclusive component {component!r} "
            "(it declares device_exclusive: its card memory is not bounded "
            "by a pool, e.g. a decode cache allocated per call, so one "
            "process of it holds a card; C27). Scale in-process "
            "instead: raise max_batch_size / batcher concurrency, or set "
            "max_replicas: 1."
        )


def _build_autoscaled_root(p, annotations) -> Tuple[Any, Any, Any]:
    """ReplicaSet + BalancedClient wiring for an hpa predictor.

    The graph root runs as supervised out-of-process replicas behind a
    BalancedClient (children still execute in this process's executor);
    the returned factory builds the Autoscaler once the PredictorService
    exists, sampling that predictor's own request counter as QPS — the
    in-framework equivalent of the reference's HPA-on-pod-metrics
    (reference: seldondeployment_controller.go:92-114).
    """
    import json

    from seldon_core_tpu_torch.controlplane.autoscaler import (
        Autoscaler,
        CounterRateSampler,
        HpaSpec,
        ReplicaSet,
    )
    from seldon_core_tpu_torch.controlplane.supervisor import ProcessSpec
    from seldon_core_tpu_torch.engine.executor import build_client
    from seldon_core_tpu_torch.engine.graph import GRPC, Endpoint, UnitSpec
    from seldon_core_tpu_torch.engine.transport import BalancedClient
    from seldon_core_tpu_torch.engine.units import implementation_path

    unit = p.graph
    if unit.component_class:
        component = unit.component_class
    elif unit.implementation:
        component = implementation_path(unit.implementation)
    else:
        raise DeploymentSpecError(
            f"predictor {p.name!r} has hpa but its graph root has no "
            "implementation/component_class to run out-of-process"
        )
    try:
        hpa = HpaSpec.from_dict(p.hpa)
    except (ValueError, TypeError) as e:
        raise DeploymentSpecError(f"predictor {p.name!r} hpa block invalid: {e}")

    _reject_device_exclusive_root(p.name, component, hpa)

    balanced = BalancedClient()
    by_port: Dict[int, Any] = {}  # replica gRPC port -> its client

    def on_change(specs):
        # a surviving replica keeps its client: a new one would retire
        # (and close) the old channel under the calls in flight on it
        clients = []
        for s in specs:
            client = by_port.get(s.grpc_port)
            if client is None:
                remote = UnitSpec(
                    name=unit.name,
                    type=unit.type,
                    endpoint=Endpoint(host="127.0.0.1", port=s.grpc_port, transport=GRPC),
                )
                client = by_port[s.grpc_port] = build_client(remote, annotations)
            clients.append(client)
        for port in set(by_port) - {s.grpc_port for s in specs}:
            del by_port[port]
        balanced.set_clients(clients)

    rs = ReplicaSet(
        ProcessSpec(
            name=f"{p.name}-{unit.name}",
            component=component,
            http_port=0,  # ReplicaSet assigns fresh ports per replica
            grpc_port=0,
            parameters_json=json.dumps(unit.parameters or []),
            api="BOTH",
        ),
        wait_ready_s=_worker_ready_s(annotations, 60.0),
        on_change=on_change,
    )

    def make_autoscaler(svc: PredictorService, observer=None) -> Autoscaler:
        # one sampler per active target; the Autoscaler applies the max
        # of the per-metric proposals (k8s autoscaling/v2 semantics), so
        # a spec may hold e.g. a QPS floor AND a p95 ceiling at once
        metric_fns = {}
        for name, _target, _pr in hpa.metric_specs():
            if name == "qps":
                metric_fns[name] = CounterRateSampler(lambda: svc.stats.get("requests", 0))
            elif name == "inflight":
                metric_fns[name] = lambda: float(getattr(svc, "_inflight", 0))
            elif name == "p95_ms":
                if observer is None:
                    # silently swapping in the QPS counter would compare
                    # requests/sec against a milliseconds target
                    raise DeploymentSpecError(
                        f"predictor {p.name!r}: target_p95_ms needs the "
                        "predictor's PrometheusObserver"
                    )
                from seldon_core_tpu_torch.utils.metrics import api_latency_sampler

                p95 = api_latency_sampler(observer, quantile=0.95)
                metric_fns[name] = lambda p95=p95: p95() * 1000.0  # s -> ms
            else:
                raise DeploymentSpecError(
                    f"predictor {p.name!r}: custom_targets metric {name!r} "
                    "has no declarative sampler; construct the Autoscaler "
                    "programmatically with a metric_fn dict"
                )
        return Autoscaler(rs, hpa, metric_fn=metric_fns)

    return balanced, rs, make_autoscaler


def _attach_explainer(svc: PredictorService, config: Dict[str, Any]) -> None:
    """Build the predictor's explainer and point it at the first local
    MODEL component in the graph (reference analogue: a separate
    explainer Deployment per predictor,
    reference: seldondeployment_explainers.go:33-196 — here it shares
    the predictor's process and the weights on its card)."""
    from seldon_core_tpu_torch.components.explainers import build_explainer
    from seldon_core_tpu_torch.engine.graph import MODEL

    explainer = build_explainer(config)
    for unit in svc.graph.walk():
        if unit.type == MODEL:
            component = svc.executor.component(unit.name)
            if component is not None:
                explainer.attach(component)
                svc.explainer = explainer
                return
    raise DeploymentSpecError(
        f"predictor {svc.name!r} has an explainer but no local MODEL component"
    )


class Deployer:
    """Owns all deployments on this host."""

    def __init__(self, device_ids: Optional[List[int]] = None):
        self.deployments: Dict[str, ManagedDeployment] = {}
        self.device_ids = device_ids
        self._drains: set = set()  # background drains of replaced generations

    def _drain_done(self, task: "asyncio.Task") -> None:
        self._drains.discard(task)
        if not task.cancelled() and task.exception() is not None:
            logger.error("draining a replaced generation failed", exc_info=task.exception())

    async def apply(self, spec: TpuDeployment, ready_timeout_s: float = 60.0) -> ManagedDeployment:
        """Create or rolling-update a deployment."""
        managed = self.deployments.get(spec.name)
        fresh = managed is None
        if fresh:
            managed = ManagedDeployment(spec.name)

        # off the event loop: model loads and hpa replica spawns
        # (ReplicaSet.wait_ready) can block for tens of seconds
        new_gen = await asyncio.to_thread(build_generation, spec, self.device_ids)
        new_gen.generation = (managed.current.generation + 1) if managed.current else 1

        # readiness gate before any traffic shifts (reference: engine
        # /ready walks the whole graph before the pod joins the Service)
        deadline = time.monotonic() + ready_timeout_s
        while not await new_gen.gateway.ready():
            if time.monotonic() > deadline:
                await new_gen.gateway.close()
                await asyncio.to_thread(new_gen.stop_scaling)
                raise TimeoutError(f"new generation of {spec.name!r} never became ready")
            await asyncio.sleep(0.1)

        async with managed._lock:
            old = managed.current
            managed.current = new_gen  # atomic cutover
        if old is not None:
            # drain the old generation in the background
            async def _drain(gen: Generation):
                await asyncio.to_thread(gen.stop_loops)
                for svc in gen.gateway.predictors:
                    await svc.drain(timeout_s=20.0)
                await gen.gateway.close()
                await asyncio.to_thread(gen.stop_processes)
                await asyncio.to_thread(gen.unload_components)
                gen.drained.set()

            task = asyncio.ensure_future(_drain(old))
            self._drains.add(task)  # the loop holds tasks weakly
            task.add_done_callback(self._drain_done)
        self.deployments[spec.name] = managed
        logger.info(
            "deployment %s generation %d live (%d predictors)",
            spec.name,
            new_gen.generation,
            len(spec.predictors),
        )
        return managed

    async def delete(self, name: str) -> bool:
        managed = self.deployments.pop(name, None)
        if managed is None or managed.current is None:
            return False
        managed.current.gateway.pause()
        # loops first (nothing respawns), processes only after the drain
        # — killing workers before drain would fail every in-flight call
        await asyncio.to_thread(managed.current.stop_loops)
        for svc in managed.current.gateway.predictors:
            await svc.drain(timeout_s=20.0)
        await managed.current.gateway.close()
        await asyncio.to_thread(managed.current.stop_processes)
        await asyncio.to_thread(managed.current.unload_components)
        managed.current.drained.set()
        managed.current = None
        return True

    async def status(self, name: str) -> Dict[str, Any]:
        """Deployment status (the CR status the reference writes back,
        reference: seldondeployment_controller.go:1200-1208)."""
        managed = self.deployments.get(name)
        if managed is None or managed.current is None:
            return {"name": name, "state": "Absent"}
        gen = managed.current
        ready = await gen.gateway.ready()
        return {
            "name": name,
            "state": "Available" if ready else "Creating",
            "generation": gen.generation,
            "rewrites": list(gen.spec.status.get("rewrites", [])),
            "predictors": {
                svc.name: {
                    "ready": await svc.ready(),
                    "stats": dict(svc.stats),
                    "devices": (
                        gen.plan.for_predictor(svc.name).device_ids
                        if gen.plan.for_predictor(svc.name)
                        else []
                    ),
                }
                for svc in gen.gateway.predictors
            },
        }


async def serve_deployment(
    deployer: Deployer,
    name: str,
    host: str = "0.0.0.0",
    http_port: Optional[int] = None,
    grpc_port: Optional[int] = None,
    frontend: Optional[str] = None,  # "python" | "native" | None -> annotation
):
    """Expose a managed deployment on its spec ports.

    The HTTP app and gRPC service resolve the gateway through the
    ManagedDeployment on every request, so rolling swaps take effect
    without socket churn.

    ``frontend="native"`` (or annotation ``seldon.io/frontend: native``)
    puts the C++ front server on the HTTP port: single-local-MODEL
    predictors get the zero-Python fast lane, everything else bridges
    into the engine with full semantics.  When the native library is
    unavailable this raises: the port has no quiet fallback to the
    Python app.
    """
    from seldon_core_tpu_torch.engine import server as engine_server

    managed = deployer.deployments[name]
    spec = managed.current.spec
    http_port = http_port if http_port is not None else spec.http_port
    grpc_port = grpc_port if grpc_port is not None else spec.grpc_port
    if frontend is None:
        frontend = str(spec.annotations.get("seldon.io/frontend", "python")).lower()

    # external TLS termination: annotations win, SELDON_TLS_* env is the
    # operator-injected fallback (reference: cert secrets mounted into
    # the engine pod).  Internal graph edges stay plaintext.
    from seldon_core_tpu_torch.utils.tls import TlsConfig

    tls = None
    cert = spec.annotations.get("seldon.io/tls-cert", "")
    if cert or spec.annotations.get("seldon.io/tls-key"):
        tls = TlsConfig(
            cert_file=cert,
            key_file=spec.annotations.get("seldon.io/tls-key", ""),
            ca_file=spec.annotations.get("seldon.io/tls-ca", ""),
            require_client_auth=spec.annotations.get("seldon.io/tls-require-client-auth") == "1",
        )
    else:
        tls = TlsConfig.from_env()

    # gateway OAuth (the reference's legacy API-gateway token flow):
    # annotations carry the client-credentials pair
    auth = None
    oauth_key = spec.annotations.get("seldon.io/oauth-key", "")
    if oauth_key or spec.annotations.get("seldon.io/oauth-secret"):
        from seldon_core_tpu_torch.utils.auth import OAuthConfig

        auth = OAuthConfig(
            key=oauth_key,
            secret=spec.annotations.get("seldon.io/oauth-secret", ""),
            ttl_s=float(spec.annotations.get("seldon.io/oauth-token-ttl-s", "3600")),
        )
    if auth is not None and frontend == "native":
        logger.warning(
            "oauth requested: using python frontend (native ingress has no token lane)"
        )
        frontend = "python"

    if tls is not None and frontend == "native":
        # the C++ ingress does not terminate TLS; honouring the TLS
        # request matters more than the native fast lane
        logger.warning("TLS requested: using python frontend (native ingress is plaintext)")
        frontend = "python"

    class _GatewayProxy:
        """Delegates to the live generation's gateway."""

        def __getattr__(self, attr):
            return getattr(managed.gateway, attr)

    proxy = _GatewayProxy()
    if frontend == "native":
        from seldon_core_tpu_torch.engine.native_ingress import serve_native_ingress

        http_handle = None
        try:
            # raises when the native library cannot be built or loaded:
            # the port never serves a native spec on the Python app
            http_handle = await serve_native_ingress(proxy, host=host, http_port=http_port)
            from seldon_core_tpu_torch.engine.sync_server import build_sync_seldon_server

            grpc_srv = build_sync_seldon_server(proxy, asyncio.get_running_loop())
            grpc_srv.add_insecure_port(f"{host}:{grpc_port}")
            grpc_srv.start()
        except BaseException:
            if http_handle is not None:
                await http_handle.stop()
            raise
        logger.info("deployment %s serving http=:%d (native) grpc=:%d", name, http_port, grpc_port)
        return http_handle, engine_server.GrpcServerHandle(grpc_srv, is_aio=False)
    if frontend != "python":
        raise DeploymentSpecError(f"seldon.io/frontend must be 'python' or 'native', got {frontend!r}")

    runner, grpc_srv = await engine_server.serve_gateway(
        proxy, host=host, http_port=http_port, grpc_port=grpc_port, tls=tls,
        auth=auth,
    )
    logger.info(
        "deployment %s serving http=:%d grpc=:%d%s%s",
        name, http_port, grpc_port,
        " (TLS)" if tls is not None else "",
        " (oauth)" if auth is not None else "",
    )
    return runner, grpc_srv


def main(argv: Optional[List[str]] = None) -> None:
    """CLI: seldon-tpu-torch-deploy run spec.yaml [--http-port N --grpc-port N --device-ids 0,1]"""
    import argparse

    parser = argparse.ArgumentParser(prog="seldon-tpu-torch-deploy",
                                     description="seldon-core-tpu deployer (PyTorch port)")
    parser.add_argument("command", choices=["run", "validate"])
    parser.add_argument("spec", help="deployment spec yaml/json path")
    parser.add_argument("--http-port", type=int, default=None)
    parser.add_argument("--grpc-port", type=int, default=None)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--device-ids", default=None,
                        help="comma-separated CUDA device ids to place on (default: every card of the host)")
    args = parser.parse_args(argv)
    device_ids = [int(i) for i in args.device_ids.split(",")] if args.device_ids else None

    logging.basicConfig(level="INFO")
    spec = TpuDeployment.load(args.spec)

    if args.command == "validate":
        default_and_validate(spec)
        print(f"deployment {spec.name!r} is valid")
        return

    async def _run():
        import signal

        deployer = Deployer(device_ids=device_ids)
        await deployer.apply(spec)
        # the handles MUST stay referenced: a garbage-collected sync
        # grpc.Server stops itself, silently dropping the gRPC listener
        handles = await serve_deployment(
            deployer, spec.name, host=args.host, http_port=args.http_port, grpc_port=args.grpc_port
        )
        # SIGTERM/SIGINT must tear the deployment down — supervised
        # worker/replica processes are not children that die with us
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(sig, stop.set)
        await stop.wait()
        logger.info("shutting down deployment %s", spec.name)
        await deployer.delete(spec.name)
        del handles  # keeps the servers alive until shutdown

    asyncio.run(_run())


if __name__ == "__main__":
    main()
