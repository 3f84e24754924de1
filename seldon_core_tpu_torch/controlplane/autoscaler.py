"""Horizontal autoscaling of graph-node replicas.

The reference delegates scaling to a Kubernetes HorizontalPodAutoscaler
built from the SeldonDeployment's ``hpaSpec`` (reference:
operator/controllers/seldondeployment_controller.go:92-114 creates the
HPA; 894-930 reconciles it).  Here the same control loop runs in the
framework itself, scaling supervisor-managed microservice processes:

* ``ReplicaSet`` — N identical microservice processes for one node,
  each on fresh ports, fronted by a ``BalancedClient`` (the k8s
  Deployment + Service pair).
* ``Autoscaler`` — the HPA algorithm: ``desired = ceil(metric /
  target)`` clamped to [min, max], a 10% tolerance dead-band, immediate
  scale-up, and scale-down stabilization (apply the *max* desired seen
  over the stabilization window — k8s's behaviour, so a brief dip never
  drains warm replicas whose kernels are built and whose cuDNN plans are
  chosen; a replica restart pays its CUDA context, its weight load and
  its warm-up, making flap-damping matter more than it does for the
  reference's CPU pods).
* ``CounterRateSampler`` — turns any cumulative counter (e.g. a
  predictor service's ``stats["requests"]``) into a QPS metric.

Metrics are pulled via a plain callable, so the loop scales on anything:
gateway QPS, batcher queue depth, p95 latency from PrometheusObserver.
"""

from __future__ import annotations

import logging
import math
import socket
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple, Union

from seldon_core_tpu_torch.controlplane.supervisor import ProcessSpec, SupervisedProcess

logger = logging.getLogger(__name__)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@dataclass
class HpaSpec:
    """HPA-like scaling policy (reference: hpaSpec on the predictor,
    proto/seldon_deployment.proto and k8s autoscaling/v2 semantics)."""

    min_replicas: int = 1
    max_replicas: int = 4
    # any subset (at least one) of the targets may be set; each active
    # target yields its own replica proposal and the applied count is
    # the MAX of the proposals — k8s autoscaling/v2 multi-metric
    # semantics.  qps/inflight are totals shared across replicas (the
    # per-replica load falls as replicas rise); latency is a direct
    # signal (p95 ms vs target)
    target_qps_per_replica: float = 0.0
    target_inflight_per_replica: float = 0.0
    target_p95_ms: float = 0.0
    # named custom metrics with per-replica targets (k8s Pods-type
    # custom metrics); the Autoscaler needs a matching metric_fns entry
    custom_targets: Dict[str, float] = field(default_factory=dict)
    tolerance: float = 0.1  # k8s horizontal-pod-autoscaler-tolerance
    scale_down_stabilization_s: float = 60.0
    poll_interval_s: float = 2.0

    # reserved names for the builtin targets
    _BUILTIN = ("qps", "inflight", "p95_ms")

    def __post_init__(self) -> None:
        if self.min_replicas < 1 or self.max_replicas < self.min_replicas:
            raise ValueError("need 1 <= min_replicas <= max_replicas")
        bad = [k for k, v in self.custom_targets.items() if v <= 0 or k in self._BUILTIN]
        if bad:
            raise ValueError(f"custom_targets entries must be > 0 and not shadow builtins: {bad}")
        if not self.metric_specs():
            raise ValueError(
                "set at least one of target_qps_per_replica / "
                "target_inflight_per_replica / target_p95_ms / custom_targets"
            )

    def metric_specs(self) -> List[Tuple[str, float, bool]]:
        """Active metrics as (name, target, divides_per_replica)."""
        out: List[Tuple[str, float, bool]] = []
        if self.target_qps_per_replica > 0:
            out.append(("qps", self.target_qps_per_replica, True))
        if self.target_inflight_per_replica > 0:
            out.append(("inflight", self.target_inflight_per_replica, True))
        if self.target_p95_ms > 0:
            # a latency quantile does not divide across replicas
            out.append(("p95_ms", self.target_p95_ms, False))
        for name in sorted(self.custom_targets):
            out.append((name, self.custom_targets[name], True))
        return out

    @property
    def target(self) -> float:
        """First active target (single-metric convenience accessor)."""
        return self.metric_specs()[0][1]

    @property
    def per_replica(self) -> bool:
        """Whether the first active metric divides across replicas."""
        return self.metric_specs()[0][2]

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "HpaSpec":
        """Parse the predictor spec's ``hpa`` block.

        Accepts both this framework's key names and the reference's
        ``minReplicas`` / ``maxReplicas`` camelCase.
        """
        def pick(*names, default=None):
            for n in names:
                if n in d:
                    return d[n]
            return default

        return cls(
            min_replicas=int(pick("min_replicas", "minReplicas", default=1)),
            max_replicas=int(pick("max_replicas", "maxReplicas", default=4)),
            target_qps_per_replica=float(pick("target_qps_per_replica", "targetQps", default=0.0)),
            target_inflight_per_replica=float(
                pick("target_inflight_per_replica", "targetInflight", default=0.0)
            ),
            target_p95_ms=float(pick("target_p95_ms", "targetP95Ms", default=0.0)),
            custom_targets={
                str(k): float(v)
                for k, v in (pick("custom_targets", "customTargets", default={}) or {}).items()
            },
            tolerance=float(pick("tolerance", default=0.1)),
            scale_down_stabilization_s=float(
                pick("scale_down_stabilization_s", "stabilizationWindowSeconds", default=60.0)
            ),
            poll_interval_s=float(pick("poll_interval_s", default=2.0)),
        )


class ReplicaSet:
    """N identical supervised microservice processes for one node."""

    def __init__(
        self,
        base: ProcessSpec,
        wait_ready_s: float = 60.0,
        on_change: Optional[Callable[[List[ProcessSpec]], None]] = None,
    ):
        self.base = base
        self.wait_ready_s = wait_ready_s
        self.on_change = on_change
        self._replicas: List[SupervisedProcess] = []
        self._lock = threading.Lock()
        # serializes on_change deliveries; each delivery re-snapshots the
        # replica list, so interleaved scale()/stop_all() calls can never
        # leave the load balancer holding a stale (e.g. terminated) set
        self._notify_lock = threading.Lock()
        self._serial = 0

    @property
    def replica_count(self) -> int:
        with self._lock:
            return len(self._replicas)

    @property
    def processes(self) -> Dict[str, SupervisedProcess]:
        """The live replicas by name (read by the gateway's /debug/workers
        and the fleet view, as a Supervisor's ``processes`` are)."""
        with self._lock:
            return {r.spec.name: r for r in self._replicas}

    @property
    def specs(self) -> List[ProcessSpec]:
        with self._lock:
            return [r.spec for r in self._replicas]

    def _spawn_one(self) -> SupervisedProcess:
        self._serial += 1
        # internal replicas speak plaintext to the engine's BalancedClient
        # (TLS terminates at the external gateway); never inherit the
        # operator's SELDON_TLS_* into a replica
        env = {"SELDON_TLS_CERT": "", "SELDON_TLS_KEY": "", "SELDON_TLS_CA": ""}
        env.update(self.base.env)
        spec = ProcessSpec(
            name=f"{self.base.name}-{self._serial}",
            component=self.base.component,
            http_port=_free_port(),
            grpc_port=_free_port(),
            parameters_json=self.base.parameters_json,
            api=self.base.api,
            env=env,
            cwd=self.base.cwd,
        )
        sp = SupervisedProcess(spec)
        sp.start()
        if not sp.wait_ready(self.wait_ready_s):
            sp.stop()
            raise TimeoutError(f"replica {spec.name!r} never became ready")
        return sp

    def scale(self, n: int) -> int:
        """Grow/shrink to n replicas; newest are retired first.

        If a spawn fails partway, on_change still fires for the replicas
        that did come up — a live replica the load balancer cannot see
        would silently skew the per-replica metric — and the error is
        re-raised for the caller's reconcile loop to retry.
        """
        started: List[SupervisedProcess] = []
        stopped: List[SupervisedProcess] = []
        spawn_error: Optional[Exception] = None
        with self._lock:
            while len(self._replicas) < n:
                try:
                    sp = self._spawn_one()
                except Exception as e:  # noqa: BLE001 — spawn failure is
                    # surfaced as reconcile-degraded, not a dead autoscaler
                    spawn_error = e
                    break
                self._replicas.append(sp)
                started.append(sp)
            if spawn_error is None:
                while len(self._replicas) > n:
                    stopped.append(self._replicas.pop())
            current = list(self._replicas)
        for sp in stopped:  # SIGTERM -> microservice drains in-flight work
            sp.stop()
        if started or stopped:
            self._notify()
        if started or stopped:
            logger.info(
                "replicaset %s scaled to %d (+%d/-%d)",
                self.base.name, len(current), len(started), len(stopped),
            )
        if spawn_error is not None:
            raise spawn_error
        return len(current)

    def _notify(self) -> None:
        if self.on_change is None:
            return
        with self._notify_lock:
            with self._lock:
                specs = [r.spec for r in self._replicas]
            self.on_change(specs)

    def stop_all(self) -> None:
        self.scale(0)

    def health(self) -> Dict[str, Dict]:
        with self._lock:
            replicas = list(self._replicas)
        return {
            r.spec.name: {"alive": r.alive(), "ready": r.ready(), "restarts": r.restarts}
            for r in replicas
        }


class CounterRateSampler:
    """Cumulative counter -> rate per second between samples."""

    def __init__(self, get_count: Callable[[], float], clock: Callable[[], float] = time.monotonic):
        self._get_count = get_count
        self._clock = clock
        self._last: Optional[Tuple[float, float]] = None

    def __call__(self) -> float:
        now, count = self._clock(), float(self._get_count())
        if self._last is None:
            self._last = (now, count)
            return 0.0
        then, prev = self._last
        self._last = (now, count)
        dt = now - then
        if dt <= 0:
            return 0.0
        return max(0.0, (count - prev) / dt)


def gateway_request_count(gateway) -> Callable[[], float]:
    """Total request count across a Gateway's predictor services, for
    wrapping in a CounterRateSampler."""

    def total() -> float:
        return float(sum(svc.stats.get("requests", 0) for svc in gateway.predictors))

    return total


@dataclass
class ScaleDecision:
    at: float
    metric: float  # the value of the proposal that won (max rule)
    desired: int
    applied: int
    metrics: Dict[str, float] = field(default_factory=dict)


class Autoscaler:
    """The HPA control loop over one ReplicaSet (or anything exposing
    ``replica_count`` and ``scale(n)``).

    ``metric_fn`` may be a single callable (when the spec has exactly
    one active target) or a dict mapping the spec's metric names
    (``qps`` / ``inflight`` / ``p95_ms`` / custom names) to callables.
    With several active metrics each produces its own replica proposal
    and the max wins (k8s autoscaling/v2), so a deployment can hold
    both a QPS floor and a latency ceiling at once.
    """

    def __init__(
        self,
        replicaset: Any,
        hpa: HpaSpec,
        metric_fn: Union[Callable[[], float], Dict[str, Callable[[], float]]],
        clock: Callable[[], float] = time.monotonic,
    ):
        self.replicaset = replicaset
        self.hpa = hpa
        specs = hpa.metric_specs()
        if callable(metric_fn):
            if len(specs) != 1:
                raise ValueError(
                    f"spec has {len(specs)} active metrics "
                    f"({[n for n, _, _ in specs]}); pass metric_fn as a dict"
                )
            metric_fn = {specs[0][0]: metric_fn}
        missing = [n for n, _, _ in specs if n not in metric_fn]
        if missing:
            raise ValueError(f"metric_fn missing samplers for {missing}")
        self.metric_fns: Dict[str, Callable[[], float]] = dict(metric_fn)
        self.clock = clock
        # bounded: one decision lands every poll interval for the life
        # of the deployment
        self.history: Deque[ScaleDecision] = deque(maxlen=512)
        # (time, desired) recommendations inside the stabilization window
        self._recommendations: List[Tuple[float, int]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _desired(self, metric: float, current: int, target: float, per_replica: bool) -> int:
        """k8s formula: desired = ceil(current * ratio), dead-banded.

        Latency targets skip the per-replica division: p95 does not
        halve because a second replica exists, but scaling by the
        overload ratio still moves capacity the right direction (and a
        zero-latency idle window never scales up)."""
        if current == 0:
            return self.hpa.min_replicas
        if per_replica:
            ratio = (metric / current) / target
        else:
            if metric <= 0:  # no traffic in the window: hold
                return current
            ratio = metric / target
        if abs(ratio - 1.0) <= self.hpa.tolerance:
            desired = current
        else:
            desired = math.ceil(current * ratio)
        return max(self.hpa.min_replicas, min(self.hpa.max_replicas, desired))

    def evaluate_once(self) -> int:
        """One reconcile step; returns the replica count now in force."""
        now = self.clock()
        current = self.replicaset.replica_count
        # one proposal per active metric; the max wins (k8s multi-metric)
        samples: Dict[str, float] = {}
        desired, winner = 0, 0.0
        for name, target, per_replica in self.hpa.metric_specs():
            value = float(self.metric_fns[name]())
            samples[name] = value
            proposal = self._desired(value, current, target, per_replica)
            if proposal > desired:  # proposals are already >= min_replicas
                desired, winner = proposal, value
        # scale-down stabilization: act on the max desired seen in-window
        horizon = now - self.hpa.scale_down_stabilization_s
        self._recommendations = [(t, d) for t, d in self._recommendations if t >= horizon]
        self._recommendations.append((now, desired))
        if desired < current:
            desired = max(d for _, d in self._recommendations)
        applied = current
        if desired != current:
            applied = self.replicaset.scale(desired)
        self.history.append(
            ScaleDecision(at=now, metric=winner, desired=desired, applied=applied, metrics=samples)
        )
        return applied

    def start(self) -> None:
        if self.replicaset.replica_count < self.hpa.min_replicas:
            self.replicaset.scale(self.hpa.min_replicas)
        self._thread = threading.Thread(target=self._loop, daemon=True, name="autoscaler")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.evaluate_once()
            except Exception as e:  # noqa: BLE001 — keep reconciling
                logger.warning("autoscaler reconcile failed: %s", e)
            self._stop.wait(self.hpa.poll_interval_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
