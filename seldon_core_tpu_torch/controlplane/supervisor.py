"""Process supervisor for out-of-process graph nodes.

Co-located nodes run in-process (the fast path), but cross-host nodes
and isolation-needing components run as microservice processes — the
role kubelet + Deployment controller play for the reference.  The
supervisor provides the failure-detection / elastic-recovery loop
(reference analogue: k8s restarts + readiness gating,
reference: SURVEY §5.3):

* spawn the port's microservice (``python -m
  seldon_core_tpu_torch.runtime.microservice``) with env-injected config
  (the reference operator injects PREDICTIVE_UNIT_* env vars,
  reference: microservice.py:20-22),
* poll process liveness + HTTP readiness,
* restart crashed processes with exponential backoff.
"""

from __future__ import annotations

import logging
import os
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)


@dataclass
class ProcessSpec:
    name: str
    component: str  # dotted module.Class
    http_port: int
    grpc_port: int
    parameters_json: str = "[]"
    api: str = "BOTH"
    env: Dict[str, str] = field(default_factory=dict)
    cwd: Optional[str] = None


def _default_journal_path(spec: ProcessSpec) -> str:
    """Stable-per-worker drain-journal path: the SAME path across
    respawns of one worker — a SIGTERM'd process drains its live
    generation streams here and the respawned process replays them — but
    distinct per (name, port) so two deployments' workers never read
    each other's journals."""
    import tempfile

    return os.path.join(
        tempfile.gettempdir(),
        f"seldon-tpu-journal-{spec.name}-{spec.http_port}.jsonl",
    )


class SupervisedProcess:
    def __init__(self, spec: ProcessSpec, max_restarts: int = 5):
        self.spec = spec
        self.max_restarts = max_restarts
        self.restarts = 0
        # restart budget spent and the process is gone: the worker is
        # DEAD until redeployed.  Surfaced (not just logged) because the
        # alert/breaker layer must be able to tell "restarting" from
        # "the supervisor gave up" — the silent-dead state.
        self.exhausted = False
        self.proc: Optional[subprocess.Popen] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # pin the drain/handoff journal path for every respawn of this
        # worker (an explicit env wins — operators can point workers at
        # persistent storage)
        self.spec.env.setdefault(
            "SELDON_TPU_DRAIN_JOURNAL", _default_journal_path(spec)
        )

    def _command(self) -> List[str]:
        return [
            sys.executable,
            "-m",
            "seldon_core_tpu_torch.runtime.microservice",
            self.spec.component,
            "--api",
            self.spec.api,
            "--http-port",
            str(self.spec.http_port),
            "--grpc-port",
            str(self.spec.grpc_port),
            "--parameters",
            self.spec.parameters_json,
            "--unit-id",
            self.spec.name,
        ]

    def _spawn(self) -> None:
        env = dict(os.environ)
        env.update(self.spec.env)
        self.proc = subprocess.Popen(self._command(), env=env, cwd=self.spec.cwd)
        logger.info("spawned node %s pid=%d", self.spec.name, self.proc.pid)

    def start(self) -> None:
        self._spawn()
        self._thread = threading.Thread(target=self._watch, daemon=True, name=f"supervise-{self.spec.name}")
        self._thread.start()

    def _record_health(self) -> None:
        """Worker lifecycle → Prometheus (WorkerRestartsExhausted alerts
        on the exhausted gauge).  Best-effort: a metrics fault must not
        take the watch loop down."""
        try:
            from seldon_core_tpu_torch.utils.metrics import record_worker_health

            record_worker_health(self.spec.name, self.restarts, self.exhausted)
        except Exception:  # noqa: BLE001 — metrics must not break supervision
            logger.debug("worker health metric unavailable", exc_info=True)

    def _watch(self) -> None:
        backoff = 0.5
        while not self._stop.is_set():
            code = self.proc.poll()
            if code is not None:
                if self._stop.is_set():
                    return
                if self.restarts >= self.max_restarts:
                    # NOT silent: the exhausted state is queryable
                    # (Supervisor.health → gateway /debug/workers) and
                    # exported, so the alert/breaker layer sees a dead
                    # worker instead of inferring it from absence
                    self.exhausted = True
                    self._record_health()
                    logger.error(
                        "node %s exceeded restart budget (rc=%s) — worker is "
                        "DEAD until redeployed (restarts=%d/%d); "
                        "/debug/workers reports exhausted=true",
                        self.spec.name, code, self.restarts, self.max_restarts,
                    )
                    return
                self.restarts += 1
                self._record_health()
                logger.warning(
                    "node %s exited rc=%s; restart %d/%d in %.1fs",
                    self.spec.name, code, self.restarts, self.max_restarts, backoff,
                )
                time.sleep(backoff)
                backoff = min(backoff * 2, 30.0)
                self._spawn()
            else:
                self._stop.wait(0.2)

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def ready(self, timeout_s: float = 1.0) -> bool:
        """HTTP readiness probe against the node's /health/ping."""
        import urllib.request

        try:
            with urllib.request.urlopen(
                f"http://127.0.0.1:{self.spec.http_port}/health/ping", timeout=timeout_s
            ) as resp:
                return resp.status < 400
        except Exception:  # any probe failure reads as not-ready
            return False

    def wait_ready(self, timeout_s: float = 30.0) -> bool:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.ready():
                return True
            if not self.alive() and self.restarts >= self.max_restarts:
                return False
            time.sleep(0.25)
        return False

    def stop(self, grace_s: float = 10.0) -> None:
        """Deliberate teardown: SIGTERM (the worker drains its live
        streams to the journal and exits — drain-then-exit), escalate to
        SIGKILL after the grace window.  The journal is removed
        afterwards: handoff exists for RESPAWN (crash / rolling
        restart), not final teardown — a stale journal must not leak
        into the next deployment that reuses the name+port."""
        self._stop.set()
        if self.proc is not None and self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=grace_s)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        journal = self.spec.env.get("SELDON_TPU_DRAIN_JOURNAL")
        if journal:
            try:
                os.unlink(journal)
            except OSError:
                pass  # never written / already consumed


def disagg_worker_specs(
    name: str,
    *,
    prefill_workers: int = 1,
    base_http: int = 9500,
    base_grpc: int = 9600,
    decode_component: str = "seldon_core_tpu_torch.models.disagg.DisaggregatedLM",
    prefill_component: str = "seldon_core_tpu_torch.models.disagg.PrefillLM",
    parameters_json: str = "[]",
    env: Optional[Dict[str, str]] = None,
) -> List[ProcessSpec]:
    """Worker-set specs for a DistServe-style disaggregated deployment
    N dedicated prefill workers plus ONE decode worker whose
    ``prefill_endpoints`` parameter points at them, every role pinned
    via ``SELDON_TPU_DISAGG_ROLE`` so operators (and ``/debug``
    surfaces) can tell the roles apart.  The decode worker keeps the
    drain/handoff journal default (it owns the live decode streams);
    prefill workers are stateless between requests — a crashed prefill
    worker loses only in-flight exports, which the coordinator's
    waiters see as ordinary transport errors and retry.

    Spawn order matters: put the PREFILL specs up first (the returned
    list is ordered that way) so the decode worker's first dial finds
    live endpoints instead of paying a retry ladder."""
    import json

    specs: List[ProcessSpec] = []
    endpoints: List[str] = []
    for i in range(max(1, int(prefill_workers))):
        http, grpc = base_http + 1 + i, base_grpc + 1 + i
        endpoints.append(f"grpc://127.0.0.1:{grpc}")
        specs.append(ProcessSpec(
            name=f"{name}-prefill-{i}",
            component=prefill_component,
            http_port=http,
            grpc_port=grpc,
            parameters_json=parameters_json,
            env={**(env or {}), "SELDON_TPU_DISAGG_ROLE": "prefill"},
        ))
    params = json.loads(parameters_json or "[]")
    params.append({
        "name": "prefill_endpoints",
        "value": json.dumps(endpoints),
        "type": "STRING",
    })
    specs.append(ProcessSpec(
        name=f"{name}-decode",
        component=decode_component,
        http_port=base_http,
        grpc_port=base_grpc,
        parameters_json=json.dumps(params),
        env={**(env or {}), "SELDON_TPU_DISAGG_ROLE": "decode"},
    ))
    return specs


def replica_worker_specs(
    name: str,
    *,
    replicas: int = 2,
    base_http: int = 9700,
    base_grpc: int = 9800,
    component: str = "seldon_core_tpu_torch.models.paged.StreamingLM",
    parameters_json: str = "[]",
    env: Optional[Dict[str, str]] = None,
    evacuate_chain: bool = True,
) -> List[ProcessSpec]:
    """Worker-set specs for an evacuation-chained replica group:
    N identical decode workers where replica i's
    ``SELDON_TPU_EVACUATE_TO`` points at replica (i+1) % N — a
    SIGTERM'd (or watchdog-evacuating) replica live-migrates its
    mid-decode streams to its neighbour as SRT1 migration containers
    instead of re-deriving them from a journal, and the drain journal
    remains the fallback for streams the ship fails.  The journal path
    stays pinned per worker, so the two recovery
    lanes compose: migrate what you can, journal the rest.

    ``evacuate_chain=False`` degrades to plain replicas (journal-only
    recovery), byte-identical env otherwise."""
    specs: List[ProcessSpec] = []
    n = max(1, int(replicas))
    for i in range(n):
        worker_env = dict(env or {})
        if evacuate_chain and n > 1:
            peer_grpc = base_grpc + ((i + 1) % n)
            worker_env["SELDON_TPU_EVACUATE_TO"] = (
                f"grpc://127.0.0.1:{peer_grpc}"
            )
        specs.append(ProcessSpec(
            name=f"{name}-{i}",
            component=component,
            http_port=base_http + i,
            grpc_port=base_grpc + i,
            parameters_json=parameters_json,
            env=worker_env,
        ))
    return specs


class Supervisor:
    """Manages the full set of out-of-process nodes on this host."""

    def __init__(self) -> None:
        self.processes: Dict[str, SupervisedProcess] = {}

    def add_group(
        self, specs: List[ProcessSpec], wait_ready_s: float = 30.0
    ) -> List[SupervisedProcess]:
        """Spawn a worker SET in list order (e.g. ``disagg_worker_specs``:
        prefill workers first, then the decode worker that dials them),
        tearing the whole group down if any member never comes ready —
        a half-spawned disaggregated deployment serves nothing."""
        started: List[SupervisedProcess] = []
        try:
            for spec in specs:
                started.append(self.add(spec, wait_ready_s=wait_ready_s))
        except Exception:
            for sp in started:
                sp.stop()
                self.processes.pop(sp.spec.name, None)
            raise
        return started

    def add(self, spec: ProcessSpec, wait_ready_s: float = 30.0) -> SupervisedProcess:
        sp = SupervisedProcess(spec)
        sp.start()
        if wait_ready_s and not sp.wait_ready(wait_ready_s):
            sp.stop()
            raise TimeoutError(f"node {spec.name!r} never became ready")
        self.processes[spec.name] = sp
        return sp

    def stop_all(self) -> None:
        for sp in self.processes.values():
            sp.stop()
        self.processes.clear()

    def health(self) -> Dict[str, Dict]:
        """Per-worker lifecycle state (:func:`worker_health`)."""
        return worker_health(self.processes)


def worker_health(processes: Dict[str, SupervisedProcess]) -> Dict[str, Dict]:
    """Per-worker lifecycle state.  ``exhausted`` is the load-bearing
    bit: True means the restart budget is spent and the worker is dead
    until redeployed — the state the breaker/alert layer must
    distinguish from "restarting".  ``state`` summarises: running |
    restarting | exhausted | stopped."""
    out: Dict[str, Dict] = {}
    for name, sp in processes.items():
        alive = sp.alive()
        if sp.exhausted:
            state = "exhausted"
        elif alive:
            state = "running"
        elif sp._stop.is_set():  # noqa: SLF001 — own module
            state = "stopped"
        else:
            state = "restarting"
        out[name] = {
            "alive": alive,
            "ready": sp.ready(),
            "restarts": sp.restarts,
            "max_restarts": sp.max_restarts,
            "exhausted": sp.exhausted,
            "state": state,
        }
    return out
