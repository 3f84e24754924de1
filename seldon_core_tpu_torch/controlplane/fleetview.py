"""Fleet telemetry aggregation: N replica rings -> one fleet view.

The replica half of the telemetry plane (utils/telemetry.py) serves a
versioned snapshot per process at ``GET /debug/telemetry``; this module
is the control-plane half — :class:`TelemetryAggregator` polls every
replica endpoint over the transport idioms the data plane already uses
(deadline + trace headers propagated on each poll hop, per-endpoint
circuit breakers so a dead replica costs one fast-fail per interval,
full-jitter backoff between consecutive failures) and merges the
snapshots into ONE fleet view keyed by replica id:

* per-replica saturation score (utils/telemetry.saturation_score),
* fleet-wide adapter residency map (adapter -> replicas holding it) —
  the placement input the roadmap's bandit router needs,
* fleet rate/aggregate rollups (queue depth, goodput, pool pressure,
  shed/preempt rates, chunk p99 max) — the autoscaler's fleet signal.

A replica that stops answering transitions to ``stale`` after
``SELDON_TPU_FLEET_STALE_S`` WITHOUT failing the poll loop (the last
good snapshot is retained and labeled; crash-looping replicas are the
supervisor's business, the aggregator only reports freshness).  A
replica answering with a FUTURE schema version is ``incompatible`` —
mixed-version fleets degrade loudly instead of mis-merging fields.

Exposed at the gateway's ``GET /debug/fleet`` and exported as
``seldon_tpu_fleet_*`` gauges by utils/metrics.FleetPrometheusBridge
(complete-by-contract against :func:`fleet_rollup`'s key set, enforced
by ``tests/test_torch_port_fleetview.py``).
"""

from __future__ import annotations

import json
import logging
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional

from seldon_core_tpu_torch.runtime import knobs as _knobs
from seldon_core_tpu_torch.utils import telemetry as _telemetry

logger = logging.getLogger(__name__)

__all__ = [
    "TelemetryAggregator",
    "endpoints_from_knob",
    "endpoints_from_supervisor",
]

# replica freshness states the fleet view reports (stale-not-crashed is
# the load-bearing distinction: the poll loop never dies with a replica)
STATE_OK = "ok"
STATE_STALE = "stale"
STATE_INCOMPATIBLE = "incompatible"
STATE_NEVER = "never"


def endpoints_from_knob(raw: Optional[str] = None) -> Dict[str, str]:
    """Parse ``SELDON_TPU_FLEET_ENDPOINTS``: comma-separated replica
    base URLs, each optionally named (``name=http://host:port``); bare
    URLs are named by their host:port tail."""
    if raw is None:
        raw = _knobs.raw("SELDON_TPU_FLEET_ENDPOINTS", "") or ""
    out: Dict[str, str] = {}
    for part in raw.split(","):
        part = part.strip()
        if not part or part == "0":
            continue
        if "=" in part and not part.startswith(("http://", "https://")):
            name, _, url = part.partition("=")
        else:
            name, url = part.rstrip("/").rsplit("/", 1)[-1], part
        out[name.strip()] = url.strip().rstrip("/")
    return out


def endpoints_from_supervisor(supervisor: Any) -> Dict[str, str]:
    """Derive replica base URLs from a local supervisor's worker specs
    (the single-host topology: every supervised worker serves its own
    /debug/telemetry on its REST port)."""
    out: Dict[str, str] = {}
    for name, sp in getattr(supervisor, "processes", {}).items():
        port = getattr(getattr(sp, "spec", None), "http_port", None)
        if port:
            out[name] = f"http://127.0.0.1:{int(port)}"
    return out


class TelemetryAggregator:
    """Polls N replica telemetry endpoints and maintains the merged
    fleet view.  ``poll_once()`` is the synchronous unit (tests drive
    it directly); ``start()`` runs it on a daemon thread every
    ``poll_s`` seconds until ``stop()``."""

    def __init__(
        self,
        endpoints: Optional[Dict[str, str]] = None,
        poll_s: Optional[float] = None,
        stale_s: Optional[float] = None,
        window_s: float = 30.0,
        timeout_s: float = 2.0,
        clock=time.monotonic,
    ):
        self.endpoints = dict(endpoints) if endpoints else endpoints_from_knob()
        self.poll_s = float(
            poll_s if poll_s is not None
            else float(_knobs.raw("SELDON_TPU_FLEET_POLL_S", "2") or 2)
        )
        self.stale_s = float(
            stale_s if stale_s is not None
            else float(_knobs.raw("SELDON_TPU_FLEET_STALE_S", "10") or 10)
        )
        self.window_s = float(window_s)
        self.timeout_s = float(timeout_s)
        self._clock = clock
        self._lock = threading.Lock()
        # replica name -> {snapshot, last_ok, last_err, incompatible, fails}
        self._replicas: Dict[str, Dict[str, Any]] = {
            name: {"snapshot": None, "last_ok": 0.0, "last_err": "",
                   "incompatible": False, "fails": 0}
            for name in self.endpoints
        }
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self.polls = 0
        # optional prometheus bridge, collected after every poll
        self.bridge = None

    def set_endpoints(self, endpoints: Dict[str, str]) -> None:
        """Replace the polled set (a supervisor's workers come and go):
        new replicas start ``never`` polled, departed ones leave the view."""
        with self._lock:
            self.endpoints = dict(endpoints)
            for name in list(self._replicas):
                if name not in self.endpoints:
                    del self._replicas[name]
            for name in self.endpoints:
                self._replicas.setdefault(name, {"snapshot": None, "last_ok": 0.0, "last_err": "",
                                                 "incompatible": False, "fails": 0})

    # ---- polling ----------------------------------------------------------

    def _poll_url(self, url: str) -> Dict[str, Any]:
        """One poll hop: deadline + trace headers ride the request like
        any data-plane hop, so a fleet poll shows up in the request's
        trace and honours an enclosing deadline."""
        from seldon_core_tpu_torch.utils import deadlines as _deadlines
        from seldon_core_tpu_torch.utils import tracing as _tracing

        headers: Dict[str, str] = {}
        _deadlines.inject(headers)
        _tracing.inject(headers)
        req = urllib.request.Request(url, headers=headers)
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            return json.loads(resp.read().decode("utf-8"))

    def _poll_replica(self, name: str, base: str) -> None:
        from seldon_core_tpu_torch.engine.transport import (
            _BreakerCall,
            _resolve_breaker,
        )
        from seldon_core_tpu_torch.runtime.component import MicroserviceError

        entry = self._replicas.setdefault(
            name, {"snapshot": None, "last_ok": 0.0, "last_err": "",
                   "incompatible": False, "fails": 0},
        )
        url = f"{base}/debug/telemetry?window={self.window_s:g}"
        breaker = _resolve_breaker(f"fleet:{base}", None)
        try:
            call = _BreakerCall(breaker, name, "telemetry", "rest")
        except MicroserviceError as exc:
            # breaker open: fast-fail, keep the last snapshot — the
            # replica ages into `stale` without a dial attempt
            with self._lock:
                entry["last_err"] = str(exc.reason)
            return
        healthy: Optional[bool] = None
        try:
            payload = self._poll_url(url)
            healthy = True  # the endpoint answered — breaker-healthy
            snap = _telemetry.validate_snapshot(payload)
            with self._lock:
                entry["snapshot"] = snap
                entry["last_ok"] = self._clock()
                entry["last_err"] = ""
                entry["incompatible"] = False
                entry["fails"] = 0
        except _telemetry.SchemaVersionError as exc:
            # answered, but from the future: degrade loudly, don't merge
            with self._lock:
                entry["incompatible"] = True
                entry["last_err"] = str(exc)
        except ValueError as exc:
            # answered with garbage (no version / not JSON): same bucket
            # — and still breaker-healthy, the endpoint is alive
            healthy = True
            with self._lock:
                entry["incompatible"] = True
                entry["last_err"] = str(exc)
        except Exception as exc:  # noqa: BLE001 — connection faults
            call.attempt_transient()
            healthy = False
            with self._lock:
                entry["fails"] += 1
                entry["last_err"] = f"{type(exc).__name__}: {exc}"
        finally:
            call.settle(healthy)

    def poll_once(self) -> Dict[str, Any]:
        """Poll every endpoint once (serially: fleet sizes here are
        replica counts, not thousands — and serial polls keep the
        breaker evidence ordered), then return the fleet view."""
        for name, base in self.endpoints.items():
            self._poll_replica(name, base)
        self.polls += 1
        if self.bridge is not None:
            self.bridge.collect()
        return self.fleet_view()

    # ---- background loop --------------------------------------------------

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop_evt.clear()
        self._thread = threading.Thread(
            target=self._loop, name="fleet-telemetry-poll", daemon=True
        )
        self._thread.start()

    def stop(self, timeout_s: float = 5.0) -> None:
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)
            self._thread = None

    def _loop(self) -> None:
        from seldon_core_tpu_torch.engine.transport import backoff_s

        consecutive_empty = 0
        while not self._stop_evt.is_set():
            try:
                view = self.poll_once()
                ok = sum(
                    1 for r in view["replicas"].values()
                    if r["state"] == STATE_OK
                )
                consecutive_empty = 0 if ok else consecutive_empty + 1
            except Exception:  # noqa: BLE001 — the poll loop never dies
                logger.exception("fleet telemetry poll failed")
                consecutive_empty += 1
            # full-jitter backoff ON TOP of the interval when the whole
            # fleet is dark — a mass restart must not be greeted by a
            # synchronized poll stampede
            delay = self.poll_s + (
                backoff_s(min(consecutive_empty, 6)) if consecutive_empty else 0.0
            )
            self._stop_evt.wait(timeout=delay)

    # ---- merged views -----------------------------------------------------

    def _state_of(self, entry: Dict[str, Any], now: float) -> str:
        if entry["incompatible"]:
            return STATE_INCOMPATIBLE
        if not entry["last_ok"]:
            return STATE_NEVER
        if now - entry["last_ok"] > self.stale_s:
            return STATE_STALE
        return STATE_OK

    def replica_states(self) -> Dict[str, Dict[str, Any]]:
        """Per-replica freshness + latest point + saturation — the
        fleet view's rows and the bridge's per-replica gauges."""
        now = self._clock()
        out: Dict[str, Dict[str, Any]] = {}
        with self._lock:
            for name, entry in self._replicas.items():
                snap = entry["snapshot"] or {}
                latest = snap.get("latest") or {}
                out[name] = {
                    "state": self._state_of(entry, now),
                    "url": self.endpoints.get(name, ""),
                    "replica_id": snap.get("replica_id", name),
                    "schema_version": snap.get("schema_version"),
                    "age_s": round(now - entry["last_ok"], 3)
                    if entry["last_ok"] else None,
                    "last_err": entry["last_err"],
                    "saturation": float(latest.get("saturation", 0.0)),
                    "latest": latest,
                }
        return out

    def fleet_rollup(self) -> Dict[str, Any]:
        """Flat numeric fleet aggregates.  COMPLETE BY CONTRACT: every
        key here must be mapped in utils/metrics.FLEET_METRICS or listed
        in FLEET_EXCLUDED (``tests/test_torch_port_fleetview.py``), so a
        new rollup cannot silently skip Prometheus export.  Sums cover
        ``ok`` replicas only — stale numbers are history, not capacity."""
        replicas = self.replica_states()
        ok = [r["latest"] for r in replicas.values() if r["state"] == STATE_OK]
        sats = [
            r["saturation"] for r in replicas.values()
            if r["state"] == STATE_OK
        ]

        def total(key: str) -> float:
            return round(sum(float(p.get(key, 0) or 0) for p in ok), 3)

        hits = [float(p.get("prefix_hit_pct", 0.0)) for p in ok]
        costs = [
            float(p["predict_cost_s"]) for p in ok
            if p.get("predict_cost_s") is not None
        ]
        # tier-off replicas omit the key entirely (snapshot sheds with
        # engine_stats); only reporters shape the fleet hit rate
        tier_rates = [
            float(p["kv_tier_hit_rate"]) for p in ok
            if p.get("kv_tier_hit_rate") is not None
        ]
        return {
            "t": self._clock(),
            "replicas_total": len(replicas),
            "replicas_ok": len(ok),
            "replicas_stale": sum(
                1 for r in replicas.values() if r["state"] == STATE_STALE
            ),
            "replicas_incompatible": sum(
                1 for r in replicas.values()
                if r["state"] == STATE_INCOMPATIBLE
            ),
            "fleet_queue_depth": total("queue_depth"),
            "fleet_active_slots": total("active_slots"),
            "fleet_slots_total": total("active_slots_total"),
            "fleet_goodput_tok_s": total("goodput_tok_s"),
            "fleet_prefill_tok_s": total("prefill_tok_s"),
            "fleet_completed_s": total("completed_s"),
            "fleet_shed_s": total("shed_s"),
            "fleet_preempted_s": total("preempted_s"),
            "fleet_migrated_out_s": total("migrated_out_s"),
            "fleet_pool_pages_used": total("pool_pages_used"),
            "fleet_pool_pages_total": total("pool_pages_total"),
            "fleet_cost_page_s_s": total("cost_page_s_s"),
            "fleet_prefix_hit_pct": round(sum(hits) / len(hits), 2)
            if hits else 0.0,
            "fleet_saturation_max": round(max(sats), 4) if sats else 0.0,
            "fleet_saturation_mean": round(sum(sats) / len(sats), 4)
            if sats else 0.0,
            "fleet_chunk_p99_ms": round(
                max((float(p.get("chunk_p99_ms", 0.0)) for p in ok),
                    default=0.0), 3,
            ),
            "fleet_predict_cost_s_max": round(max(costs), 4)
            if costs else 0.0,
            "fleet_kv_tier_host_bytes": total("kv_tier_host_bytes"),
            "fleet_kv_tier_hit_rate": round(
                sum(tier_rates) / len(tier_rates), 4
            ) if tier_rates else 0.0,
        }

    def adapter_residency(self) -> Dict[str, List[str]]:
        """Fleet adapter residency map: adapter name -> sorted replica
        names currently holding it resident (ok replicas only) — the
        adapter-affinity placement input."""
        out: Dict[str, List[str]] = {}
        for name, r in self.replica_states().items():
            if r["state"] != STATE_OK:
                continue
            for adapter in r["latest"].get("adapters") or []:
                out.setdefault(str(adapter), []).append(name)
        return {k: sorted(v) for k, v in sorted(out.items())}

    def prefix_residency(self) -> Dict[str, int]:
        """Fleet prefix-cache map: replica -> cached prefix pages (ok
        replicas) — where warm prompt prefixes actually live."""
        return {
            name: int(r["latest"].get("prefix_pages_cached", 0))
            for name, r in self.replica_states().items()
            if r["state"] == STATE_OK
        }

    def fleet_view(self) -> Dict[str, Any]:
        """The ``GET /debug/fleet`` payload: rows + maps + rollup."""
        return {
            "schema_version": _telemetry.TELEMETRY_SCHEMA_VERSION,
            "poll_s": self.poll_s,
            "stale_s": self.stale_s,
            "polls": self.polls,
            "replicas": self.replica_states(),
            "adapters": self.adapter_residency(),
            "prefix_pages": self.prefix_residency(),
            "rollup": self.fleet_rollup(),
        }
