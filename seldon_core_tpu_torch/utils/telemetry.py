"""Per-replica windowed telemetry time-series ring (the fleet plane's
replica half; the port's copy of ``seldon_core_tpu/utils/telemetry.py``,
whose snapshots validate in either package).

The flight recorder (utils/flightrec.py) answers "what did the last N
chunks do" and ``engine_stats()`` answers "how much since boot" — but
the control-plane consumers the roadmap names (bandit placement,
predictive autoscaling) need *windowed series*: queue depth, goodput,
prefill/decode token split, prefix hit rate, KV pool pressure, adapter
residency and shed/preempt/migrate rates over the last minute, not
since boot.  :class:`TelemetryRing` keeps a fixed-size ring of periodic
samples derived from engine-stats deltas + flight-recorder lifetime
totals (the wrap-safe ``total_*_tokens`` keys), appended lock-light
from the serving loop's throttled collect hook and on demand when a
poller asks.

The snapshot is a VERSIONED schema (``schema_version``): a fleet
aggregator (the JAX package's ``controlplane/fleetview.py``; the port's
comes with its control plane) refuses snapshots from a future schema
instead of mis-merging fields it does not understand — mixed-version
fleets degrade to ``incompatible`` replicas, never to silently wrong
rollups.

``SELDON_TPU_TELEMETRY=0`` turns the whole plane off (no ring, no
samples, no cost ledger accrual, no exemplars — behaviour-identical to
the pre-telemetry build).
"""

from __future__ import annotations

import os
import socket
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

__all__ = [
    "TELEMETRY_SCHEMA_VERSION",
    "SchemaVersionError",
    "telemetry_enabled",
    "TelemetryRing",
    "saturation_score",
    "validate_snapshot",
]

# bump ONLY with an aggregator that still understands every prior
# version; the aggregator rejects snapshots newer than what it parses
TELEMETRY_SCHEMA_VERSION = 1


class SchemaVersionError(ValueError):
    """A telemetry snapshot from a FUTURE schema version: the consumer
    must not guess at fields it does not understand."""


def telemetry_enabled() -> bool:
    """``SELDON_TPU_TELEMETRY=0`` disables the replica telemetry ring,
    the per-request cost ledger and histogram trace exemplars in one
    motion (default on)."""
    from seldon_core_tpu_torch.runtime import knobs

    return knobs.flag("SELDON_TPU_TELEMETRY")


def default_replica_id() -> str:
    """Stable-enough replica identity: the unit id when this process
    was spawned as a supervised worker (the microservice CLI exports
    its ``--unit-id`` back into ``PREDICTIVE_UNIT_ID``), else
    host:pid."""
    unit = os.environ.get("PREDICTIVE_UNIT_ID", "")
    if unit:
        return unit
    return f"{socket.gethostname()}:{os.getpid()}"


def saturation_score(point: Dict[str, Any]) -> float:
    """One replica-load scalar in [0, 1] from a telemetry point: the
    max of KV pool pressure and (bounded) queue backlog relative to the
    slot count — "is ANY serving resource near its ceiling".  The
    placement/autoscaling consumers rank replicas by it; the fleet
    rollup exposes the fleet max."""
    pool_total = max(1, int(point.get("pool_pages_total", 1)))
    kv = float(point.get("pool_pages_used", 0)) / pool_total
    slots = max(1, int(point.get("active_slots_total", 1)))
    backlog = float(point.get("queue_depth", 0)) / (2.0 * slots)
    return round(min(1.0, max(kv, backlog)), 4)


def validate_snapshot(snap: Dict[str, Any]) -> Dict[str, Any]:
    """Schema gate for one replica snapshot: raises
    :class:`SchemaVersionError` for a future-versioned payload and
    ``ValueError`` for a payload with no version at all."""
    version = snap.get("schema_version")
    if not isinstance(version, int):
        raise ValueError("telemetry snapshot carries no schema_version")
    if version > TELEMETRY_SCHEMA_VERSION:
        raise SchemaVersionError(
            f"telemetry snapshot schema_version={version} is newer than "
            f"this consumer understands ({TELEMETRY_SCHEMA_VERSION}) — "
            "upgrade the aggregator before the replicas"
        )
    return snap


class TelemetryRing:
    """Fixed-size ring of periodic telemetry samples for ONE replica.

    ``sample_engine(engine)`` derives one point from the engine's
    cumulative stats (rates come from deltas against the previous
    sample, using the flight recorder's wrap-safe lifetime token
    totals); ``sample(point)`` appends a pre-built point (tests, non-
    engine feeds).  Both are one deque append under a ring lock —
    nothing here touches the engine lock beyond the ``engine_stats()``
    call the serving loop already makes for the Prometheus bridge.
    """

    def __init__(
        self,
        replica_id: Optional[str] = None,
        capacity: int = 256,
        clock=time.time,
    ):
        self.replica_id = replica_id or default_replica_id()
        self.capacity = max(2, int(capacity))
        self._clock = clock
        self._ring: Deque[Dict[str, Any]] = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        # previous-sample cumulative anchors for the rate fields
        self._last_t = 0.0
        self._last: Dict[str, float] = {}

    # ---- feeding ----------------------------------------------------------

    def sample(self, point: Dict[str, Any]) -> Dict[str, Any]:
        point.setdefault("t", self._clock())
        with self._lock:
            self._ring.append(point)
        return point

    def sample_engine(self, engine: Any) -> Dict[str, Any]:
        """Derive one point from a live PagedEngine: windowed rates from
        cumulative deltas, residency sets from the adapter pool, cost
        observations from the admission-pricing model."""
        now = self._clock()
        stats = engine.engine_stats()
        recorder = getattr(engine, "recorder", None)
        rec = recorder.stats() if recorder is not None else {}
        adapters: List[str] = []
        astats_fn = getattr(engine, "adapter_stats", None)
        if astats_fn is not None:
            adapters = sorted(
                e["name"] for e in astats_fn().get("resident", [])
            )
        cum = {
            # flight-recorder lifetime totals (wrap-safe) where the
            # recorder runs; the engine's own counters otherwise
            "prefill_tokens": float(
                rec.get("total_prefill_tokens", stats.get("prefill_tokens", 0))
            ),
            "decode_tokens": float(
                rec.get("total_decode_tokens", stats.get("tokens", 0))
            ),
            "completed": float(stats.get("completed", 0)),
            "shed": float(stats.get("shed", 0)),
            "expired": float(stats.get("expired", 0)),
            "preempted": float(stats.get("preempted", 0)),
            "restored": float(stats.get("restored", 0)),
            "migrated_out": float(stats.get("migrated_out", 0)),
            "migrated_in": float(stats.get("migrated_in", 0)),
            "cost_page_seconds": float(stats.get("cost_page_seconds", 0.0)),
        }
        with self._lock:
            dt = now - self._last_t if self._last_t else 0.0
            last, self._last = self._last, cum
            self._last_t = now

        def rate(key: str) -> float:
            if dt <= 0.0:
                return 0.0
            return round((cum[key] - last.get(key, 0.0)) / dt, 3)

        hits = int(stats.get("prefix_hits", 0))
        misses = int(stats.get("prefix_misses", 0))
        hit_pct = round(100.0 * hits / (hits + misses), 2) if hits + misses else 0.0
        point: Dict[str, Any] = {
            "t": now,
            "queue_depth": int(stats.get("queued", 0)),
            "active_slots": int(stats.get("active", 0)),
            "active_slots_total": int(engine.max_slots),
            # goodput proxy: decode tokens actually served per second
            # over the sample window (prefill is work, not goodput)
            "goodput_tok_s": rate("decode_tokens"),
            "prefill_tok_s": rate("prefill_tokens"),
            "completed_s": rate("completed"),
            "prefix_hit_pct": hit_pct,
            "prefix_pages_cached": int(stats.get("prefix_pages_cached", 0)),
            "pool_pages_used": int(stats.get("pool_pages_used", 0)),
            "pool_pages_total": int(stats.get("pool_pages_total", 0)),
            "adapters": adapters,
            "shed_s": rate("shed"),
            "expired_s": rate("expired"),
            "preempted_s": rate("preempted"),
            "restored_s": rate("restored"),
            "migrated_out_s": rate("migrated_out"),
            "migrated_in_s": rate("migrated_in"),
            "cost_page_s_s": rate("cost_page_seconds"),
            "chunk_p99_ms": float(rec.get("chunk_p99_ms", 0.0)),
            # the admission-pricing observation (r15): predicted service
            # seconds for a nominal 128-in/64-out request from this
            # engine's measured rates; None while cold
            "predict_cost_s": engine.predict_cost_s(128, 64),
            "health": str(stats.get("health", "healthy")),
        }
        # KV tier (r22): keys ride only when SELDON_TPU_KV_OFFLOAD is on
        # — engine_stats sheds them on the off lane, and the snapshot
        # follows suit so fleet rollups can tell "tier off" from "tier
        # cold" (absent vs zero).
        if "kv_tier_host_bytes" in stats:
            t_hits = int(stats.get("kv_tier_host_hits", 0)) + int(
                stats.get("kv_tier_disk_hits", 0)
            )
            t_total = t_hits + int(stats.get("kv_tier_misses", 0))
            point["kv_tier_host_bytes"] = int(stats.get("kv_tier_host_bytes", 0))
            point["kv_tier_hit_rate"] = (
                round(t_hits / t_total, 4) if t_total else 0.0
            )
        point["saturation"] = saturation_score(point)
        return self.sample(point)

    # ---- serving ----------------------------------------------------------

    def points(self, window_s: float = 0.0) -> List[Dict[str, Any]]:
        with self._lock:
            pts = list(self._ring)
        if window_s > 0.0:
            floor = self._clock() - window_s
            pts = [p for p in pts if float(p.get("t", 0.0)) >= floor]
        return pts

    def snapshot(self, window_s: float = 0.0) -> Dict[str, Any]:
        """The versioned per-replica payload ``GET /debug/telemetry``
        serves and the fleet aggregator polls."""
        pts = self.points(window_s)
        latest = pts[-1] if pts else {}
        return {
            "schema_version": TELEMETRY_SCHEMA_VERSION,
            "replica_id": self.replica_id,
            "t": self._clock(),
            "window_s": window_s,
            "capacity": self.capacity,
            "points": pts,
            "latest": latest,
        }
