"""Flight recorder for the generation engine's chunk loop (the port's
copy of ``seldon_core_tpu/utils/flightrec.py``).

The engine's cumulative counters (`engine_stats()`) answer "how much",
never "when" or "why": a p99 regression, an admission stall or a
bucket-split pathology shows up as a slightly different average long
after the incident.  The recorder keeps the last N per-chunk records in
a fixed-size ring — wall time, occupancy, bucket spec, admissions,
stalls, queue depth, tokens — written inside the chunk loop at
near-zero cost (one dict append under the engine lock the loop already
holds; no device work, no I/O on the hot path).

Post-incident forensics without a profiler attached: when a configured
p99 latency threshold is breached, the whole ring dumps to JSONL
(rate-limited by a cooldown so a sustained breach produces one file per
window, not one per chunk).  The dump is the flight-recorder idiom —
the data was already in memory when the incident happened; breach only
decides when to persist it.

Consumed by ``PagedEngine.engine_stats(detail=True)``, the gateway's
``/debug/engine`` endpoint, ``GenerationPrometheusBridge`` (the chunk
duration histogram) and the capture plane (``utils/capture.py``: the
records of a request's waves, and the breach hook).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

logger = logging.getLogger(__name__)


class FlightRecorder:
    """Fixed-size ring of per-chunk records with breach-triggered dump.

    ``record()`` is the only hot-path call: append to a bounded deque
    plus one float compare (the breach guard runs the p99 computation
    only when the NEW record already exceeds the threshold — a window
    whose p99 breaches necessarily contains such records, so quiet
    traffic never pays the percentile).
    """

    def __init__(
        self,
        capacity: int = 512,
        dump_p99_ms: float = 0.0,  # 0 = dump-on-breach off
        dump_dir: Optional[str] = None,
        dump_cooldown_s: float = 30.0,
        clock=time.time,
    ):
        self.capacity = int(capacity)
        self.dump_p99_ms = float(dump_p99_ms)
        self.dump_dir = dump_dir
        self.dump_cooldown_s = float(dump_cooldown_s)
        self._clock = clock
        self._ring: Deque[Dict[str, Any]] = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self._last_dump_s = 0.0
        # lifetime token totals, accumulated at record() time: the
        # window_* sums below cover only records still RESIDENT in the
        # ring, so once the deque wraps they plateau (each append
        # retires the head entry) and a consumer diffing successive
        # stats() snapshots silently loses the overwritten head's
        # tokens.  Totals never wrap — delta them instead.
        self._total_prefill_tokens = 0
        self._total_decode_tokens = 0
        self.dumps = 0
        self.last_dump_path: Optional[str] = None
        # breach-dump hook (r21): called OUTSIDE the ring lock with
        # (records, path) after every breach dump — the capture plane
        # indexes the offending puids here so the requests active in
        # the breach window get captured at termination instead of the
        # dump staying an anonymous ring
        self.on_dump = None

    # ---- hot path ---------------------------------------------------------

    def record(self, rec: Dict[str, Any]) -> None:
        """Append one per-chunk record (the engine supplies wall_ms and
        whatever context it has); returns fast on the quiet path."""
        with self._lock:
            self._seq += 1
            rec["seq"] = self._seq
            rec.setdefault("t", self._clock())
            self._total_prefill_tokens += int(rec.get("prefill_tokens", 0))
            self._total_decode_tokens += int(rec.get("decode_tokens", 0))
            self._ring.append(rec)
            breached = (
                self.dump_p99_ms > 0.0
                and float(rec.get("wall_ms", 0.0)) >= self.dump_p99_ms
                and self._clock() - self._last_dump_s >= self.dump_cooldown_s
                and self._p99_ms_locked() >= self.dump_p99_ms
            )
            if not breached:
                return
            self._last_dump_s = self._clock()
            snapshot = list(self._ring)
        # I/O outside the lock: a slow disk must not stall the chunk loop
        # beyond this one breach-window dump
        self._dump(snapshot)

    # ---- aggregates -------------------------------------------------------

    def _p99_ms_locked(self) -> float:
        walls = sorted(float(r.get("wall_ms", 0.0)) for r in self._ring)
        if not walls:
            return 0.0
        return walls[min(len(walls) - 1, int(0.99 * (len(walls) - 1) + 0.5))]

    def quantile_ms(self, q: float) -> float:
        with self._lock:
            walls = sorted(float(r.get("wall_ms", 0.0)) for r in self._ring)
        if not walls:
            return 0.0
        return walls[min(len(walls) - 1, int(q * (len(walls) - 1) + 0.5))]

    def snapshot(self, limit: int = 0) -> List[Dict[str, Any]]:
        """Copy of the ring, oldest first (``limit`` keeps the newest N)."""
        with self._lock:
            records = list(self._ring)
        return records[-limit:] if limit else records

    def since(self, seq: int) -> List[Dict[str, Any]]:
        """Records newer than ``seq`` — the bridge's incremental consume
        (records older than the ring has capacity for are simply gone;
        the caller's histogram misses them rather than double-counting)."""
        with self._lock:
            return [r for r in self._ring if r["seq"] > seq]

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            n = len(self._ring)
            last = self._ring[-1] if n else {}
            p99 = self._p99_ms_locked()
            # the window's prefill/decode token mix (r15): what the
            # chunked-prefill scheduler actually interleaved — the
            # /debug/engine and profile-tool chunk-mix summary
            prefill_toks = sum(
                int(r.get("prefill_tokens", 0)) for r in self._ring
            )
            decode_toks = sum(
                int(r.get("decode_tokens", 0)) for r in self._ring
            )
            total_prefill = self._total_prefill_tokens
            total_decode = self._total_decode_tokens
        return {
            "records": n,
            "seq": self._seq,
            "chunk_p99_ms": round(p99, 3),
            "last_queue_depth": int(last.get("queue_depth", 0)),
            "window_prefill_tokens": prefill_toks,
            "window_decode_tokens": decode_toks,
            # lifetime totals: unlike the window_* sums these survive
            # ring wrap, so rate consumers (the telemetry ring) can
            # delta successive snapshots without losing the head
            # records each wrap retires
            "total_prefill_tokens": total_prefill,
            "total_decode_tokens": total_decode,
            "dumps": self.dumps,
        }

    # ---- dump -------------------------------------------------------------

    def _dump(self, records: List[Dict[str, Any]]) -> None:
        try:
            path = self.dump_jsonl(records=records)
            logger.warning(
                "flight recorder: chunk p99 breached %.1f ms — dumped %d "
                "records to %s", self.dump_p99_ms, len(records), path,
            )
        except Exception:  # noqa: BLE001 — forensics must not break serving
            logger.exception("flight recorder dump failed")
            return
        hook = self.on_dump
        if hook is not None:
            try:
                hook(records, path)
            except Exception:  # noqa: BLE001 — same containment as the dump
                logger.exception("flight recorder dump hook failed")

    def dump_jsonl(
        self, path: Optional[str] = None,
        records: Optional[List[Dict[str, Any]]] = None,
    ) -> str:
        """Write the ring (or a given snapshot) as one record per line;
        returns the path written."""
        if records is None:
            records = self.snapshot()
        if path is None:
            d = self.dump_dir or "."
            os.makedirs(d, exist_ok=True)
            path = os.path.join(
                d, f"flightrec-{int(self._clock() * 1000)}.jsonl"
            )
        with open(path, "w") as f:
            for rec in records:
                f.write(json.dumps(rec) + "\n")
        self.dumps += 1
        self.last_dump_path = path
        return path
