"""Device-health watchdog for the generation engine (the port's copy of
``seldon_core_tpu/utils/watchdog.py``: the same state machine,
thresholds, knobs and ``stats()``).

An engine rarely dies cleanly; it *degrades*: chunk wall times creep (a
throttled card, a neighbour hogging memory bandwidth), chunk signatures
keep arriving new under a shape leak, the page allocator pins at the
ceiling, or chunk faults start landing.  The drain path fires only once
the process is already exiting; this watchdog watches the live signals
every wave and drives an explicit health state machine the evacuation
layer reads before the engine falls over:

    healthy -> degraded -> evacuating

* **healthy**: nothing notable in the sliding window.
* **degraded**: the window crossed a threshold: chunk-wall breaches
  (``SELDON_TPU_WATCHDOG_CHUNK_MS``), chunk-fault rate
  (``SELDON_TPU_WATCHDOG_FAULT_RATE``), a compile storm
  (``SELDON_TPU_WATCHDOG_COMPILES``) or sustained allocator pressure
  (``SELDON_TPU_WATCHDOG_HBM_PCT``).  A clean window recovers the state
  to healthy: degradation is a diagnosis, not a ratchet.
* **evacuating**: degradation persisted for a full second window, or
  the operator forced it (``SELDON_TPU_FORCE_EVACUATE``).
  ``models/disagg.evacuate_streams`` skips such a peer and moves the
  engine's streams off it; evacuating never self-recovers: only an
  operator clearing the force knob on a forced engine, or a respawn,
  resets it.

**Compile exemption** (the false-positive guard): the first wave of a
cold engine pays seconds of one-time work (a first-use ``nvcc`` build of
a kernel, first calls of a shape) and would trip any honest wall-time
ceiling.  A wave counts as ``compiled`` when it ran a chunk signature
the engine had not run before or when ``ops/_build.py`` built or loaded
a kernel library during it (the port's counterpart of the JAX engine's
jit sentinels); such waves are exempt from the chunk-wall ceiling and
priced by the compile-storm signal instead, which counts events, not
wall time, and fires only above an explicit threshold.  A cold engine
can never enter ``degraded`` from its first waves alone.

The watchdog is host bookkeeping: one deque append and a few compares a
wave, no device work, no lock of its own (the engine feeds it from the
thread that steps it).  ``SELDON_TPU_WATCHDOG=0`` disables it (the
engine then always reports ``healthy``).
"""

from __future__ import annotations

import logging
from collections import deque
from typing import Any, Deque, Dict, Optional, Tuple

logger = logging.getLogger(__name__)

HEALTHY = "healthy"
DEGRADED = "degraded"
EVACUATING = "evacuating"

STATES = (HEALTHY, DEGRADED, EVACUATING)

# numeric export of the state machine (prometheus gauges carry floats):
# 0 = healthy, 1 = degraded, 2 = evacuating
STATE_CODES = {HEALTHY: 0, DEGRADED: 1, EVACUATING: 2}


def watchdog_enabled() -> bool:
    from seldon_core_tpu_torch.runtime import knobs

    return knobs.flag("SELDON_TPU_WATCHDOG")


def force_evacuate() -> bool:
    """The operator's forced-migration switch (default off)."""
    from seldon_core_tpu_torch.runtime import knobs

    return knobs.flag("SELDON_TPU_FORCE_EVACUATE")


def _env_float(name: str, default: float) -> float:
    from seldon_core_tpu_torch.runtime import knobs

    raw = knobs.raw(name, "")
    try:
        return float(raw) if raw else default
    except ValueError:
        logger.warning("%s=%r is not a number; using %s", name, raw, default)
        return default


class EngineWatchdog:
    """Sliding-window health classifier over per-wave engine signals.

    ``observe()`` is called once per engine wave with that wave's wall
    time, whether it was a compile wave (a first-seen chunk signature or
    a kernel build/load), whether it faulted, the allocator occupancy,
    and the wave's count of such compile events.
    Returns the current state string.  Thresholds default from the
    ``SELDON_TPU_WATCHDOG_*`` knobs; constructor arguments win (tests
    and embedded engines configure explicitly).
    """

    def __init__(
        self,
        *,
        chunk_ms_ceiling: Optional[float] = None,
        fault_rate: Optional[float] = None,
        compile_storm: Optional[int] = None,
        hbm_pct: Optional[float] = None,
        window: Optional[int] = None,
        breaches: Optional[int] = None,
    ):
        from seldon_core_tpu_torch.runtime import knobs

        self.chunk_ms_ceiling = (
            chunk_ms_ceiling if chunk_ms_ceiling is not None
            else _env_float("SELDON_TPU_WATCHDOG_CHUNK_MS", 0.0)
        )
        self.fault_rate = (
            fault_rate if fault_rate is not None
            else _env_float("SELDON_TPU_WATCHDOG_FAULT_RATE", 0.5)
        )
        self.compile_storm = int(
            compile_storm if compile_storm is not None
            else int(knobs.raw("SELDON_TPU_WATCHDOG_COMPILES", "0") or 0)
        )
        self.hbm_pct = (
            hbm_pct if hbm_pct is not None
            else _env_float("SELDON_TPU_WATCHDOG_HBM_PCT", 0.0)
        )
        self.window = max(2, int(
            window if window is not None
            else int(knobs.raw("SELDON_TPU_WATCHDOG_WINDOW", "32") or 32)
        ))
        self.breaches = max(1, int(
            breaches if breaches is not None
            else int(knobs.raw("SELDON_TPU_WATCHDOG_BREACHES", "8") or 8)
        ))
        # per-wave records: (wall_breach, fault, compiled, pressure)
        self._waves: Deque[Tuple[bool, bool, bool, bool]] = deque(
            maxlen=self.window
        )
        self._compiles: Deque[int] = deque(maxlen=self.window)
        self.state = HEALTHY
        self.trips = 0  # healthy -> degraded transitions
        self._degraded_waves = 0  # consecutive waves spent degraded
        self._forced = False  # evacuating BY the force knob (clearable)
        self._reasons: Deque[str] = deque(maxlen=4)

    # ---- feed --------------------------------------------------------------

    def observe(
        self,
        *,
        wall_ms: float,
        compiled: bool = False,
        fault: bool = False,
        pool_used_pct: float = 0.0,
        compiles_delta: int = 0,
    ) -> str:
        """Record one engine wave and return the (possibly new) state."""
        if force_evacuate():
            if self.state != EVACUATING:
                # only a force that CAUSED the transition is clearable:
                # setting the knob on an already-organically-evacuating
                # engine must not make knob churn resurrect it
                self._transition(EVACUATING, "operator force "
                                 "(SELDON_TPU_FORCE_EVACUATE)")
                self._forced = True
            return self.state
        if self._forced and self.state == EVACUATING:
            # the operator cleared the force knob on a FORCED engine:
            # step back to degraded and let the ordinary window
            # classification decide recovery — organically-evacuating
            # engines (degradation persisted a full window) stay
            # terminal until respawn
            self._forced = False
            self._transition(DEGRADED, "operator cleared "
                             "SELDON_TPU_FORCE_EVACUATE")
            self._degraded_waves = 0
        # compile exemption: a wave that paid a first-seen signature or a
        # kernel build is judged only by the compile-storm signal, never
        # the wall ceiling: cold-start work is not device sickness
        wall_breach = (
            self.chunk_ms_ceiling > 0
            and not compiled
            and wall_ms > self.chunk_ms_ceiling
        )
        pressure = (
            self.hbm_pct > 0 and pool_used_pct >= self.hbm_pct
        )
        self._waves.append((wall_breach, fault, compiled, pressure))
        self._compiles.append(int(compiles_delta))
        self._classify()
        return self.state

    # ---- state machine -----------------------------------------------------

    def _window_signals(self) -> Dict[str, Any]:
        n = max(1, len(self._waves))
        walls = sum(1 for w in self._waves if w[0])
        faults = sum(1 for w in self._waves if w[1])
        pressures = sum(1 for w in self._waves if w[3])
        compiles = sum(self._compiles)
        return {
            "waves": len(self._waves),
            "wall_breaches": walls,
            "faults": faults,
            "fault_rate": faults / n,
            "pressure_waves": pressures,
            "window_compiles": compiles,
        }

    def _breach_reason(self) -> Optional[str]:
        s = self._window_signals()
        if s["wall_breaches"] >= self.breaches:
            return (f"chunk wall over {self.chunk_ms_ceiling:.0f} ms on "
                    f"{s['wall_breaches']}/{s['waves']} waves")
        if (
            len(self._waves) >= min(self.window, 2 * self.breaches)
            and s["fault_rate"] >= self.fault_rate
            and s["faults"] > 0
        ):
            return (f"chunk-fault rate {s['fault_rate']:.2f} >= "
                    f"{self.fault_rate:.2f}")
        if self.compile_storm > 0 and s["window_compiles"] >= self.compile_storm:
            return (f"jit compile storm: {s['window_compiles']} compiles "
                    f"in a {s['waves']}-wave window")
        if self.hbm_pct > 0 and s["pressure_waves"] >= self.breaches:
            return (f"allocator pressure >= {self.hbm_pct:.0f}% on "
                    f"{s['pressure_waves']}/{s['waves']} waves")
        return None

    def _transition(self, state: str, reason: str) -> None:
        logger.warning(
            "engine watchdog: %s -> %s (%s)", self.state, state, reason
        )
        if state == DEGRADED and self.state == HEALTHY:
            self.trips += 1
        self.state = state
        self._reasons.append(f"{state}: {reason}")

    def _classify(self) -> None:
        if self.state == EVACUATING:
            return  # terminal short of a respawn / force-clear
        reason = self._breach_reason()
        if self.state == HEALTHY:
            if reason is not None:
                self._transition(DEGRADED, reason)
                self._degraded_waves = 0
            return
        # degraded: recover after a clean window, escalate after a
        # persistently bad second window
        if reason is None:
            self._degraded_waves = 0
            if len(self._waves) == self._waves.maxlen:
                self._transition(HEALTHY, "window clean")
            return
        self._degraded_waves += 1
        if self._degraded_waves >= self.window:
            self._transition(
                EVACUATING,
                f"degraded for {self._degraded_waves} consecutive waves "
                f"({reason})",
            )

    # ---- export ------------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        """The watchdog's observability payload (engine_stats detail /
        /debug/workers)."""
        out = {
            "state": self.state,
            "state_code": STATE_CODES[self.state],
            "trips": self.trips,
            "reasons": list(self._reasons),
            "thresholds": {
                "chunk_ms_ceiling": self.chunk_ms_ceiling,
                "fault_rate": self.fault_rate,
                "compile_storm": self.compile_storm,
                "hbm_pct": self.hbm_pct,
                "window": self.window,
                "breaches": self.breaches,
            },
        }
        out.update(self._window_signals())
        return out
