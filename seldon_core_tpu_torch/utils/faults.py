"""Env-driven fault injection for chaos testing (the port's copy of
``seldon_core_tpu/utils/faults.py``: the same spec grammar, points and
API, so one ``SELDON_TPU_FAULT`` spec arms either package).

Graceful degradation is a claim until something actually fails; this
registry lets tests (and staging operators) fail specific points on
demand and assert the invariants that matter: no stuck streams, the
paged allocator audit stays clean, the queue drains, ``fail_all`` is
never needed.

Spec grammar (``SELDON_TPU_FAULT`` or :func:`configure`)::

    SELDON_TPU_FAULT="point[:k=v[,k=v...]][;point2[:...]]"

    SELDON_TPU_FAULT="paged.alloc:times=3"
    SELDON_TPU_FAULT="transport.drop:times=2;transport.delay:ms=50"
    SELDON_TPU_FAULT="paged.chunk:prob=0.1,times=5"

Parameters per point: ``times`` (how many firings before the point
disarms; default 1; ``times=inf`` never disarms), ``prob`` (firing
probability per evaluation, default 1.0), ``ms`` (delay milliseconds,
for delay-style points), ``k`` (byte/lane count for corruption-style
points, default 1).

Registered injection points:

* ``paged.alloc`` — ``PagedEngine._alloc_locked`` returns None (allocator
  exhaustion): exercises the stall/evict/rollback machinery.
* ``paged.chunk`` — the decode/verify chunk raises *before* the device
  call is issued (buffers stay valid): exercises the engine's
  fail-only-this-chunk degradation instead of ``fail_all``.
* ``transport.delay`` — ``engine/transport.py``'s REST/gRPC attempts
  sleep ``ms`` first: exercises deadline fast-fail and retry pacing.
* ``transport.drop`` — REST/gRPC node-client attempts raise a transient
  connection error (gRPC-shaped: carries an UNAVAILABLE status so the
  retry classifier treats it exactly like a dead upstream).
* ``transport.slow`` — a SECOND, independent latency point with the
  same semantics as ``transport.delay``.  Exists so straggler chaos
  (hedging, breaker-vs-tail tests) can be armed *simultaneously* with
  a drop or deadline fault at its own times/prob budget: a straggler
  is latency without an error, and sharing ``transport.delay``'s one
  budget would make the two scenarios indistinguishable.
* ``paged.nan`` — NaN is injected into ONE runnable lane's served
  logits after a DECODE chunk: exercises the poison-stream quarantine
  (the NaN guard must retire only that stream with 500 NUMERIC_POISON
  while its wave-mates stay bit-identical).  Decode lane only: the
  speculative verify program emits argmax token ids — its logits never
  reach the host, so neither the screen nor this point applies there.
* ``transport.corrupt`` — ``k`` bytes of a KV migration container are
  flipped before unpack at ``StreamingLM``'s migration ingress
  (:func:`corrupt_bytes`): exercises the CRC32C integrity trailer's
  named rejection.

Everything is a no-op (one module-level bool read) when no fault is
configured — serving never pays for the harness.
"""

from __future__ import annotations

import logging
import os
import random
import threading
from typing import Dict, Optional

logger = logging.getLogger(__name__)

ENV_VAR = "SELDON_TPU_FAULT"

KNOWN_POINTS = (
    "paged.alloc",
    "paged.chunk",
    "paged.nan",
    "transport.delay",
    "transport.drop",
    "transport.slow",
    "transport.corrupt",
)


class _Code:
    """Minimal grpc-status-code stand-in (``.name`` is all the retry
    classifier reads)."""

    def __init__(self, name: str):
        self.name = name


class InjectedFault(ConnectionError):
    """Raised by raising points.  Subclasses ConnectionError so generic
    transport retry loops classify it as transient; ``code()`` makes the
    gRPC classifier read it as UNAVAILABLE."""

    def __init__(self, point: str, status: str = "UNAVAILABLE"):
        super().__init__(f"injected fault at {point}")
        self.point = point
        self._status = status

    def code(self):
        return _Code(self._status)


class _Fault:
    __slots__ = ("point", "times", "prob", "delay_ms", "k", "fired")

    def __init__(self, point: str, times: float = 1, prob: float = 1.0,
                 delay_ms: float = 0.0, k: int = 1):
        self.point = point
        self.times = times  # remaining firings (float to admit inf)
        self.prob = float(prob)
        self.delay_ms = float(delay_ms)
        self.k = int(k)  # corruption-style points: bytes/lanes touched
        self.fired = 0


_lock = threading.Lock()
_faults: Dict[str, _Fault] = {}
_enabled = False  # hot-path guard: one module attribute read when off
_fired_total: Dict[str, int] = {}


def _parse(spec: str) -> Dict[str, _Fault]:
    """Strict spec-grammar parse: every malformation raises ValueError
    naming the offending fragment.  A chaos harness that silently
    no-ops on a typo'd spec certifies resilience it never exercised —
    loud failure IS the feature (the negative-grammar tests pin each
    case)."""
    out: Dict[str, _Fault] = {}
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        point, _, params = part.partition(":")
        point = point.strip()
        if point not in KNOWN_POINTS:
            raise ValueError(
                f"unknown fault point {point!r}: known points are "
                f"{', '.join(KNOWN_POINTS)}"
            )
        if point in out:
            raise ValueError(
                f"duplicate fault point {point!r} in spec {spec!r}: each "
                "point carries ONE times/prob/ms budget"
            )
        kwargs: Dict[str, float] = {}
        for kv in params.split(","):
            kv = kv.strip()
            if not kv:
                continue
            k, sep, v = kv.partition("=")
            k, v = k.strip(), v.strip()
            if not sep or not v:
                raise ValueError(
                    f"malformed fault parameter {kv!r} for point "
                    f"{point!r}: expected k=v (supported: times, prob, ms, k)"
                )
            try:
                if k == "times":
                    kwargs["times"] = (
                        float("inf") if v == "inf" else int(v)
                    )
                elif k == "prob":
                    kwargs["prob"] = float(v)
                elif k == "ms":
                    kwargs["delay_ms"] = float(v)
                elif k == "k":
                    kwargs["k"] = int(v)
                else:
                    raise ValueError(
                        f"unknown fault parameter {k!r} for point {point!r} "
                        "(supported: times, prob, ms, k)"
                    )
            except ValueError as e:
                if "fault parameter" in str(e):
                    raise
                raise ValueError(
                    f"bad value in fault parameter {kv!r} for point "
                    f"{point!r}: {e}"
                ) from e
        if kwargs.get("times", 1) < 0:
            raise ValueError(f"fault point {point!r}: times must be >= 0")
        if not 0.0 <= kwargs.get("prob", 1.0) <= 1.0:
            raise ValueError(f"fault point {point!r}: prob must be in [0, 1]")
        if kwargs.get("delay_ms", 0.0) < 0:
            raise ValueError(f"fault point {point!r}: ms must be >= 0")
        if kwargs.get("k", 1) < 1:
            raise ValueError(f"fault point {point!r}: k must be >= 1")
        out[point] = _Fault(point, **kwargs)
    return out


def configure(spec: Optional[str] = None) -> None:
    """(Re)build the registry from ``spec`` (default: the env var).
    An empty/absent spec clears everything."""
    global _enabled
    if spec is None:
        from seldon_core_tpu_torch.runtime import knobs

        spec = knobs.raw(ENV_VAR, "") or ""
    # "=0 spells OFF" contract (runtime/knobs.py): SELDON_TPU_FAULT=0
    # disarms, matching every other zero-off knob, instead of parsing
    # "0" as a (nonexistent) point name
    faults = _parse(spec) if spec and spec.strip() != "0" else {}
    with _lock:
        _faults.clear()
        _faults.update(faults)
        _enabled = bool(_faults)
    if faults:
        logger.warning(
            "fault injection ARMED: %s",
            ", ".join(f"{f.point}(times={f.times}, prob={f.prob})"
                      for f in faults.values()),
        )


def clear() -> None:
    """Disarm every point (the firing stats survive)."""
    global _enabled
    with _lock:
        _faults.clear()
        _enabled = False


def fire(point: str) -> bool:
    """True when ``point`` should fail NOW (decrements its budget)."""
    if not _enabled:
        return False
    with _lock:
        f = _faults.get(point)
        if f is None or f.times <= 0:
            return False
        if f.prob < 1.0 and random.random() >= f.prob:
            return False
        f.times -= 1
        f.fired += 1
        _fired_total[point] = _fired_total.get(point, 0) + 1
        return True


def raise_if(point: str) -> None:
    """Raise :class:`InjectedFault` when ``point`` fires."""
    if _enabled and fire(point):
        raise InjectedFault(point)


def delay_s(point: str) -> float:
    """The injected delay (seconds) when ``point`` fires, else 0.0."""
    if not _enabled:
        return 0.0
    with _lock:
        f = _faults.get(point)
        if f is None or f.times <= 0 or f.delay_ms <= 0:
            return 0.0
        if f.prob < 1.0 and random.random() >= f.prob:
            return 0.0
        f.times -= 1
        f.fired += 1
        _fired_total[point] = _fired_total.get(point, 0) + 1
        return f.delay_ms / 1000.0


def fire_k(point: str) -> int:
    """``point``'s ``k`` budget when it fires NOW (decrementing its
    times budget), else 0 — the corruption-style twin of :func:`fire`."""
    if not _enabled:
        return 0
    with _lock:
        f = _faults.get(point)
        if f is None or f.times <= 0:
            return 0
        if f.prob < 1.0 and random.random() >= f.prob:
            return 0
        f.times -= 1
        f.fired += 1
        _fired_total[point] = _fired_total.get(point, 0) + 1
        return max(1, f.k)


def corrupt_bytes(point: str, data: bytes) -> bytes:
    """Flip ``k`` random bytes of ``data`` when ``point`` fires (the
    ``transport.corrupt`` chaos: a DCN bit-flip on a KV container must
    reject as a named PayloadError, never scatter as garbage KV).
    Returns ``data`` unchanged when the point is disarmed."""
    k = fire_k(point)
    if not k or not data:
        return data
    out = bytearray(data)
    for _ in range(min(k, len(out))):
        i = random.randrange(len(out))
        out[i] ^= 0xFF
    logger.warning("injected %s: flipped %d byte(s) of a %d-byte payload",
                   point, min(k, len(out)), len(out))
    return bytes(out)


def enabled() -> bool:
    return _enabled


def stats() -> Dict[str, int]:
    """Total firings per point since process start (chaos tests assert
    the injection actually happened — a vacuously green test is worse
    than none)."""
    with _lock:
        return dict(_fired_total)


# arm from the environment at import so worker processes spawned with
# SELDON_TPU_FAULT set participate without extra wiring.  A malformed
# spec is logged LOUDLY but does not kill the process at import: the
# chaos tests assert firing stats, so an unarmed harness cannot pass
# silently, while a serving process never dies to a chaos-spec typo.
if os.environ.get(ENV_VAR):  # the cheap "is it set at all" probe; configure() reads through the registry
    try:
        configure()
    except ValueError:
        logger.exception("invalid %s spec — fault injection NOT armed", ENV_VAR)
