"""End-to-end request deadlines and priorities, and the adapter carrier.

The port's counterpart of ``seldon_core_tpu/utils/deadlines.py``, same
names and rules.  One **end-to-end budget** rides with the request:

* it is minted at ingress from the ``X-Seldon-Deadline-Ms`` header, the
  same key as gRPC metadata, or the caller's native gRPC deadline
  (whichever is tighter);
* in-process it rides a contextvar like the tracing span
  (``run_dispatch`` copies contextvars onto the pool thread; the sync
  gRPC bridge re-activates it inside its coroutine);
* every ``NodeClient`` re-injects the *remaining* budget downstream (the
  context stores an absolute expiry, so wall time decrements it) and
  fast-fails with ``DEADLINE_EXCEEDED`` before a hop whose budget is
  spent.

``X-Seldon-Priority`` lands in ``meta.tags.priority`` (clamped: the wire
is unauthenticated), and ``X-Seldon-Adapter`` names the LoRA weight set
a generation request decodes with; header and body tag normalise
through one rule.  The paged generation engine admits, sheds, expires
and preempts by them (``StreamingLM._slo_terms``).

A request with no deadline behaves as before: every helper is a no-op
returning ``None`` when nothing is active, so the default path costs one
contextvar read.
"""

from __future__ import annotations

import contextvars
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

DEADLINE_HEADER = "x-seldon-deadline-ms"
PRIORITY_HEADER = "x-seldon-priority"
# per-request LoRA adapter selection: every ingress that extracts a
# priority extracts this with the same carrier helper
ADAPTER_HEADER = "x-seldon-adapter"

# ceiling on an accepted budget: a header claiming days is a client bug
# (or an attack on the queue) — clamp instead of trusting it
MAX_DEADLINE_MS = 24 * 3600 * 1000.0

# priority band accepted from the wire: both headers and tags are
# unauthenticated, and priority is a shed/preempt weapon — an external
# INT_MAX must not let one tenant evict everyone else's in-flight work.
# Convention: 0 batch, 1 standard, 2+ interactive.
MAX_PRIORITY = 15


def clamp_priority(value: int) -> int:
    return max(-MAX_PRIORITY, min(MAX_PRIORITY, int(value)))

_current_deadline: "contextvars.ContextVar[Optional[Deadline]]" = (
    contextvars.ContextVar("seldon_tpu_deadline", default=None)
)


@dataclass(frozen=True)
class Deadline:
    """An absolute expiry on the monotonic clock.  Absolute, not a
    duration: every holder that reads it later sees a smaller remaining
    budget, which is the per-hop decrement."""

    expires_at: float  # time.monotonic() seconds

    @classmethod
    def after_ms(cls, ms: float) -> "Deadline":
        return cls(expires_at=time.monotonic() + min(float(ms), MAX_DEADLINE_MS) / 1000.0)

    def remaining_s(self) -> float:
        return self.expires_at - time.monotonic()

    def remaining_ms(self) -> float:
        return self.remaining_s() * 1000.0

    @property
    def expired(self) -> bool:
        return self.remaining_s() <= 0.0


def current_deadline() -> Optional[Deadline]:
    """The ambient deadline of the calling task/thread, if any."""
    return _current_deadline.get()


def _carrier_get(carrier: Any, key: str) -> Optional[str]:
    """Case-insensitive lookup over dicts, header multidicts, and
    (key, value) tuple lists (same contract as tracing's extractor)."""
    if carrier is None:
        return None
    getter = getattr(carrier, "get", None)
    if getter is not None:
        val = getter(key)
        if val is None:
            val = getter(key.title())  # plain dicts with X-Seldon-Deadline-Ms
        if val is not None:
            return str(val)
    try:
        items = carrier.items() if hasattr(carrier, "items") else carrier
        for k, v in items:
            if str(k).lower() == key:
                return str(v)
    except (TypeError, ValueError):
        return None
    return None


def extract_ms(carrier: Any) -> Optional[float]:
    """The remaining-budget milliseconds declared by a carrier (HTTP
    headers, gRPC metadata tuples), or None.  Malformed values are
    ignored, never raised — a bad header must not fail the request."""
    raw = _carrier_get(carrier, DEADLINE_HEADER)
    if raw is None:
        return None
    try:
        ms = float(raw)
    except (TypeError, ValueError):
        return None
    if ms != ms or ms == float("inf"):  # NaN / inf
        return None
    return max(0.0, min(ms, MAX_DEADLINE_MS))


def extract_priority(carrier: Any) -> Optional[int]:
    """The integer priority declared by a carrier, or None (malformed
    values ignored).  Higher = more important; the engine's admission
    and shedding order both key on it.  Clamped to ±``MAX_PRIORITY`` —
    the wire is unauthenticated."""
    raw = _carrier_get(carrier, PRIORITY_HEADER)
    if raw is None:
        return None
    try:
        return clamp_priority(int(float(raw)))
    except (TypeError, ValueError):
        return None


def normalize_adapter(raw: Any) -> Optional[str]:
    """ONE normalization rule for adapter names from any carrier
    (header, gRPC metadata, body tag): strip, empty -> None, clamp to
    256 chars — the name keys registry and engine tables, and an
    unauthenticated wire must not grow them with megabyte keys.  Header
    and tag extraction both delegate here, so the two carriers can
    never normalize the same adapter to different table keys."""
    if raw is None:
        return None
    raw = str(raw).strip()
    return raw[:256] if raw else None


def extract_adapter(carrier: Any) -> Optional[str]:
    """The adapter name declared by a carrier (``X-Seldon-Adapter``
    header / gRPC metadata), or None."""
    return normalize_adapter(_carrier_get(carrier, ADAPTER_HEADER))


@contextmanager
def activate(deadline: Optional[Deadline]):
    """Make ``deadline`` the ambient budget for the enclosed scope.
    ``None`` is a no-op so call sites don't branch.  When a (tighter)
    deadline is already active, the minimum wins — a downstream hop can
    shrink the budget, never extend it."""
    if deadline is None:
        yield None
        return
    enclosing = _current_deadline.get()
    if enclosing is not None and enclosing.expires_at <= deadline.expires_at:
        yield enclosing
        return
    token = _current_deadline.set(deadline)
    try:
        yield deadline
    finally:
        _current_deadline.reset(token)


@contextmanager
def activate_ms(ms: Optional[float]):
    """``activate`` from a remaining-milliseconds budget (the carrier
    form); ``None`` is a no-op."""
    if ms is None:
        yield None
        return
    with activate(Deadline.after_ms(ms)) as d:
        yield d


def inject(headers: Dict[str, str]) -> Dict[str, str]:
    """Write the remaining budget into a mutable header mapping (the
    REST hop carrier).  Floor-clamped at 0 so an expired budget still
    propagates as expired rather than disappearing."""
    d = _current_deadline.get()
    if d is not None:
        headers["X-Seldon-Deadline-Ms"] = str(max(0, int(d.remaining_ms())))
    return headers


def inject_metadata(
    metadata: Optional[List[Tuple[str, str]]] = None,
) -> List[Tuple[str, str]]:
    """gRPC flavour of ``inject``: (key, value) tuples."""
    md = list(metadata or [])
    d = _current_deadline.get()
    if d is not None:
        md.append((DEADLINE_HEADER, str(max(0, int(d.remaining_ms())))))
    return md


def deadline_exceeded(hop: str):
    """The canonical error for a spent budget: 504 with the exhausted
    hop named, so a multi-hop trace pinpoints where the budget died."""
    from seldon_core_tpu_torch.runtime.component import MicroserviceError

    return MicroserviceError(
        f"deadline exceeded before {hop}: end-to-end budget spent",
        status_code=504,
        reason="DEADLINE_EXCEEDED",
    )


def check(hop: str) -> None:
    """Fast-fail when the ambient budget is spent: raises the
    ``DEADLINE_EXCEEDED`` ``MicroserviceError`` naming ``hop`` (no-op
    with no active deadline — one contextvar read)."""
    d = _current_deadline.get()
    if d is not None and d.expired:
        raise deadline_exceeded(hop)
