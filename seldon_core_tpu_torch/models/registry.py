"""Device-wide weight registry: budgeted hot-load/unload of named weight sets.

The port's counterpart of ``seldon_core_tpu/models/registry.py``.  A
named set (a LoRA adapter's factors, or a base model's parameters) is
loaded on first :meth:`WeightRegistry.acquire`, refcounted while anything
serves from it, and parked on an LRU when the last pin drops — still
materialised, reclaimed only when loading something else needs the
bytes.  A warm registry therefore costs capacity (reclaimable on
demand), never admission headroom.

Entries are loader-based — ``register`` declares how to materialise a
set, nothing loads until someone asks — so many adapters can be
registered against a budget that holds a few.  The state machine per
entry::

    registered --acquire--> resident (refcount >= 1)
    resident --release-->  cached  (refcount 0, LRU, reclaimable)
    cached --acquire-->    resident        (a hit: no load)
    cached --pressure-->   registered      (evicted: bytes freed)

The process-global registry (:func:`get_registry`) is what
``StreamingLM`` adapters share; its budget comes from
``SELDON_TPU_WEIGHT_BUDGET_GIB`` (0 = unbudgeted: loads never fail on
capacity).
"""

from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional

from seldon_core_tpu_torch.runtime import knobs as _knobs
from seldon_core_tpu_torch.runtime.component import MicroserviceError

logger = logging.getLogger(__name__)

__all__ = ["WeightRegistry", "WeightEntry", "get_registry"]


def _tree_bytes(value: Any) -> int:
    """Bytes a materialised weight set occupies: the sum of its array
    leaves (numpy arrays or tensors) through dicts, lists and tuples."""
    if isinstance(value, dict):
        return sum(_tree_bytes(v) for v in value.values())
    if isinstance(value, (list, tuple)):
        return sum(_tree_bytes(v) for v in value)
    nbytes = getattr(value, "nbytes", None)
    return int(nbytes or 0)


class WeightEntry:
    """One named weight set: loader + residency state."""

    __slots__ = ("name", "kind", "loader", "bytes_hint", "value", "bytes",
                 "refcount", "loads", "last_used")

    def __init__(self, name: str, kind: str, loader: Callable[[], Any],
                 bytes_hint: Optional[int]):
        self.name = name
        self.kind = kind
        self.loader = loader
        self.bytes_hint = bytes_hint
        self.value: Any = None
        self.bytes = 0
        self.refcount = 0
        self.loads = 0
        self.last_used = 0.0

    @property
    def resident(self) -> bool:
        return self.value is not None


class WeightRegistry:
    """Budgeted refcounted registry of named weight sets.

    ``budget_bytes=0`` disables the budget (loads always succeed);
    otherwise an :meth:`acquire` that cannot fit even after evicting
    every cached (refcount-0) set fails with 503 ``WEIGHTS_BUDGET`` —
    capacity is a serving error the caller can shed or route on, never a
    crash.  All methods are thread-safe; loaders run under the lock
    (loads are the cold path — concurrent acquires of one name must not
    double-load)."""

    def __init__(self, budget_bytes: int = 0, name: str = "default"):
        self.name = name
        self.budget_bytes = max(0, int(budget_bytes))
        self._lock = threading.RLock()
        self._entries: Dict[str, WeightEntry] = {}
        # refcount-0 resident entries, oldest-released first: the reclaim order
        self._lru: "OrderedDict[str, WeightEntry]" = OrderedDict()
        self._counters = {"loads": 0, "evictions": 0, "hits": 0, "misses": 0}

    # ---- declaration ------------------------------------------------------

    def register(
        self,
        name: str,
        loader: Callable[[], Any],
        *,
        kind: str = "adapter",
        bytes_hint: Optional[int] = None,
    ) -> None:
        """Declare how ``name`` materialises.  Idempotent for the same
        name (the loader is replaced only while nothing is resident —
        swapping weights under a live pin would serve two versions)."""
        with self._lock:
            cur = self._entries.get(name)
            if cur is not None and cur.resident:
                return
            self._entries[name] = WeightEntry(name, kind, loader, bytes_hint)

    def unregister(self, name: str) -> None:
        with self._lock:
            e = self._entries.get(name)
            if e is None:
                return
            if e.refcount > 0:
                raise MicroserviceError(
                    f"weight set {name!r} is pinned by {e.refcount} user(s)",
                    status_code=409, reason="WEIGHTS_IN_USE",
                )
            self._lru.pop(name, None)
            del self._entries[name]

    def known(self, name: str) -> bool:
        with self._lock:
            return name in self._entries

    # ---- residency --------------------------------------------------------

    def _resident_bytes_locked(self) -> int:
        return sum(e.bytes for e in self._entries.values() if e.resident)

    def _evict_for_locked(self, need: int) -> None:
        """Reclaim cached sets (oldest first) until ``need`` more bytes
        fit the budget; raises 503 when pinned sets alone exceed it."""
        if not self.budget_bytes:
            return
        while self._resident_bytes_locked() + need > self.budget_bytes:
            if not self._lru:
                raise MicroserviceError(
                    f"weight budget exhausted: {need} bytes requested, "
                    f"{self._resident_bytes_locked()} of "
                    f"{self.budget_bytes} resident and every resident set "
                    "is pinned",
                    status_code=503, reason="WEIGHTS_BUDGET",
                )
            victim_name, victim = self._lru.popitem(last=False)
            victim.value = None
            victim.bytes = 0
            self._counters["evictions"] += 1
            logger.info("weight registry evicted cached set %r", victim_name)

    def acquire(self, name: str) -> Any:
        """Pin ``name`` and return its materialised weights, loading
        (and LRU-reclaiming) as needed.  Every acquire needs a matching
        :meth:`release`."""
        with self._lock:
            e = self._entries.get(name)
            if e is None:
                raise MicroserviceError(
                    f"unknown weight set {name!r} (not registered)",
                    status_code=404, reason="WEIGHTS_UNKNOWN",
                )
            if e.resident:
                self._counters["hits"] += 1
            else:
                self._counters["misses"] += 1
                need = e.bytes_hint
                if need is not None:
                    self._evict_for_locked(int(need))
                value = e.loader()
                e.bytes = _tree_bytes(value)
                if need is None:
                    # sized only after the load: reclaim post-hoc so the
                    # budget still holds (the freshly loaded set is
                    # pinned below and cannot evict itself)
                    e.value = value
                    e.refcount += 1
                    try:
                        self._evict_for_locked(0)
                    except MicroserviceError:
                        e.refcount -= 1
                        e.value = None
                        e.bytes = 0
                        raise
                    e.refcount -= 1
                else:
                    e.value = value
                e.loads += 1
                self._counters["loads"] += 1
            self._lru.pop(name, None)
            e.refcount += 1
            e.last_used = time.monotonic()
            return e.value

    def release(self, name: str) -> None:
        """Drop one pin; the last release parks the set on the cached
        LRU (capacity, not cost — reclaimed only under budget
        pressure)."""
        with self._lock:
            e = self._entries.get(name)
            if e is None or e.refcount <= 0:
                return
            e.refcount -= 1
            e.last_used = time.monotonic()
            if e.refcount == 0 and e.resident:
                self._lru[name] = e

    # ---- observability ----------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        """Per-entry residency plus the registry counters and the byte
        split between pinned and reclaimable sets."""
        with self._lock:
            entries: List[Dict[str, Any]] = []
            resident = cached = 0
            for e in sorted(self._entries.values(), key=lambda x: x.name):
                if e.resident:
                    if e.refcount > 0:
                        resident += e.bytes
                    else:
                        cached += e.bytes
                entries.append({
                    "name": e.name,
                    "kind": e.kind,
                    "resident": e.resident,
                    "pinned": e.refcount > 0,
                    "refcount": e.refcount,
                    "bytes": e.bytes,
                    "loads": e.loads,
                })
            return {
                "registry": self.name,
                "budget_bytes": self.budget_bytes,
                "resident_bytes": resident,
                "reclaimable_weight_bytes": cached,
                "entries": entries,
                **self._counters,
            }


# ---------------------------------------------------------------------------
# process-global registry (StreamingLM adapters)
# ---------------------------------------------------------------------------

_GLOBAL: Optional[WeightRegistry] = None
_GLOBAL_LOCK = threading.Lock()


def get_registry() -> WeightRegistry:
    """The process-global registry, budgeted by
    ``SELDON_TPU_WEIGHT_BUDGET_GIB`` at first use (0/unset = no
    budget)."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            gib = float(_knobs.raw("SELDON_TPU_WEIGHT_BUDGET_GIB", "0") or 0)
            _GLOBAL = WeightRegistry(budget_bytes=int(gib * (1 << 30)), name="process")
        return _GLOBAL
