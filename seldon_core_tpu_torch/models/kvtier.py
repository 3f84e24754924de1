"""Hierarchical KV tier: host RAM and an optional disk level below the pool.

The port's counterpart of ``seldon_core_tpu/models/kvtier.py``.  An LRU
reclaim of a prefix page in :class:`~models.paged.PagedEngine` would
discard its K/V, so a returning session re-pays its whole prefill.
With ``SELDON_TPU_KV_OFFLOAD=1`` the engine demotes the reclaimed page
here instead: a budgeted host-RAM store (``SELDON_TPU_KV_HOST_BUDGET_GIB``)
with an optional disk level below it (``SELDON_TPU_KV_SPILL_DIR`` /
``SELDON_TPU_KV_SPILL_GIB``), keyed by the engine's
``prefix_chain_key``.  A later admission whose chain walk reaches the
key promotes the page back into the pool through the page import: a
host-to-device copy in place of prefill work.

Entries are whole KV-handoff containers (``codec/bufview.py``), one page
each, carrying the page as it was resident (the engine's dtype, or int8
pages with their float32 scales).  The container's CRC32C trailer makes
the disk level self-checking: a corrupted spill file raises a named
:class:`PayloadError` at pop time instead of scattering garbage.

* **host** — an ``OrderedDict`` LRU of container blobs under a byte
  budget; overflow moves the oldest entries to disk (with a spill
  directory) or drops them (counted as evictions).
* **disk** — one container file a page, written tmp + rename, LRU-evicted
  oldest first to the spill budget.  A restarting process rescans the
  directory (oldest mtime first); a rescanned entry's tokens are checked
  against the container's own prompt frame at pop.

A key lives at exactly one level, and never beside an HBM-registered
copy: the engine discards the tier entry when it registers the key in
its prefix index, and :meth:`HostKvTier.audit` (run under
``SELDON_TPU_PAGED_DEBUG``) checks both rules and the byte accounting.

Every public method takes the tier's own lock; the engine may call it
holding its ``_lock`` (lock order engine -> tier, never the reverse).
"""

from __future__ import annotations

import logging
import os
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Set, Tuple

from seldon_core_tpu_torch.codec.bufview import unpack_kv_handoff
from seldon_core_tpu_torch.codec.tensor import PayloadError

logger = logging.getLogger(__name__)

# hash keys are signed 64-bit; filenames carry them as unsigned hex
_KEY_MASK = (1 << 64) - 1


def _key_to_hex(key: int) -> str:
    return f"{key & _KEY_MASK:016x}"


def _hex_to_key(h: str) -> int:
    u = int(h, 16)
    return u - (1 << 64) if u >= (1 << 63) else u


class _HostEntry:
    """One demoted page parked in host RAM."""

    __slots__ = ("key", "parent", "tokens", "blob", "nbytes")

    def __init__(self, key: int, parent: int, tokens: Tuple[int, ...],
                 blob: bytes):
        self.key = key
        self.parent = parent
        self.tokens = tokens
        self.blob = blob
        self.nbytes = len(blob)


class _DiskEntry:
    """One demoted page spilled to the disk level.  ``tokens`` is None
    for entries recovered by the startup rescan — the filename only
    carries key+parent, so identity completes from the container's own
    prompt frame at pop."""

    __slots__ = ("key", "parent", "tokens", "path", "nbytes")

    def __init__(self, key: int, parent: int,
                 tokens: Optional[Tuple[int, ...]], path: str, nbytes: int):
        self.key = key
        self.parent = parent
        self.tokens = tokens
        self.path = path
        self.nbytes = nbytes


class HostKvTier:
    """Budgeted host-RAM (+ optional disk) store of demoted KV pages,
    keyed by ``prefix_chain_key``."""

    def __init__(self, budget_bytes: int, spill_dir: Optional[str] = None,
                 spill_budget_bytes: int = 0):
        self._lock = threading.Lock()
        self._budget = max(0, int(budget_bytes))
        self._host: "OrderedDict[int, _HostEntry]" = OrderedDict()
        self._host_bytes = 0
        self._spill_dir = spill_dir or None
        self._spill_budget = max(0, int(spill_budget_bytes))
        # insertion order IS the disk LRU in-process; the rescan seeds
        # it oldest-mtime-first so eviction order survives a restart
        self._disk: "OrderedDict[int, _DiskEntry]" = OrderedDict()
        self._disk_bytes = 0
        self._evictions = 0
        if self._spill_dir:
            os.makedirs(self._spill_dir, exist_ok=True)
            with self._lock:
                self._rescan_spill_dir_locked()

    # ---- disk level -------------------------------------------------------

    def _spill_path(self, key: int, parent: int) -> str:
        return os.path.join(
            self._spill_dir, f"kv_{_key_to_hex(key)}_{_key_to_hex(parent)}.srt1"
        )

    def _rescan_spill_dir_locked(self) -> None:
        found: List[Tuple[float, _DiskEntry]] = []
        for name in os.listdir(self._spill_dir):
            if not (name.startswith("kv_") and name.endswith(".srt1")):
                continue
            parts = name[3:-5].split("_")
            if len(parts) != 2:
                continue
            path = os.path.join(self._spill_dir, name)
            try:
                st = os.stat(path)
                key, parent = _hex_to_key(parts[0]), _hex_to_key(parts[1])
            except (OSError, ValueError):
                continue
            found.append(
                (st.st_mtime, _DiskEntry(key, parent, None, path, st.st_size))
            )
        for _mtime, e in sorted(found, key=lambda t: t[0]):
            self._disk[e.key] = e
            self._disk_bytes += e.nbytes

    def _spill_locked(self, entry: _HostEntry) -> int:
        """Write one host-evicted entry to the disk level (atomic
        tmp+rename), then LRU-evict the disk level back under its
        budget — never the file just written.  Returns entries dropped
        from the tier entirely."""
        path = self._spill_path(entry.key, entry.parent)
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        try:
            with open(tmp, "wb") as f:
                f.write(entry.blob)
            os.replace(tmp, path)
        except OSError as exc:
            logger.warning("KV tier spill write failed (%s): %s", path, exc)
            try:
                os.unlink(tmp)
            except OSError:
                pass
            self._evictions += 1
            return 1
        old = self._disk.pop(entry.key, None)
        if old is not None:
            self._disk_bytes -= old.nbytes
        self._disk[entry.key] = _DiskEntry(
            entry.key, entry.parent, entry.tokens, path, entry.nbytes
        )
        self._disk_bytes += entry.nbytes
        dropped = 0
        while self._disk_bytes > self._spill_budget and len(self._disk) > 1:
            victim_key = next(iter(self._disk))
            if victim_key == entry.key:
                break  # only the fresh entry left; budget smaller than one page
            victim = self._disk.pop(victim_key)
            self._disk_bytes -= victim.nbytes
            try:
                os.unlink(victim.path)
            except OSError:
                pass
            self._evictions += 1
            dropped += 1
        return dropped

    # ---- public API -------------------------------------------------------

    def put(self, key: int, parent: int, tokens: Tuple[int, ...],
            blob: bytes) -> int:
        """Demote one page's container into the tier (most-recent end).
        Returns the number of entries the byte budgets pushed OUT of
        the tier entirely (spill-to-disk is a level change, not an
        eviction)."""
        with self._lock:
            self._discard_locked(key)
            e = _HostEntry(key, parent, tuple(tokens), bytes(blob))
            self._host[key] = e
            self._host_bytes += e.nbytes
            evicted = 0
            while self._host_bytes > self._budget and self._host:
                old_key, old = self._host.popitem(last=False)  # oldest
                self._host_bytes -= old.nbytes
                if self._spill_dir:
                    evicted += self._spill_locked(old)
                else:
                    self._evictions += 1
                    evicted += 1
            return evicted

    def pop(self, key: int, parent: int,
            tokens: Tuple[int, ...]) -> Optional[Tuple[dict, bytes, str]]:
        """Remove and return the entry for ``key`` as ``(payload, blob,
        level)`` — ``payload`` is the unpacked container dict the
        engine's scatter import consumes, ``level`` is ``"host"`` or
        ``"disk"``.  Identity is verified (parent chain + page tokens)
        before anything is returned: a colliding key degrades to a
        miss, never to foreign KV.  A corrupted disk container raises
        :class:`PayloadError` naming the CRC trailer offset — the
        entry is already dropped, so the caller treats it as a miss
        and the poison cannot be re-served."""
        tokens = tuple(tokens)
        d = None
        with self._lock:
            e = self._host.get(key)
            if e is not None:
                if e.parent != parent or e.tokens != tokens:
                    return None
                del self._host[key]
                self._host_bytes -= e.nbytes
                blob, level = e.blob, "host"
            else:
                d = self._disk.get(key)
                if d is None or d.parent != parent or (
                    d.tokens is not None and d.tokens != tokens
                ):
                    return None
                try:
                    with open(d.path, "rb") as f:
                        blob = f.read()
                except OSError:
                    del self._disk[key]
                    self._disk_bytes -= d.nbytes
                    return None
                level = "disk"
        # CRC + payload identity complete OUTSIDE the lock (unpack is
        # the expensive step).  A disk entry stays indexed until both
        # pass, so a mis-keyed probe degrades to a miss without
        # destroying the entry.
        try:
            payload = unpack_kv_handoff(blob)  # raises PayloadError on CRC
        except PayloadError:
            self._drop_disk_entry(key, d)  # poison must not be re-served
            raise
        if tuple(int(t) for t in payload["prompt"]) != tokens:
            # rescanned disk entry whose filename key collided with a
            # different chain: identity completes here, as a miss (the
            # entry survives for its real owner; a host-level mismatch
            # is unreachable short of corruption — put is content-keyed)
            return None
        self._drop_disk_entry(key, d)  # consumed
        return payload, blob, level

    def _drop_disk_entry(self, key: int, d: Optional[_DiskEntry]) -> None:
        if d is None:
            return
        with self._lock:
            if self._disk.pop(key, None) is not None:
                self._disk_bytes -= d.nbytes
            try:
                os.unlink(d.path)
            except OSError:
                pass

    def discard(self, key: int) -> None:
        """Drop ``key`` from whichever level holds it (the engine calls
        this when the key re-registers in the HBM prefix index — one
        residency per key, always)."""
        with self._lock:
            self._discard_locked(key)

    def _discard_locked(self, key: int) -> None:
        e = self._host.pop(key, None)
        if e is not None:
            self._host_bytes -= e.nbytes
        d = self._disk.pop(key, None)
        if d is not None:
            self._disk_bytes -= d.nbytes
            try:
                os.unlink(d.path)
            except OSError:
                pass

    def keys(self) -> Set[int]:
        with self._lock:
            return set(self._host) | set(self._disk)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "host_bytes": self._host_bytes,
                "disk_bytes": self._disk_bytes,
                "host_entries": len(self._host),
                "disk_entries": len(self._disk),
                "evictions": self._evictions,
            }

    def audit(self) -> List[str]:
        """Invariant check for the SELDON_TPU_PAGED_DEBUG audit: no key
        resident at two levels, byte accounting exact at both levels
        (an injected/orphaned entry that skipped accounting is a
        corruption, not a rounding error), and every disk index entry
        backed by a real file."""
        problems: List[str] = []
        with self._lock:
            dual = set(self._host) & set(self._disk)
            if dual:
                problems.append(
                    f"keys resident at BOTH tier levels: {sorted(dual)}"
                )
            host_sum = 0
            for key, e in self._host.items():
                if e.key != key:
                    problems.append(
                        f"orphaned host entry: index key {key} holds entry "
                        f"keyed {e.key}"
                    )
                if e.nbytes != len(e.blob):
                    problems.append(
                        f"orphaned host entry: key {key} prices {e.nbytes} "
                        f"bytes over a {len(e.blob)}-byte blob"
                    )
                host_sum += e.nbytes
            if host_sum != self._host_bytes:
                problems.append(
                    f"host tier byte accounting drifted: entries sum to "
                    f"{host_sum}, ledger says {self._host_bytes}"
                )
            disk_sum = 0
            for key, d in self._disk.items():
                if d.key != key:
                    problems.append(
                        f"disk index key {key} holds entry keyed {d.key}"
                    )
                if not os.path.exists(d.path):
                    problems.append(
                        f"disk tier entry {key} has no backing file "
                        f"({d.path})"
                    )
                disk_sum += d.nbytes
            if disk_sum != self._disk_bytes:
                problems.append(
                    f"disk tier byte accounting drifted: entries sum to "
                    f"{disk_sum}, ledger says {self._disk_bytes}"
                )
        return problems
