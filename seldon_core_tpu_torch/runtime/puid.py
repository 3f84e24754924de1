"""Process-unique request ids (puids).

The puid is the correlation key of the whole observability stack — the
logical trace id, the pair-log key, the feedback router's lookup.  Two
hazards make the obvious ``prefix + itertools.count()`` unsafe:

* a respawned worker restarts its counter at 0, so two process
  *generations* of one replica mint colliding puids and their traces /
  logged pairs merge silently;
* a process that **forks** after import (supervisor pre-fork, test
  harnesses) duplicates both the prefix and the live counter state into
  every child.

The generator therefore re-seeds its random prefix whenever it notices
it is running in a new process (pid change), and the prefix comes from
``secrets`` per process generation — collision probability across any
realistic fleet of generations is 2^-48 per pair.  The counter gives
uniqueness and cheapness (no entropy syscall per request — urandom
showed up in the serving-path profile) within a generation.
"""

from __future__ import annotations

import itertools
import os
import secrets
import threading

_lock = threading.Lock()
_seeded = False
_prefix = ""
_counter = itertools.count()


def _reseed() -> None:
    global _seeded, _prefix, _counter
    with _lock:
        if _seeded:
            return  # another thread won the race — ONE generation only
        _prefix = secrets.token_hex(6)
        _counter = itertools.count()
        _seeded = True


def _invalidate() -> None:  # runs in the child right after a fork
    global _seeded
    _seeded = False


# fork invalidation via the interpreter hook rather than a per-call
# getpid(): the syscall on the minting path is exactly what the prefix+
# counter design exists to avoid (fresh processes re-import and reseed
# on first use either way)
os.register_at_fork(after_in_child=_invalidate)


def new_puid() -> str:
    """Unique request id (reference: PredictionService.java:72-78),
    collision-safe across processes, respawns, and forks."""
    if not _seeded:
        _reseed()
    # one consistent (prefix, counter) snapshot: the only writer after
    # seeding is the fork hook, and a freshly-forked child is
    # single-threaded, so a generation's pair can't be torn here
    prefix, counter = _prefix, _counter
    return f"{prefix}{next(counter):012x}"
