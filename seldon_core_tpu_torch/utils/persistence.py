"""Component-state persistence (checkpoint / restore).

The reference pickles the entire live user object to Redis on a timer
and unpickles it at boot (reference: python/seldon_core/persistence.py:
21-84, key schema :12-15).  Whole-object pickling is fragile (code
upgrades break restores) and Redis is not in this stack, so this
module (the port's copy of the JAX package's) persists an explicit
*state tree*:

* components expose ``checkpoint_state() -> dict`` / ``restore_state``
  (see ``TPUComponent``); only mutable learning state is captured
  (e.g. a bandit's per-branch counts), never code;
* snapshots go to a local directory, one ``{key}.json`` a component,
  published by tmp + rename;
* a background thread snapshots every ``period_s`` (default 60s, the
  reference's push frequency).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Dict, Optional

import numpy as np

logger = logging.getLogger(__name__)


def _to_jsonable(obj: Any) -> Any:
    if isinstance(obj, np.ndarray):
        return {"__ndarray__": obj.tolist(), "dtype": obj.dtype.name}
    if isinstance(obj, (np.integer, np.floating)):
        return obj.item()
    if isinstance(obj, dict):
        return {k: _to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(v) for v in obj]
    return obj


def _from_jsonable(obj: Any) -> Any:
    if isinstance(obj, dict):
        if "__ndarray__" in obj:
            return np.asarray(obj["__ndarray__"], dtype=obj.get("dtype", "float64"))
        return {k: _from_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_from_jsonable(v) for v in obj]
    return obj


class _PersistenceThread(threading.Thread):
    def __init__(self, manager: "PersistenceManager", component: Any, period_s: float):
        super().__init__(daemon=True, name="seldon-tpu-persistence")
        self.manager = manager
        self.component = component
        self.period_s = period_s
        # not ``_stop``: that name is threading.Thread's own, and shadowing
        # it breaks ``join``
        self._stop_event = threading.Event()

    def run(self) -> None:
        while not self._stop_event.wait(self.period_s):
            try:
                self.manager.save(self.component)
            except Exception:  # checkpointing must never kill serving
                logger.exception("periodic state checkpoint failed")

    def stop(self) -> None:
        self._stop_event.set()
        try:
            self.manager.save(self.component)  # final snapshot on shutdown
        except Exception:  # shutdown snapshot is best-effort
            logger.exception("final state checkpoint failed")


class PersistenceManager:
    """Stores one component's state tree under `dir/key.json`."""

    def __init__(self, directory: str, key: str):
        self.directory = directory
        # key schema mirrors the reference's
        # persistence_{deployment}_{predictor}_{unit} flattened to one token
        self.key = key.replace("/", "_").replace(".", "_")
        os.makedirs(directory, exist_ok=True)

    @property
    def path(self) -> str:
        return os.path.join(self.directory, f"{self.key}.json")

    def save(self, component: Any) -> bool:
        fn = getattr(component, "checkpoint_state", None)
        if fn is None:
            return False
        state = fn()
        if state is None:
            return False
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"saved_at": time.time(), "state": _to_jsonable(state)}, f)
        os.replace(tmp, self.path)  # atomic publish
        return True

    def restore(self, component: Any) -> bool:
        fn = getattr(component, "restore_state", None)
        if fn is None or not os.path.exists(self.path):
            return False
        try:
            with open(self.path) as f:
                payload = json.load(f)
            fn(_from_jsonable(payload["state"]))
            logger.info("restored component state from %s", self.path)
            return True
        except Exception:  # corrupt snapshot: fresh start beats a dead start
            logger.exception("state restore failed; starting fresh")
            return False

    def start_background(self, component: Any, period_s: float = 60.0) -> _PersistenceThread:
        thread = _PersistenceThread(self, component, period_s)
        thread.start()
        return thread
