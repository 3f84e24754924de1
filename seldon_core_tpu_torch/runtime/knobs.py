"""Environment knobs the port reads, in one place.

Each knob is read straight from ``os.environ`` when it is needed.  Where
a knob means what it means in the JAX package, it keeps that package's
``SELDON_TPU_*`` name, so one deployment spec configures either server.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

KNOBS: Dict[str, str] = {
    "SELDON_TPU_DISPATCH_THREADS": "size of the shared dispatch thread pool (default 128)",
}


def raw(name: str, default: Optional[str] = None) -> Optional[str]:
    """The knob's value, or ``default`` when unset; the name must be listed."""
    if name not in KNOBS:
        raise KeyError(f"unregistered knob {name!r}; known: {sorted(KNOBS)}")
    return os.environ.get(name, default)
