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
    "SELDON_TPU_PAGED_KERNEL": (
        "paged decode lane: 'auto' (default: the CUDA kernel on a CUDA engine, the gather lane "
        "on the CPU), '1'/'force' (the kernel lane everywhere; its plain version on the CPU), "
        "'0' (the gather lane)"
    ),
    "SELDON_TPU_PAGED_KERNEL_IMPL": "paged decode kernel: 'stream' (K4, default) or 'grid' (K5)",
    "SELDON_TPU_CHUNK_IMPL": "decode chunk: 'pool' (the only one ported; unset means pool), 'ring' raises",
    "SELDON_TPU_KV_DTYPE": "KV pool dtype: 'bf16' (default: the engine dtype, natively), 'int8' raises",
    "SELDON_TPU_PREFIX_CACHE": "page-granular prefix cache: '1' raises (not ported); off by default here",
}

# flag knobs and their defaults: "1" = on unless set to "0", "0" = off
# unless set to "1".  The JAX package defaults the prefix cache on; the
# port has no prefix cache yet, so its default is off.
_FLAG_DEFAULTS: Dict[str, str] = {
    "SELDON_TPU_PREFIX_CACHE": "0",
}


def raw(name: str, default: Optional[str] = None) -> Optional[str]:
    """The knob's value, or ``default`` when unset; the name must be listed."""
    if name not in KNOBS:
        raise KeyError(f"unregistered knob {name!r}; known: {sorted(KNOBS)}")
    return os.environ.get(name, default)


def flag(name: str) -> bool:
    """An on/off knob: a default-on flag is off only at ``0``, a
    default-off flag is on only at ``1`` (the JAX package's rule)."""
    if name not in _FLAG_DEFAULTS:
        raise KeyError(f"{name!r} is not a flag knob; read it with raw()")
    default = _FLAG_DEFAULTS[name]
    val = raw(name, default)
    return val != "0" if default == "1" else val == "1"
