"""First-use sentinel for the generation engine's device programs.

The port compiles nothing the way XLA does, but the first call of a
program under an argument signature it has not seen is still where the
card's first-use costs land: cuDNN / cuBLAS algorithm selection for new
shapes, the caching allocator growing, a kernel library built with
``nvcc`` and loaded (``ops/_build``).  A request that arrives with such a
signature pays for it inside its serving path, and nothing in the
process says so.  ``JitSentinel.wrap`` wraps a callable with a signature
tracker: the first call under each distinct argument signature is a
first-use event.  It increments ``seldon_tpu_jit_compiles_total{program=}``
(the JAX package's metric name) and WARNs with the signature that
triggered it, so the operator can map a tail spike to the shape that
caused it and warm it at deploy time.  A count is that first call, not
an XLA compile.

The signature is the (shape, dtype) of every tensor or array leaf of the
arguments' nested tuples, lists and dicts, plus their nesting; any other
value (a Python scalar) collapses to its type name.  It costs one walk
of the arguments a call.  ``SELDON_TPU_JIT_SENTINEL=0`` disables it
(``wrap`` then returns the function untouched).  The module imports the
standard library and the port's metrics registry only.
"""

from __future__ import annotations

import functools
import logging
import threading
from typing import Any, Callable, List, Set, Tuple

logger = logging.getLogger(__name__)

JIT_COMPILES_METRIC = "seldon_tpu_jit_compiles_total"


def sentinel_enabled() -> bool:
    from seldon_core_tpu_torch.runtime import knobs

    return knobs.flag("SELDON_TPU_JIT_SENTINEL")


def _leaf_sig(x: Any) -> Any:
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is not None and dtype is not None:
        return (tuple(int(d) for d in shape), str(dtype).replace("torch.", ""))
    return type(x).__name__


def _walk(x: Any, leaves: List[Any]) -> str:
    """Append ``x``'s leaf signatures to ``leaves``; returns its nesting."""
    if isinstance(x, (tuple, list)):
        inner = ", ".join(_walk(v, leaves) for v in x)
        return f"({inner})" if isinstance(x, tuple) else f"[{inner}]"
    if isinstance(x, dict):
        return "{" + ", ".join(f"{k!r}: {_walk(x[k], leaves)}" for k in sorted(x, key=repr)) + "}"
    leaves.append(_leaf_sig(x))
    return "*"


def signature_of(args: tuple, kwargs: dict) -> Tuple:
    """The (shape, dtype) signature of a call's arguments and their
    nesting; a value without a shape and a dtype collapses to its type."""
    leaves: List[Any] = []
    nesting = _walk((args, kwargs), leaves)
    return tuple(leaves), nesting


def _count_compile(program: str, sig: Tuple, static: str) -> None:
    logger.warning(
        "jit compile: program=%s%s signature=%s — a new argument-shape signature reached this entry point; "
        "if this happened under traffic the request paid its first-use cost",
        program, f" [{static}]" if static else "", sig[0],
    )
    try:
        from seldon_core_tpu_torch.utils.metrics import _cache_for

        _cache_for(None).get(
            "counter", JIT_COMPILES_METRIC, ("program",),
            "first calls under a new argument signature at an engine program entry point",
        ).labels(program=program).inc()
    except Exception:  # noqa: BLE001 — the sentinel never breaks serving
        logger.exception("jit compile counter failed for %s", program)


class JitSentinel:
    """Per-program signature memory shared by all wrapped callables of
    one logical program (e.g. every (steps, buckets) chunk variant)."""

    def __init__(self, program: str):
        self.program = program
        self._seen: Set[Tuple] = set()
        self._lock = threading.Lock()

    @property
    def compiles(self) -> int:
        return len(self._seen)

    def wrap(self, fn: Callable, static: str = "") -> Callable:
        """Wrap a callable; ``static`` names the part of the program's
        identity that its arguments do not show (the chunk's (steps,
        buckets) spec), so two variants with identical array shapes
        still count separately."""
        if not sentinel_enabled():
            return fn

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            try:
                sig = (static, *signature_of(args, kwargs))
                with self._lock:
                    new = sig not in self._seen
                    if new:
                        self._seen.add(sig)
                if new:
                    _count_compile(self.program, sig[1:], static)
            except Exception:  # noqa: BLE001 — the sentinel never breaks serving
                logger.exception("jit sentinel failed for %s", self.program)
            return fn(*args, **kwargs)

        return wrapped
