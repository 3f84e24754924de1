"""Shared dispatch thread pool.

``asyncio.to_thread`` uses the loop's default executor, sized
``min(32, cpu_count + 4)``; since a component call *blocks* its thread
while waiting on the dynamic batcher, that pool would cap in-flight
requests.  Dispatch threads spend their life blocked on futures or
inside GIL-releasing CUDA calls, so a much larger pool costs little.
"""

from __future__ import annotations

import asyncio
import contextvars
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable

from seldon_core_tpu_torch.runtime import knobs

_POOL: ThreadPoolExecutor | None = None


def dispatch_pool() -> ThreadPoolExecutor:
    global _POOL
    if _POOL is None:
        workers = int(knobs.raw("SELDON_TPU_DISPATCH_THREADS", "128"))
        _POOL = ThreadPoolExecutor(max_workers=workers, thread_name_prefix="seldon-dispatch")
    return _POOL


async def run_dispatch(fn: Callable, *args: Any):
    """Run a sync dispatch call on the shared pool, with the caller's
    contextvars copied onto the pool thread."""
    loop = asyncio.get_running_loop()
    ctx = contextvars.copy_context()
    return await loop.run_in_executor(dispatch_pool(), lambda: ctx.run(fn, *args))
