"""Server-side dynamic batching for models with per-shape device work.

CUDA kernels and cuDNN pick their algorithms per input shape, so
per-request ragged batch sizes would either re-plan constantly or
serialise requests.  The batcher solves both:

* concurrent requests are coalesced into one device call (row-wise
  concatenation), up to ``max_batch_size`` rows or ``max_wait_ms`` of
  queueing delay, whichever comes first;
* the coalesced batch is padded up to a fixed **bucket** size
  (powers of two by default), so the server warms exactly
  ``len(buckets)`` shapes at load time;
* results are sliced back per request, padding rows discarded.

The execution is a **two-stage pipeline**: a collector thread coalesces
requests and *launches* the device call (CUDA launches are async), then
immediately starts an async device->host copy of the result into pinned
memory, records a CUDA event behind it, and hands the in-flight batch
to a finisher pool; finishers wait on the event and resolve request
futures.  Collection of batch N+1 overlaps the device compute and the
host copy of batch N, so throughput is set by the slowest stage, not the
sum.

Thread-based on purpose: model calls arrive from worker threads and
CUDA calls release the GIL, so the pipeline threads drive the device
while request threads only block on their own future.

A request's future is resolved only once the batcher has stopped
reading its rows: after ``predict_fn`` returned (or raised) for the
batch holding them, or when ``stop()`` fails it unlaunched.  With
``CudaServer.device_call`` as ``predict_fn`` the rows have been copied
into the staging buffer by then, so a caller that lends rows it does
not own (the native ingress hands over a view of C++ memory) may free
them as soon as the future is done.  ``submit_lent`` bounds that wait
and keeps the rule on timeout: a request still queued is cancelled
(``_collect`` skips it and never reads its rows), and one already
collected is waited out until ``predict_fn`` has returned for its batch.

``MultiSignatureBatcher`` gives each input signature (dtype, trailing
shape) of a multi-signature model its own ``DynamicBatcher``, so each
signature coalesces on its own and every group keeps the lent-row and
cancellation rules above.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from concurrent.futures import TimeoutError as FutureTimeout
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from seldon_core_tpu_torch.codec.device import PendingHostCopy, from_device_async

logger = logging.getLogger(__name__)


def default_buckets(max_batch_size: int) -> List[int]:
    """Powers of two up to max_batch_size (always includes it)."""
    buckets: List[int] = []
    b = 1
    while b < max_batch_size:
        buckets.append(b)
        b *= 2
    buckets.append(max_batch_size)
    return sorted(set(buckets))


def normalize_buckets(buckets: Optional[Sequence[int]], max_batch_size: int) -> List[int]:
    """Canonical bucket list: sorted, deduped, capped at and always
    ending with ``max_batch_size``.  The batcher and the server's
    warmup must agree on this list — warming the raw user-supplied
    buckets would leave the forced final bucket cold, and the first
    full batch would pay the algorithm search mid-traffic."""
    if max_batch_size < 1:
        raise ValueError("max_batch_size must be >= 1")
    out = sorted(set(buckets)) if buckets else default_buckets(max_batch_size)
    if out[-1] != max_batch_size:
        out = [b for b in out if b < max_batch_size] + [max_batch_size]
    return out


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


# a request's rows are read by the collector between _TAKEN and _RELEASED;
# a _CANCELLED one is never read (submit_lent timed out while it was queued)
_QUEUED, _TAKEN, _RELEASED, _CANCELLED = range(4)


@dataclass
class _WorkItem:
    x: np.ndarray  # [rows, ...]
    rows: int
    future: Future
    enqueued_at: float
    state: int = _QUEUED
    # set when the batcher stops reading x: predict_fn returned (or raised)
    # for the batch holding it, or the item was failed unlaunched
    released: Optional[threading.Event] = None


class BatcherStats:
    def __init__(self, reservoir: int = 8192) -> None:
        self.requests = 0
        self.batches = 0
        self.rows = 0
        self.padded_rows = 0
        # server-side latency reservoirs (ms), newest-wins ring buffers:
        # wait = enqueue -> device launch; total = enqueue -> result set
        # (arrival->response inside the serving process, the histogram
        # client RTT cannot give).  Appends are atomic, but ITERATION
        # concurrent with appends raises "deque mutated during
        # iteration" — readers and writers share _lat_lock
        self._lat_lock = threading.Lock()
        self.wait_ms: "deque[float]" = deque(maxlen=reservoir)
        self.total_ms: "deque[float]" = deque(maxlen=reservoir)
        # sums over requests, whose differences between two reads over the
        # difference of `requests` are a window's means: enqueue -> the
        # batch's collection closed (the coalescing window and any queueing
        # behind the collector), and enqueue -> result set
        self.collect_ms_total = 0.0
        self.total_ms_sum = 0.0

    def record_wait(self, ms: float) -> None:
        with self._lat_lock:
            self.wait_ms.append(ms)

    def record_total(self, ms: float) -> None:
        with self._lat_lock:
            self.total_ms.append(ms)
            self.total_ms_sum += ms

    def latency_snapshot(self) -> tuple:
        """Consistent copies of both reservoirs (safe under traffic)."""
        with self._lat_lock:
            return list(self.wait_ms), list(self.total_ms)

    def observe(self, batch_requests: int, rows: int, padded: int) -> None:
        self.requests += batch_requests
        self.batches += 1
        self.rows += rows
        self.padded_rows += padded

    @property
    def mean_batch_rows(self) -> float:
        return self.rows / self.batches if self.batches else 0.0

    def latency_summary(self) -> dict:
        """Percentiles of the in-process arrival->response histogram
        (and of queue wait alone).  Empty dict when nothing recorded."""
        wait, total = self.latency_snapshot()
        if not total:
            return {}
        total.sort()
        wait.sort()

        def pct(sorted_vals, q):
            if not sorted_vals:
                return None
            # nearest-rank: ceil(q*n)-1 — int(q*n) reads one order
            # statistic high (p99 of 100 samples would be the max)
            import math

            idx = max(0, math.ceil(q * len(sorted_vals)) - 1)
            return round(sorted_vals[idx], 3)

        return {
            "p50_ms": pct(total, 0.50),
            "p90_ms": pct(total, 0.90),
            "p99_ms": pct(total, 0.99),
            "wait_p50_ms": pct(wait, 0.50),
            "wait_p99_ms": pct(wait, 0.99),
            "count": len(total),
        }


class DynamicBatcher:
    """Coalesces row-batched requests into padded-bucket device calls.

    `predict_fn(batch) -> batch_out` must accept a leading batch dim and
    preserve row order; typically a model forward that returns a CUDA
    tensor (read back asynchronously) or a host array.
    """

    def __init__(
        self,
        predict_fn: Callable[[np.ndarray], Any],
        max_batch_size: int = 64,
        max_wait_ms: float = 2.0,
        buckets: Optional[Sequence[int]] = None,
        name: str = "batcher",
        pipeline_depth: int = 16,
        finisher_threads: int = 12,
    ):
        self.predict_fn = predict_fn
        self.max_batch_size = max_batch_size
        self.max_wait_s = max_wait_ms / 1000.0
        self.buckets = normalize_buckets(buckets, max_batch_size)
        self.name = name
        self.stats = BatcherStats()
        self._queue: "queue.Queue[Optional[_WorkItem]]" = queue.Queue()
        # deferred item that would overflow the current batch (collector
        # thread only — no locking needed)
        self._carry: Optional[_WorkItem] = None
        # bounded: backpressure when `pipeline_depth` batches are in flight
        self._inflight: "queue.Queue[Optional[tuple]]" = queue.Queue(maxsize=pipeline_depth)
        self._thread: Optional[threading.Thread] = None
        self._finishers: List[threading.Thread] = []
        self.finisher_threads = finisher_threads
        self._running = False
        # guards _WorkItem.state: submit_lent's cancel races the collector's take
        self._state_lock = threading.Lock()

    # ---------------------------------------------------------------- public

    def start(self) -> None:
        if self._running:
            return
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True, name=f"seldon-tpu-{self.name}")
        self._thread.start()
        self._finishers = [
            threading.Thread(target=self._finish_loop, daemon=True, name=f"seldon-tpu-{self.name}-fin{i}")
            for i in range(self.finisher_threads)
        ]
        for t in self._finishers:
            t.start()

    def stop(self) -> None:
        if not self._running:
            return
        self._running = False
        self._queue.put(None)
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        # items never launched must not hang their callers: the deferred
        # one and whatever is still queued
        stopped = RuntimeError(f"batcher {self.name!r} stopped")
        if self._carry is not None:
            self._release([self._carry])
            if not self._carry.future.done():
                self._carry.future.set_exception(stopped)
            self._carry = None
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                self._release([item])
                if not item.future.done():
                    item.future.set_exception(stopped)
        for _ in self._finishers:
            self._inflight.put(None)
        for t in self._finishers:
            t.join(timeout=5.0)
        self._finishers = []

    def submit_future(self, x: np.ndarray) -> Future:
        """Enqueue one request batch [rows, ...]; returns its Future
        without blocking (async servers await it, no thread pinned)."""
        return self._enqueue(x).future

    def _enqueue(self, x: np.ndarray, released: Optional[threading.Event] = None) -> _WorkItem:
        if not self._running:
            raise RuntimeError(f"batcher {self.name!r} not started")
        x = np.asarray(x)
        if x.ndim < 1:
            raise ValueError("batcher input must have a leading batch dimension")
        item = _WorkItem(x=x, rows=x.shape[0], future=Future(), enqueued_at=time.perf_counter(), released=released)
        self._queue.put(item)
        return item

    def submit(self, x: np.ndarray, timeout_s: float = 30.0):
        """Blocking submit of one request batch [rows, ...]; returns [rows, ...out]."""
        return self.submit_future(x).result(timeout=timeout_s)

    def submit_lent(self, x: np.ndarray, timeout_s: float = 120.0):
        """Blocking submit of rows the caller only lends (a view of memory
        it frees when this returns): returns [rows, ...out], or raises
        ``TimeoutError`` after ``timeout_s``.  Never returns while the
        batcher may still read ``x``: on timeout a queued request is
        cancelled before the collector takes it, and a collected one is
        waited out until ``predict_fn`` has returned for its batch."""
        return self._wait_lent(self._enqueue(x, released=threading.Event()), timeout_s)

    def _wait_lent(self, item: _WorkItem, timeout_s: float):
        try:
            return item.future.result(timeout=timeout_s)
        except FutureTimeout:
            pass
        with self._state_lock:
            cancelled = item.state == _QUEUED
            if cancelled:
                item.state = _CANCELLED
        if cancelled:
            item.x = None  # the collector skips it; drop the lent buffer now
            item.future.cancel()
        else:
            item.released.wait()  # the staging copy of its batch is made
        raise TimeoutError(f"batcher {self.name!r}: no answer within {timeout_s}s")

    # ---------------------------------------------------------------- worker

    def _collect(self) -> Optional[List[_WorkItem]]:
        """Block for the first item, then fill until bucket/deadline.

        A row-batched request that would push the coalesced batch PAST
        ``max_batch_size`` is carried over to the next batch instead of
        merged: two already-full batches concatenated would form an
        oversized shape no warmup ever compiled, stalling the dispatch
        thread on a mid-traffic algorithm search.  (A single oversized request
        still gets its honest full-size call — only merging is capped.)
        """
        while True:
            first = self._carry if self._carry is not None else self._queue.get()
            self._carry = None
            if first is None:
                return None
            if self._take(first):
                break
        items = [first]
        rows = first.rows
        deadline = time.perf_counter() + self.max_wait_s
        while rows < self.max_batch_size:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                item = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if item is None:
                self._queue.put(None)  # re-signal shutdown for the outer loop
                break
            if item.state == _CANCELLED:
                continue
            if rows + item.rows > self.max_batch_size:
                self._carry = item
                break
            if not self._take(item):
                continue
            items.append(item)
            rows += item.rows
        return items

    def _take(self, item: _WorkItem) -> bool:
        """Mark an item collected (its rows are about to be read); False
        for one that ``submit_lent`` cancelled, which is dropped unread."""
        with self._state_lock:
            if item.state == _CANCELLED:
                return False
            item.state = _TAKEN
            return True

    def _release(self, items: List[_WorkItem]) -> None:
        """The batcher reads these items' rows no more."""
        with self._state_lock:
            for it in items:
                if it.state != _CANCELLED:
                    it.state = _RELEASED
        for it in items:
            if it.released is not None:
                it.released.set()

    def _launch_batch(self, items: List[_WorkItem]) -> None:
        """Stage 1 (collector thread): pad, launch, start async readback."""
        collected = time.perf_counter()
        self.stats.collect_ms_total += sum(collected - it.enqueued_at for it in items) * 1000.0
        rows = sum(it.rows for it in items)
        bucket = bucket_for(rows, self.buckets)
        if rows > bucket:  # oversized single request: honest full-size call
            bucket = rows
        padded = bucket - rows
        arrays = [it.x for it in items]
        homogeneous = all(
            a.dtype == arrays[0].dtype and a.shape[1:] == arrays[0].shape[1:] for a in arrays[1:]
        )
        if homogeneous and (len(arrays) > 1 or padded):
            # one allocation: gather the rows and zero the padding
            batch = np.empty((bucket, *arrays[0].shape[1:]), arrays[0].dtype)
            np.concatenate(arrays, axis=0, out=batch[:rows])
            batch[rows:] = 0
        else:
            batch = arrays[0] if len(arrays) == 1 else np.concatenate(arrays, axis=0)
            if padded:
                pad_width = [(0, padded)] + [(0, 0)] * (batch.ndim - 1)
                batch = np.pad(batch, pad_width)
        # async CUDA launch: returns immediately; the readback into pinned
        # memory starts now and overlaps later batches.  Once predict_fn
        # has returned the rows are staged: lent rows may be freed.
        try:
            result = self.predict_fn(batch)
        finally:
            self._release(items)
        out = from_device_async(result)
        self.stats.observe(len(items), rows, padded)
        launched = time.perf_counter()
        for it in items:
            self.stats.record_wait((launched - it.enqueued_at) * 1000.0)
        self._inflight.put((items, out))

    def _finish_loop(self) -> None:
        """Stage 2 (finisher pool): materialise results, resolve futures.
        Several finishers run so the fixed device->host latency of
        consecutive batches overlaps."""
        while True:
            entry = self._inflight.get()
            if entry is None:
                return
            items, out = entry
            try:
                out = out.result() if isinstance(out, PendingHostCopy) else np.asarray(out)
                done = time.perf_counter()
                offset = 0
                for it in items:
                    try:
                        it.future.set_result(out[offset : offset + it.rows])
                    except InvalidStateError:
                        pass  # its caller cancelled it (a hedge loser, a client gone); the rest still answer
                    offset += it.rows
                    self.stats.record_total((done - it.enqueued_at) * 1000.0)
            except Exception as e:  # noqa: BLE001 — propagate to every caller
                logger.exception("batch readback failed")
                for it in items:
                    if not it.future.done():
                        it.future.set_exception(e)

    def _loop(self) -> None:
        while self._running:
            items = self._collect()
            if items is None:
                break
            try:
                self._launch_batch(items)
            except Exception as e:  # noqa: BLE001 — propagate to every caller
                logger.exception("batch launch failed")
                self._release(items)
                for it in items:
                    if not it.future.done():
                        it.future.set_exception(e)

    def __enter__(self) -> "DynamicBatcher":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


class MultiSignatureBatcher:
    """Per-(dtype, trailing-shape) dynamic batching for multi-signature models.

    One served model may accept several input signatures: a ViT served
    at several resolutions, or mixed uint8 / float32 image payloads.
    cuDNN and the kernels plan per shape anyway, so giving each signature
    its own queue costs no warmup and lets each one coalesce on its own;
    mixing them in one queue would flush a small batch at every change of
    signature in the arrival stream.

    Groups are created on first sight and capped at ``max_signatures``
    (each owns a collector thread and a finisher pool); an over-cap
    signature is a ``ValueError`` naming the signatures seen, never an
    unbounded growth of threads.
    """

    def __init__(
        self,
        predict_fn: Callable[[np.ndarray], Any],
        max_batch_size: int = 64,
        max_wait_ms: float = 2.0,
        buckets: Optional[Sequence[int]] = None,
        name: str = "batcher",
        pipeline_depth: int = 16,
        finisher_threads: int = 4,
        max_signatures: int = 16,
    ):
        self.predict_fn = predict_fn
        self.max_batch_size = max_batch_size
        self.max_wait_ms = max_wait_ms
        # normalized eagerly: a bad max_batch_size fails here, and warmup
        # reads the canonical list
        self.buckets = normalize_buckets(buckets, max_batch_size)
        self.name = name
        self.pipeline_depth = pipeline_depth
        self.finisher_threads = finisher_threads
        self.max_signatures = max_signatures
        self._groups: Dict[Tuple[str, tuple], DynamicBatcher] = {}
        self._lock = threading.Lock()
        self._running = False

    # ---------------------------------------------------------------- public

    def start(self) -> None:
        with self._lock:
            self._running = True
            for g in self._groups.values():
                g.start()

    def stop(self) -> None:
        with self._lock:
            self._running = False
            groups = list(self._groups.values())
        for g in groups:
            g.stop()

    def signature_of(self, x: np.ndarray) -> Tuple[str, tuple]:
        return (x.dtype.str, tuple(x.shape[1:]))

    def _group_for(self, x: np.ndarray) -> DynamicBatcher:
        """The signature's group, made on first sight (caller holds the lock)."""
        if not self._running:
            raise RuntimeError(f"batcher {self.name!r} not started")
        key = self.signature_of(x)
        group = self._groups.get(key)
        if group is None:
            if len(self._groups) >= self.max_signatures:
                raise ValueError(
                    f"batcher {self.name!r}: signature {key} would exceed "
                    f"max_signatures={self.max_signatures} (seen: {sorted(self._groups)})"
                )
            group = DynamicBatcher(
                self.predict_fn,
                max_batch_size=self.max_batch_size,
                max_wait_ms=self.max_wait_ms,
                buckets=self.buckets,
                name=f"{self.name}[{key[0]}{'x'.join(map(str, key[1]))}]",
                pipeline_depth=self.pipeline_depth,
                finisher_threads=self.finisher_threads,
            )
            group.start()
            self._groups[key] = group
        return group

    @staticmethod
    def _checked(x: np.ndarray) -> np.ndarray:
        x = np.asarray(x)
        if x.ndim < 1:
            raise ValueError("batcher input must have a leading batch dimension")
        return x

    def submit_future(self, x: np.ndarray) -> Future:
        x = self._checked(x)
        # resolve the group AND enqueue under one lock: a stop() between
        # the two would surface as the group's error, not this batcher's
        with self._lock:
            return self._group_for(x).submit_future(x)

    def submit(self, x: np.ndarray, timeout_s: float = 30.0):
        return self.submit_future(x).result(timeout=timeout_s)

    def submit_lent(self, x: np.ndarray, timeout_s: float = 120.0):
        """``DynamicBatcher.submit_lent`` in the rows' signature group:
        never returns while that group may still read ``x``."""
        x = self._checked(x)
        with self._lock:
            group = self._group_for(x)
            item = group._enqueue(x, released=threading.Event())
        return group._wait_lent(item, timeout_s)

    @property
    def signatures(self) -> List[Tuple[str, tuple]]:
        with self._lock:
            return sorted(self._groups)

    @property
    def stats(self) -> BatcherStats:
        """Stats summed over the signature groups."""
        with self._lock:
            groups = list(self._groups.values())
        # a reservoir that holds every group's samples: N full groups in a
        # default-size ring would keep only the last group's latencies
        agg = BatcherStats(reservoir=max(1, len(groups)) * 8192)
        for g in groups:
            agg.requests += g.stats.requests
            agg.batches += g.stats.batches
            agg.rows += g.stats.rows
            agg.padded_rows += g.stats.padded_rows
            agg.collect_ms_total += g.stats.collect_ms_total
            agg.total_ms_sum += g.stats.total_ms_sum
            wait, total = g.stats.latency_snapshot()
            agg.wait_ms.extend(wait)
            agg.total_ms.extend(total)
        return agg

    def __enter__(self) -> "MultiSignatureBatcher":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
