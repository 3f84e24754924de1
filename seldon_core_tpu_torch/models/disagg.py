"""Disaggregated prefill/decode serving, and live-stream evacuation.

Prompt prefill runs on dedicated PREFILL engines and only the finished
KV pages enter the DECODE engine's pool (DistServe, arXiv:2401.09670), so
decode waves never carry prefill work and a long prompt does not hold up
the streams already decoding.  Two handoff lanes, one wire format (the
SRT1 container of ``codec/bufview.pack_kv_handoff``):

* **local** (``prefill_workers=N``): N prefill ``PagedEngine``s in this
  process, each on its own thread, share the decode engine's device; the
  payload's page tensors pass by reference into ``submit_prefilled``
  (metered as ``zero_copy_bytes``).
* **remote** (``prefill_endpoints``): :class:`PrefillLM` is an ordinary
  deployable microservice that returns the container as a uint8
  ``rawTensor``; :class:`DisaggregatedLM` dials it through the transport
  clients (breakers, retries, tracing and the deadline apply unchanged).

Admission prices a request by its predicted prefill + decode cost
(``PagedEngine.predict_cost_s``): a deadline the prediction cannot meet
is refused 504 ``DEADLINE_UNREACHABLE`` before a prefill engine runs.
Priorities and deadlines ride the handoff into the decode engine's
``submit``.

The evacuation part: the journal entry of a migration payload, the
placement cost of a peer, and :func:`evacuate_streams`, which moves a
draining engine's mid-decode streams onto peer engines in this process
(KV pages, decode cursor and sampler state included) and journals the
ones no peer takes.
"""

from __future__ import annotations

import json
import logging
import queue as _pyqueue
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from seldon_core_tpu_torch.models.generate import load_lm_params
from seldon_core_tpu_torch.models.paged import PagedEngine, StreamingLM, journal_entry
from seldon_core_tpu_torch.runtime import knobs as _knobs
from seldon_core_tpu_torch.runtime.component import MicroserviceError, gauge_metric

logger = logging.getLogger(__name__)

__all__ = ["PrefillLM", "DisaggregatedLM", "evacuate_streams", "migration_journal_entry"]


def _count(x) -> int:
    return int(np.asarray(x if x is not None else []).reshape(-1).shape[0])


def migration_journal_entry(payload: Dict[str, Any]) -> Dict[str, Any]:
    """A drain-journal entry from a migration payload: the recipe a
    stream falls back to when no peer takes it.  The schema is the one
    :func:`models.paged.journal_entry` builds, so the drain lane and the
    migration lane journal alike."""
    return journal_entry(
        req_id=payload.get("req_id"),
        prompt=[int(t) for t in np.asarray(payload["prompt"]).reshape(-1)],
        max_new_tokens=int(payload.get("max_new_tokens", 32)),
        temperature=float(payload.get("temperature", 0.0)),
        top_k=int(payload.get("top_k", 0)),
        eos_id=int(payload.get("eos_id", -1)),
        seed=int(payload.get("seed", 0)),
        priority=int(payload.get("priority", 0)),
        deadline_remaining_ms=payload.get("deadline_remaining_ms"),
        streamed=int(payload.get("streamed") or 0),
        stream_tokens=bool(payload.get("stream_tokens")),
        tokens_decoded=_count(payload.get("tokens")),
        adapter=payload.get("adapter"),
    )


def _peer_cost_s(engine: PagedEngine, payload: Dict[str, Any]) -> float:
    """Predicted seconds of ``payload``'s remaining decode on ``engine``
    from its measured rates (the KV arrives computed, so no prefill); a
    cold peer prices 0.  Its backlog breaks ties, so one peer does not
    take the whole wave."""
    remaining = max(1, int(payload.get("max_new_tokens", 32)) - _count(payload.get("tokens")))
    cost = engine.predict_cost_s(0, remaining)
    stats = engine.engine_stats()
    return (cost or 0.0) + 0.001 * (stats["queued"] + stats["active"])


def evacuate_streams(src_engine: PagedEngine, peers: List[PagedEngine], *,
                     transport: str = "local") -> Dict[str, Any]:
    """Live-migrate ``src_engine``'s exportable streams onto the healthy
    ``peers`` (``engine_stats()["health"]``, the watchdog's state: a
    degraded or evacuating peer takes none), highest priority first, each
    to the peer whose predicted remaining cost is lowest.  The peer adopts the source's stream
    object, so waiters and token queues carry on: no token is lost.  A
    stream every peer refuses (pool too small, engine closed, shed, a
    sampler state of another kind) resolves 503 ``MIGRATING`` and its
    recipe lands in the returned ``journal``.  Returns ``{"migrated",
    "failed", "journal"}``."""
    from seldon_core_tpu_torch.engine.transport import migration_hop

    exported = src_engine.migrate_export()
    healthy = [p for p in peers
               if p is not src_engine and p.engine_stats().get("health", "healthy") == "healthy"]
    out: Dict[str, Any] = {"migrated": 0, "failed": 0, "journal": []}
    err = MicroserviceError("stream could not be live-migrated during evacuation; its recipe is journaled for "
                            "re-derivation", status_code=503, reason="MIGRATING")
    for payload, stream in sorted(exported, key=lambda ps: -ps[0]["priority"]):
        placed = False
        for peer in sorted(healthy, key=lambda p: _peer_cost_s(p, payload)):
            try:
                with migration_hop("evacuate", transport) as hop:
                    if hop is not None:
                        hop.zero_copy_bytes = payload["k"].nbytes + payload["v"].nbytes
                    peer.migrate_import(payload, stream=stream)
                placed = True
                break
            except MicroserviceError as exc:
                logger.warning("peer refused migrated req %s: %s", payload.get("req_id"), exc)
        if placed:
            out["migrated"] += 1
        else:
            out["failed"] += 1
            out["journal"].append(migration_journal_entry(payload))
            src_engine.fail_stream(stream, err)
    return out


def _nbytes(x) -> int:
    return int(x.nbytes) if isinstance(x, torch.Tensor) else int(np.asarray(x).nbytes)


class PrefillLM(StreamingLM):
    """Deployable prefill worker: one prompt a request, prefilled and
    returned as the KV-page handoff container in a (1, n) uint8 row, the
    ``rawTensor`` the remote lane carries.  Decode never runs here: every
    stream is ``kv_export``, so the engine's waves are pure prefill and
    its prefix cache stays warm across exports."""

    def predict(self, X, names, meta=None):
        if self.engine is None:
            self.load()
        meta = meta or {}
        tags = meta.get("tags", {})
        X = np.atleast_2d(np.asarray(X, np.int32))
        if X.shape[0] != 1:
            raise MicroserviceError("prefill workers serve one prompt per request (the KV handoff is per stream); "
                                    "send rows separately", status_code=400, reason="BAD_REQUEST")
        priority, deadline = self._slo_terms(tags)
        stream = self.engine.submit(X[0], max_new_tokens=1, priority=priority, deadline=deadline, kv_export=True,
                                    adapter=self._request_adapter(tags))
        self._wake.set()
        stream.event.wait()
        if stream.error is not None:
            raise stream.error
        from seldon_core_tpu_torch.codec.bufview import pack_kv_handoff

        return np.frombuffer(pack_kv_handoff(stream.kv_payload), np.uint8)[None, :]

    def metrics(self):
        out = super().metrics()
        if self.engine is not None:
            out.append(gauge_metric("paged_kv_exports", self.engine.engine_stats()["kv_exports"]))
        return out


class _PrefillJob:
    """One prompt waiting for a prefill engine, ordered by (priority
    desc, arrival) in the shared queue: the decode engine's admission
    order, so a batch prompt cannot starve interactive prefills."""

    __slots__ = ("seq", "prompt", "priority", "submit_kw", "event", "stream", "error", "cancelled")

    def __init__(self, seq: int, prompt: np.ndarray, priority: int, submit_kw: Dict[str, Any]):
        self.seq = seq
        self.prompt = prompt
        self.priority = priority
        self.submit_kw = submit_kw
        self.event = threading.Event()
        self.stream = None
        self.error: Optional[Exception] = None
        # set when a sibling row fails: a job still queued is skipped, so
        # no prefill runs and no decode stream starts for an unread row
        self.cancelled = False

    def __lt__(self, other: "_PrefillJob") -> bool:
        return (-self.priority, self.seq) < (-other.priority, other.seq)


class DisaggregatedLM(StreamingLM):
    """Decode-engine front with dedicated prefill engines.

    ``prefill_workers=N`` (or ``SELDON_TPU_PREFILL_WORKERS``) builds N
    in-process prefill engines of ``prefill_slots`` slots each, fed from
    one priority queue, on this component's ``device`` and ``dtype`` (a
    float32 front hands its pool float32 pages); ``prefill_endpoints``
    (a list or its JSON: ``"host:port"``, ``"grpc://..."`` or
    ``"rest://..."``) dials remote :class:`PrefillLM` services instead.
    With neither it is a plain :class:`StreamingLM`.

    ``predict`` / ``predict_stream`` send every prompt through a prefill
    engine and admit only its finished KV pages into the decode engine.
    Greedy decode equals unified serving's: the pages are the same
    prefill's K/V, and each row's seed follows the same rule."""

    def __init__(self, *args: Any, prefill_workers: int = 0, prefill_slots: int = 2, prefill_endpoints: Any = None,
                 admission_pricing: Optional[bool] = None, **kwargs: Any):
        super().__init__(*args, **kwargs)
        if not prefill_workers:
            prefill_workers = int(_knobs.raw("SELDON_TPU_PREFILL_WORKERS", "0") or 0)
        self.prefill_workers = max(0, int(prefill_workers))
        self.prefill_slots = max(1, int(prefill_slots))
        if isinstance(prefill_endpoints, str):  # deployment parameters arrive as JSON
            prefill_endpoints = json.loads(prefill_endpoints) if prefill_endpoints else []
        self.prefill_endpoints = list(prefill_endpoints or [])
        if admission_pricing is None:
            admission_pricing = _knobs.flag("SELDON_TPU_ADMISSION_PRICING")
        self.admission_pricing = bool(admission_pricing)
        self._prefill_engines: List[PagedEngine] = []
        self._prefill_threads: List[threading.Thread] = []
        self._jobs: "_pyqueue.PriorityQueue[_PrefillJob]" = _pyqueue.PriorityQueue()
        self._workers_stop = False
        self._job_seq = 0
        self._disagg_lock = threading.Lock()

    # ---- lifecycle --------------------------------------------------------

    def _disagg_enabled(self) -> bool:
        return bool(self.prefill_workers or self.prefill_endpoints)

    def load(self) -> None:
        super().load()
        role = _knobs.raw("SELDON_TPU_DISAGG_ROLE", "") or ""
        if role:
            logger.info("disaggregated role pin: %s", role)
        if not self._disagg_enabled():
            return
        with self._disagg_lock:
            if self._prefill_threads:
                return
            if self.prefill_endpoints:
                for i, ep in enumerate(self.prefill_endpoints):
                    self._start_worker(self._remote_prefill_loop, ep, f"disagg-prefill-remote-{i}")
                return
            eng_cfg = dict(self.engine_config)
            # prefill engines never decode: speculative verify and the queue
            # bound belong to the decode engine
            eng_cfg.update(max_slots=self.prefill_slots, speculative=None, max_queue=0)
            # an adapter's prompt prefills with its adapter: the same registry
            registry = self._register_adapters()
            for i in range(self.prefill_workers):
                # the decode engine's URI, config and seed: the same weights,
                # the precondition of an exact handoff
                params = load_lm_params(self.model_uri, self.config, self.seed, self.device)
                eng = PagedEngine(params, dtype=self.dtype, device=self.device, max_adapters=self.max_adapters,
                                  lora_rank=self.lora_rank, weight_registry=registry, **self.config, **eng_cfg)
                self._prefill_engines.append(eng)
                self._start_worker(self._prefill_loop, eng, f"disagg-prefill-{i}")

    def _start_worker(self, target, arg, name: str) -> None:
        t = threading.Thread(target=target, args=(arg,), name=name, daemon=True)
        t.start()
        self._prefill_threads.append(t)

    def shutdown(self) -> None:
        self._workers_stop = True
        super().shutdown()
        for eng in self._prefill_engines:
            try:
                eng.close()
            except Exception:  # noqa: BLE001 — teardown finishes even if a worker's engine failed
                logger.exception("prefill engine close failed")

    # ---- priced admission -------------------------------------------------

    def _price_admission(self, prompt_len: int, max_new: int, deadline: Optional[float]) -> None:
        """Refuse a request whose predicted prefill + decode cost does not
        fit its remaining deadline, before a prefill engine works on it
        (queue-position shedding cannot see service time)."""
        if not self.admission_pricing or deadline is None or self.engine is None:
            return
        cost = self.engine.predict_cost_s(int(prompt_len), int(max_new))
        if cost is None:
            return  # cold engine: nothing measured yet, admit unpriced
        remaining = deadline - time.monotonic()
        if cost > remaining:
            raise MicroserviceError(
                f"admission priced out: predicted prefill+decode cost {cost * 1000.0:.0f} ms exceeds the remaining "
                f"deadline {max(0.0, remaining) * 1000.0:.0f} ms", status_code=504, reason="DEADLINE_UNREACHABLE")

    # ---- prefill workers --------------------------------------------------

    def _enqueue_prefill(self, prompt: np.ndarray, priority: int, submit_kw: Dict[str, Any]) -> _PrefillJob:
        with self._disagg_lock:
            self._job_seq += 1
            job = _PrefillJob(self._job_seq, prompt, priority, submit_kw)
        self._jobs.put(job)
        return job

    def _hand_off_local(self, job: _PrefillJob, payload: Dict[str, Any]) -> None:
        """In-process handoff: the payload's page tensors pass by
        reference into the decode engine, whose page write is the one
        copy; metered as ``method="kv_handoff"`` with ``zero_copy_bytes``."""
        from seldon_core_tpu_torch.engine.transport import kv_handoff_hop

        with kv_handoff_hop("disagg-prefill", "local") as hop:
            if hop is not None:
                hop.zero_copy_bytes = sum(_nbytes(payload[k]) for k in (
                    "k", "v", "last_logits", "prompt", "k_scales", "v_scales") if k in payload)
            job.stream = self.engine.submit_prefilled(payload, **job.submit_kw)
        self._wake.set()

    def _hand_off_container(self, job: _PrefillJob, buf: bytes) -> None:
        """Remote handoff: reopen the received container and admit its
        pages.  The ``transport.corrupt`` chaos point flips bytes here:
        the CRC32C trailer turns a flip into a named refusal the waiter
        sees, never a write of garbage K/V."""
        from seldon_core_tpu_torch.codec.bufview import unpack_kv_handoff
        from seldon_core_tpu_torch.engine.transport import kv_handoff_hop
        from seldon_core_tpu_torch.utils import faults as _faults

        buf = _faults.corrupt_bytes("transport.corrupt", buf)
        with kv_handoff_hop("disagg-prefill", "dcn") as hop:
            if hop is not None:
                hop.request_bytes = len(buf)
            payload = unpack_kv_handoff(buf)
            job.stream = self.engine.submit_prefilled(payload, **job.submit_kw)
        self._wake.set()

    def _next_job(self) -> Optional[_PrefillJob]:
        """The next job to run, or None (none queued, or a cancelled one,
        which is resolved here)."""
        try:
            job = self._jobs.get(timeout=0.2)
        except _pyqueue.Empty:
            return None
        if job.cancelled:
            job.event.set()
            return None
        return job

    def _prefill_loop(self, eng: PagedEngine) -> None:
        """In-process worker: pop a job, prefill-export it on this
        worker's own engine (its only stepper), hand the pages off."""
        if eng.device.type == "cuda":
            torch.cuda.set_device(eng.device)
        while not self._workers_stop:
            job = self._next_job()
            if job is None:
                continue
            try:
                payload = eng.prefill_export(job.prompt, priority=job.priority,
                                             deadline=job.submit_kw.get("deadline"),
                                             adapter=job.submit_kw.get("adapter"))
                if not job.cancelled:  # cancelled mid-export: nothing is admitted
                    self._hand_off_local(job, payload)
            except Exception as exc:  # noqa: BLE001 — the waiter gets it; the worker survives any one job
                job.error = exc
            finally:
                job.event.set()

    def _remote_prefill_loop(self, endpoint: str) -> None:
        """Remote worker: pop a job, call the remote :class:`PrefillLM`
        through the transport clients' model call (``transform_input``),
        hand the returned container off.  One thread an endpoint, with one
        event loop for its lifetime: the gRPC client caches channels bound
        to the loop that made them."""
        import asyncio

        from seldon_core_tpu_torch.engine.graph import Endpoint, UnitSpec
        from seldon_core_tpu_torch.engine.transport import GrpcClient, RestClient
        from seldon_core_tpu_torch.runtime.message import InternalMessage
        from seldon_core_tpu_torch.utils.deadlines import deadline_exceeded

        scheme, sep, rest = endpoint.partition("://")
        if not sep:
            scheme, rest = "grpc", endpoint
        host, _, port = rest.partition(":")
        spec = UnitSpec(name=f"prefill@{rest}", endpoint=Endpoint(
            host=host or "localhost", port=int(port or 9000), transport="REST" if scheme == "rest" else "GRPC"))
        client = RestClient(spec) if scheme == "rest" else GrpcClient(spec)
        loop = asyncio.new_event_loop()
        try:
            while not self._workers_stop:
                job = self._next_job()
                if job is None:
                    continue
                try:
                    # a rawTensor prompt: the reply takes the request's kind, so
                    # the container comes back as raw uint8 bytes, not as a
                    # tensor of doubles eight times its size
                    msg = InternalMessage(payload=np.atleast_2d(job.prompt).astype(np.int32), kind="rawTensor")
                    msg.meta.tags["priority"] = job.priority
                    # the remote prefill runs with the weights this engine decodes with
                    if job.submit_kw.get("adapter"):
                        msg.meta.tags["adapter"] = job.submit_kw["adapter"]
                    # the deadline crosses the hop as the remaining budget; a job
                    # that expired while queued fails here without a remote call
                    deadline = job.submit_kw.get("deadline")
                    if deadline is not None:
                        remaining_ms = (deadline - time.monotonic()) * 1000.0
                        if remaining_ms <= 0:
                            raise deadline_exceeded("disaggregated prefill queue")
                        msg.meta.tags["deadline_ms"] = remaining_ms
                    reply = loop.run_until_complete(client.transform_input(msg))
                    buf = np.ascontiguousarray(reply.host_payload(), dtype=np.uint8).tobytes()
                    if not job.cancelled:  # cancelled mid-call: nothing is admitted
                        self._hand_off_container(job, buf)
                except Exception as exc:  # noqa: BLE001 — the waiter gets it; the worker survives any one job
                    job.error = exc
                finally:
                    job.event.set()
        finally:
            try:
                loop.run_until_complete(client.close())
            except Exception:  # noqa: BLE001 — client teardown is best-effort at exit
                pass
            loop.close()

    # ---- serving fronts ---------------------------------------------------

    def _submit_kw(self, tags, request_seed: int, row: int, **extra) -> Dict[str, Any]:
        """A row's ``submit`` terms: ``StreamingLM.predict``'s tag
        overrides, seed rule, SLO terms and adapter."""
        priority, deadline = self._slo_terms(tags)
        return dict(max_new_tokens=int(tags.get("max_new_tokens", self.max_new_tokens)),
                    temperature=float(tags.get("temperature", self.temperature)),
                    top_k=int(tags.get("top_k", self.top_k)), eos_id=self.eos_id,
                    seed=self.seed ^ (request_seed * 1000003 + row), priority=priority, deadline=deadline,
                    adapter=self._request_adapter(tags), **extra)

    def predict(self, X, names, meta=None):
        if self.engine is None:
            self.load()
        if not self._disagg_enabled():
            return super().predict(X, names, meta)
        meta = meta or {}
        tags = meta.get("tags", {})
        X = np.atleast_2d(np.asarray(X, np.int32))
        request_seed = self._request_seed(tags, meta)
        jobs: List[_PrefillJob] = []
        try:
            for i, row in enumerate(X):
                kw = self._submit_kw(tags, request_seed, i)
                self._price_admission(len(row), kw["max_new_tokens"], kw["deadline"])
                jobs.append(self._enqueue_prefill(row, kw["priority"], kw))
            out = []
            for job in jobs:
                job.event.wait()
                if job.error is not None:
                    raise job.error
                job.stream.event.wait()
                if job.stream.error:
                    raise job.stream.error
                out.append(job.stream.result)
            return np.stack(out)
        except BaseException:
            # one row priced out, shed or failed: queued siblings are
            # flagged so the workers skip them, handed-off ones cancelled
            for job in jobs:
                job.cancelled = True
                s = job.stream
                if s is not None and s.result is None and s.error is None:
                    self.engine.cancel(s)
            raise

    def predict_stream(self, X, names=None, meta=None):
        if self.engine is None:
            self.load()
        if not self._disagg_enabled():
            yield from super().predict_stream(X, names, meta)
            return
        meta = meta or {}
        tags = meta.get("tags", {})
        X = np.atleast_2d(np.asarray(X, np.int32))
        if X.shape[0] != 1:
            raise MicroserviceError("token streaming serves one prompt per stream; send rows separately "
                                    "(predict() batches them)", status_code=400, reason="BAD_REQUEST")
        kw = self._submit_kw(tags, self._request_seed(tags, meta), 0, stream_tokens=True)
        self._price_admission(X.shape[1], kw["max_new_tokens"], kw["deadline"])
        job = self._enqueue_prefill(X[0], kw["priority"], kw)
        job.event.wait()
        if job.error is not None:
            raise job.error
        stream = job.stream
        try:
            while True:
                got = stream.token_queue.get()
                if got is None:
                    break
                yield np.asarray(got, np.int32)
            if stream.error:
                raise stream.error
        finally:
            self.engine.cancel(stream)

    def metrics(self):
        out = super().metrics()
        if self.engine is not None:
            out.append(gauge_metric("paged_kv_imports", self.engine.engine_stats()["kv_imports"]))
        if self._disagg_enabled():
            exports = sum(eng.engine_stats()["kv_exports"] for eng in self._prefill_engines)
            out.append(gauge_metric("paged_prefill_workers",
                                    len(self._prefill_engines) or len(self.prefill_endpoints)))
            out.append(gauge_metric("paged_kv_exports", exports))
        return out
