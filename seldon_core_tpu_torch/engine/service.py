"""Predictor service: the request-facing shell around a GraphExecutor.

Equivalent of the reference's PredictionService + lifecycle endpoints
(reference: PredictionService.java:94-141 — puid assignment, graph
dispatch, response status; RestClientController.java:73-118 —
/ping /ready /live /pause /unpause semantics; App.java:60-97 —
graceful drain).  A request is a ``predictor.predict`` span and a
``predict_done`` event to the executor's observer (the reference's
server request histogram).  ``request_logger`` (a pair sink of
``utils/reqlogger.py``) sees every answered pair on both the async and
the sync path; ``explainer`` (set by whoever builds the deployment)
answers :meth:`PredictorService.explain`.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import threading
import time
from typing import Any, Callable, Dict, Optional

from seldon_core_tpu_torch.engine.executor import GraphExecutor, Observer
from seldon_core_tpu_torch.engine.graph import UnitSpec
from seldon_core_tpu_torch.engine.transport import LocalClient
from seldon_core_tpu_torch.runtime import dispatch
from seldon_core_tpu_torch.runtime.component import MicroserviceError
from seldon_core_tpu_torch.runtime.message import InternalFeedback, InternalMessage
from seldon_core_tpu_torch.runtime.puid import new_puid
from seldon_core_tpu_torch.utils.tracing import maybe_span

logger = logging.getLogger(__name__)


def failure_message(error: Exception, puid: str = "") -> InternalMessage:
    if isinstance(error, MicroserviceError):
        status = error.to_status()
    else:
        status = {"status": "FAILURE", "code": 500, "info": str(error), "reason": "ENGINE_ERROR"}
    msg = InternalMessage(payload=None, kind="jsonData", status=status)
    msg.meta.puid = puid
    return msg


class PredictorService:
    """One deployed predictor: graph executor + lifecycle + bookkeeping."""

    def __init__(self, graph: UnitSpec, name: str = "default", annotations: Optional[Dict[str, str]] = None,
                 observer: Optional[Observer] = None, clients: Optional[Dict[str, Any]] = None,
                 request_logger: Optional[Callable[[InternalMessage, InternalMessage], None]] = None,
                 explainer: Any = None):
        self.name = name
        # `clients`: injected node clients by name (a BalancedClient over
        # a node's replicas), passed through to the executor
        self.executor = GraphExecutor(graph, clients=clients, observer=observer, annotations=annotations)
        self.graph = graph
        self._paused = False
        # threading (not asyncio) primitives: predict_sync runs on gRPC
        # thread-pool threads concurrently with the event loop, so the
        # in-flight count and stats need a real lock or drain() can
        # hang / return early under load
        self._inflight = 0
        self._stats_lock = threading.Lock()
        self._inflight_zero = threading.Event()
        self._inflight_zero.set()
        self.stats = {"requests": 0, "failures": 0, "feedback": 0}
        self.request_logger = request_logger
        self.explainer = explainer

    def _log_pair(self, request: InternalMessage, response: InternalMessage) -> None:
        if self.request_logger is not None:
            try:
                self.request_logger(request, response)
            except Exception:  # noqa: BLE001 — logging loses a pair, never a request
                logger.exception("request logger failed")

    async def explain(self, request: InternalMessage) -> InternalMessage:
        """Run the predictor's explainer in-process (the reference's
        ``:explain`` URL of a deployed alibi explainer)."""
        if self.explainer is None:
            return failure_message(MicroserviceError("predictor has no explainer configured", status_code=404,
                                                     reason="NO_EXPLAINER"))
        from seldon_core_tpu_torch.runtime.executor_pool import run_dispatch

        try:
            result = await run_dispatch(self.explainer.explain, request.host_payload(), request.names)
            out = InternalMessage(payload=result, kind="jsonData", status={"status": "SUCCESS", "code": 200})
            out.meta.puid = request.meta.puid or new_puid()
            return out
        except Exception as e:  # noqa: BLE001 — every failure answers as a Status
            return failure_message(e)

    def _enter_request(self) -> None:
        with self._stats_lock:
            self._inflight += 1
            self._inflight_zero.clear()
            self.stats["requests"] += 1

    def _exit_request(self, failed: bool = False) -> None:
        with self._stats_lock:
            self._inflight -= 1
            if failed:
                self.stats["failures"] += 1
            if self._inflight == 0:
                self._inflight_zero.set()

    @contextlib.contextmanager
    def in_flight(self):
        """Hold the in-flight count ``drain`` waits on for work that
        reaches a component without ``predict`` (the native ingress's fast
        lane), so a drained generation is unloaded only after it."""
        with self._stats_lock:
            self._inflight += 1
            self._inflight_zero.clear()
        try:
            yield
        finally:
            with self._stats_lock:
                self._inflight -= 1
                if self._inflight == 0:
                    self._inflight_zero.set()

    # ------------------------------------------------------------- lifecycle

    @property
    def paused(self) -> bool:
        return self._paused

    def pause(self) -> None:
        """Flip readiness off ahead of shutdown (reference: /pause)."""
        self._paused = True

    def unpause(self) -> None:
        self._paused = False

    async def live(self) -> bool:
        return True

    async def ready(self) -> bool:
        if self._paused:
            return False
        return await self.executor.ready()

    async def drain(self, timeout_s: float = 20.0) -> bool:
        """Pause and wait for in-flight requests
        (reference: App.java:60-97 Tomcat drain)."""
        self.pause()
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(None, self._inflight_zero.wait, timeout_s)

    # --------------------------------------------------------------- serving

    async def predict(self, request: InternalMessage) -> InternalMessage:
        puid = request.meta.puid or new_puid()
        request.meta.puid = puid
        self._enter_request()
        failed = False
        start = time.perf_counter()
        try:
            with maybe_span("predictor.predict", trace_id=puid, predictor=self.name):
                response = await self.executor.predict(request)
            if response.status is None:
                response.status = {"status": "SUCCESS", "code": 200}
            self._log_pair(request, response)
            return response
        except Exception as e:  # noqa: BLE001 — every failure answers as a Status
            failed = True
            logger.exception("predict failed puid=%s", puid)
            return failure_message(e, puid)
        finally:
            self._exit_request(failed)
            self.executor._emit("predict_done", self.name, time.perf_counter() - start)

    # ---- synchronous fast path -------------------------------------------

    def single_local_model(self):
        """(unit, component) when this predictor is one in-process MODEL
        node — the shape eligible for the no-event-loop fast path.  A
        balanced root is not.  As in the JAX package, a ``fallback`` on
        the node is not looked at, so the fast path never takes it
        (``ROADMAP.md`` C16)."""
        unit = self.graph
        if unit.children or unit.type != "MODEL":
            return None
        client = self.executor.clients.get(unit.name)
        if not isinstance(client, LocalClient):
            return None
        return unit, client.component

    def predict_sync(self, request: InternalMessage) -> InternalMessage:
        """Synchronous predict for single-local-MODEL graphs.

        Semantics identical to the async path (puid, requestPath,
        metric collection, status, observer events) but runs entirely
        on the caller's thread — used by the sync gRPC front server to
        bypass asyncio scheduling on the hot path.
        """
        fast = self.single_local_model()
        if fast is None:
            raise MicroserviceError(f"predictor {self.name!r} is not fast-path eligible", reason="NOT_FAST_PATH")
        unit, component = fast
        puid = request.meta.puid or new_puid()
        request.meta.puid = puid
        self._enter_request()
        failed = False
        start = time.perf_counter()
        try:
            response = dispatch.predict(component, request)
            self.executor._emit("node_call", unit.name, ("transform_input", time.perf_counter() - start))
            if response.meta.metrics:
                self.executor._emit("node_metrics", unit.name, response.meta.metrics)
            response.meta.request_path[unit.name] = unit.image or unit.implementation or unit.component_class or "local"
            response.meta.puid = puid
            if response.status is None:
                response.status = {"status": "SUCCESS", "code": 200}
            self._log_pair(request, response)
            return response
        except Exception as e:  # noqa: BLE001 — every failure answers as a Status
            failed = True
            logger.exception("predict failed puid=%s", puid)
            return failure_message(e, puid)
        finally:
            self._exit_request(failed)
            self.executor._emit("predict_done", self.name, time.perf_counter() - start)

    async def send_feedback(self, feedback: InternalFeedback) -> InternalMessage:
        try:
            with self._stats_lock:
                self.stats["feedback"] += 1
            await self.executor.send_feedback(feedback)
            return InternalMessage(payload=None, kind="jsonData", status={"status": "SUCCESS", "code": 200})
        except Exception as e:  # noqa: BLE001 — every failure answers as a Status
            logger.exception("feedback failed")
            return failure_message(e)

    async def close(self) -> None:
        await self.executor.close()
        # the pair logger is this service's for its lifetime: an HTTP
        # logger's drain thread is joined here, or every rolling update
        # leaks one
        logger_close = getattr(self.request_logger, "close", None)
        if callable(logger_close):
            await asyncio.get_running_loop().run_in_executor(None, logger_close)
