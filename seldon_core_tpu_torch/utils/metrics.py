"""Prometheus metrics with the reference's canonical names, on a registry of the port's own.

The port's counterpart of the ``ROADMAP.md`` §A item 4 part of
``seldon_core_tpu/utils/metrics.py``.  The reference engine exposes the
histograms ``seldon_api_engine_server_requests_duration_seconds`` and
``..._client_requests_duration_seconds``, the feedback counters
``seldon_api_model_feedback(_reward)``, and re-registers each node's
custom metrics with deployment / predictor / model labels (reference:
doc/source/analytics/analytics.md:9-16, PredictiveUnitBean.java:323-357);
the same names and labels here, so the repo's Grafana dashboards
(``monitoring/``) read a port deployment unchanged.

The JAX module sits on ``prometheus_client``; the port keeps a small
registry of its own (counter, gauge and histogram families keyed by name
and label names, the JAX module's ``_BUCKETS``) and renders the
Prometheus text exposition 0.0.4 as ``prometheus_client`` writes it:
``_total`` on counters, ``_bucket{le=...}`` / ``_count`` / ``_sum`` on
histograms, a ``_created`` gauge beside each, labels in sorted order and
Go float formatting.  The hot path is a dict lookup for a bound child and
a short-lock add: label values are resolved once per identity, never
formatted per request.

Scrape-time collectors render what lives outside the registry under its
current names: a component's custom metrics (``CudaServer``'s
``cudaserver_*`` gauges, ``StreamingLM``'s ``paged_*``) and the
gateway's per-predictor counts (``engine/server.py``).

The failure-containment series (breaker state and transitions,
fast-fails, hedges, replica failovers; ``engine/transport.py``) keep the
JAX module's names, labels and help strings, so the repo's
``BreakerStuckOpen`` alert and the dashboard's breaker panel read them.

Left out, each with its item: the generation engine and fleet bridges
(``GenerationPrometheusBridge``, ``FleetPrometheusBridge``; 8.11); worker
health, ``api_latency_sampler`` and ``HistogramQuantileSampler`` (A13);
trace exemplars, which the text format 0.0.4 does not carry (8.11).
"""

from __future__ import annotations

import bisect
import logging
import math
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

CONTENT_TYPE_LATEST = "text/plain; version=0.0.4; charset=utf-8"

# a family as the exposition sees it: (name, kind, documentation,
# samples), each sample (sample name, sorted label pairs, value)
Sample = Tuple[str, Tuple[Tuple[str, str], ...], float]
FamilySnapshot = Tuple[str, str, str, List[Sample]]


def _go_float(d: float) -> str:
    """A value as Go (and ``prometheus_client``) formats it."""
    d = float(d)
    if d == math.inf:
        return "+Inf"
    if d == -math.inf:
        return "-Inf"
    if math.isnan(d):
        return "NaN"
    s = repr(d)
    dot = s.find(".")
    if d > 0 and dot > 6:  # Go switches to exponents sooner than Python
        mantissa = f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return s


def _escape_label(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r"\"")


def _escape_help(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n")


class _Value:
    """One counter or gauge series."""

    __slots__ = ("_lock", "_value", "created")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0
        self.created = time.time()

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    def set(self, value: float) -> None:
        self._value = float(value)

    def get(self) -> float:
        return self._value


class _Counter(_Value):
    __slots__ = ()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters can only be incremented by non-negative amounts")
        with self._lock:
            self._value += amount


class _HistogramSeries:
    """One histogram series: per-bucket counts (not cumulative) and the sum."""

    __slots__ = ("_lock", "_upper", "_counts", "_sum", "created")

    def __init__(self, upper: Sequence[float]) -> None:
        self._lock = threading.Lock()
        self._upper = upper
        self._counts = [0] * len(upper)
        self._sum = 0.0
        self.created = time.time()

    def observe(self, value: float) -> None:
        i = bisect.bisect_left(self._upper, value)  # buckets are inclusive upper bounds
        with self._lock:
            self._counts[i] += 1
            self._sum += value

    def snapshot(self) -> Tuple[List[int], float]:
        with self._lock:
            return list(self._counts), self._sum


class Family:
    """A metric family: one name, fixed label names, one series per label values."""

    def __init__(self, kind: str, name: str, documentation: str, labelnames: Sequence[str],
                 buckets: Sequence[float] = _BUCKETS):
        if kind == "counter" and name.endswith("_total"):
            name = name[:-6]  # prometheus_client's rule: the sample carries the suffix
        self.kind = kind
        self.name = name
        self.documentation = documentation
        self.labelnames = tuple(labelnames)
        self._upper = tuple(sorted(float(b) for b in buckets)) + (math.inf,) if kind == "histogram" else ()
        self._series: Dict[Tuple[str, ...], Any] = {}
        self._lock = threading.Lock()
        if not self.labelnames:  # a label-less family shows its one series at once
            self.labels()

    def _new_series(self):
        if self.kind == "histogram":
            return _HistogramSeries(self._upper)
        return _Counter() if self.kind == "counter" else _Value()

    def labels(self, *values: Any, **kw: Any):
        """The series of one label-value tuple (created on first use)."""
        if kw:
            key = tuple(str(kw[n]) for n in self.labelnames)
        else:
            key = tuple(str(v) for v in values)
        series = self._series.get(key)
        if series is None:
            if len(key) != len(self.labelnames):
                raise ValueError(f"{self.name}: expected labels {self.labelnames}, got {key}")
            with self._lock:
                series = self._series.setdefault(key, self._new_series())
        return series

    def collect(self) -> List[FamilySnapshot]:
        with self._lock:
            items = list(self._series.items())
        main: List[Sample] = []
        created: List[Sample] = []
        for key, series in items:
            base = tuple(zip(self.labelnames, key))
            labels = tuple(sorted(base))
            if self.kind == "histogram":
                counts, total = series.snapshot()
                acc = 0
                for upper, n in zip(self._upper, counts):
                    acc += n
                    main.append((self.name + "_bucket", tuple(sorted(base + (("le", _go_float(upper)),))),
                                 float(acc)))
                main.append((self.name + "_count", labels, float(acc)))
                main.append((self.name + "_sum", labels, total))
            else:
                main.append((self.name + "_total" if self.kind == "counter" else self.name, labels, series.get()))
            if self.kind != "gauge":
                created.append((self.name + "_created", labels, series.created))
        exposed = self.name + "_total" if self.kind == "counter" else self.name
        out = [(exposed, self.kind, self.documentation, main)]
        if self.kind != "gauge":
            out.append((self.name + "_created", "gauge", self.documentation, created))
        return out


class Registry:
    """Families by name; a name is registered once, with one kind and one
    set of label names (``prometheus_client`` raises on a duplicate too)."""

    def __init__(self) -> None:
        self._families: Dict[str, Family] = {}
        self._lock = threading.Lock()

    def family(self, kind: str, name: str, labelnames: Sequence[str] = (), documentation: str = "",
               buckets: Sequence[float] = _BUCKETS) -> Family:
        key = name[:-6] if kind == "counter" and name.endswith("_total") else name
        with self._lock:
            fam = self._families.get(key)
            if fam is None:
                fam = Family(kind, name, documentation or name, labelnames, buckets)
                self._families[key] = fam
            elif fam.kind != kind or fam.labelnames != tuple(labelnames):
                raise ValueError(f"Duplicated timeseries in the registry: {name!r} is a {fam.kind} of "
                                 f"{fam.labelnames}, asked for a {kind} of {tuple(labelnames)}")
        return fam

    def collect(self) -> List[FamilySnapshot]:
        with self._lock:
            families = list(self._families.values())
        return [snap for fam in families for snap in fam.collect()]


REGISTRY = Registry()

# a scrape-time source of families outside the registry
Collector = Callable[[], Iterable[FamilySnapshot]]


def exposition(snapshots: Iterable[FamilySnapshot]) -> str:
    """Prometheus text exposition 0.0.4 of family snapshots.  A family
    seen twice is rendered once: samples of the same kind join the first
    one, a family of another kind under a taken name is dropped (a scrape
    must not repeat a ``# TYPE``)."""
    families: Dict[str, FamilySnapshot] = {}
    for name, kind, doc, samples in snapshots:
        first = families.get(name)
        if first is None:
            families[name] = (name, kind, doc, list(samples))
        elif first[1] == kind:
            first[3].extend(samples)
    lines: List[str] = []
    for name, kind, doc, samples in families.values():
        lines.append(f"# HELP {name} {_escape_help(doc)}")
        lines.append(f"# TYPE {name} {kind}")
        for sample, labels, value in samples:
            if labels:
                text = ",".join(f'{k}="{_escape_label(v)}"' for k, v in labels)
                lines.append(f"{sample}{{{text}}} {_go_float(value)}")
            else:
                lines.append(f"{sample} {_go_float(value)}")
    return "\n".join(lines) + "\n" if lines else ""


def generate_latest(registry: Optional[Registry] = None, collectors: Sequence[Collector] = ()) -> bytes:
    """The registry's families, then each collector's."""
    reg = registry if registry is not None else REGISTRY
    snaps: List[FamilySnapshot] = list(reg.collect())
    for collector in collectors:
        try:
            snaps.extend(collector())
        except Exception:  # noqa: BLE001 — one broken collector must not blank the scrape
            logger.exception("metrics collector failed")
    return exposition(snaps).encode()


def custom_metric_families(metrics: Iterable[Dict[str, Any]],
                           labels: Optional[Dict[str, str]] = None) -> List[FamilySnapshot]:
    """Families of a component's custom metrics under their own keys:
    COUNTER as a counter, GAUGE as a gauge, TIMER as a gauge in ms.
    ``labels`` are added to every sample (the gateway names the unit)."""
    families: Dict[str, FamilySnapshot] = {}
    for m in metrics or []:
        name = str(m["key"])
        kind = "counter" if m.get("type", "COUNTER") == "COUNTER" else "gauge"
        tags = {**{str(k): str(v) for k, v in (m.get("tags") or {}).items()}, **(labels or {})}
        fam = families.setdefault(name, (name, kind, name, []))
        fam[3].append((name, tuple(sorted(tags.items())), float(m["value"])))
    return list(families.values())


# ---------------------------------------------------------------------------
# the reference's engine metrics
# ---------------------------------------------------------------------------

class _MetricCache:
    """Families keyed by (kind, name, label names) on one registry."""

    def __init__(self, registry: Optional[Registry] = None):
        self.registry = registry if registry is not None else REGISTRY
        self._cache: Dict[Tuple[str, str, Tuple[str, ...]], Family] = {}
        self._lock = threading.Lock()

    def get(self, kind: str, name: str, labelnames: Tuple[str, ...], documentation: str = "") -> Family:
        key = (kind, name, labelnames)
        metric = self._cache.get(key)
        if metric is None:
            with self._lock:
                metric = self._cache.get(key)
                if metric is None:
                    metric = self.registry.family(kind, name, labelnames, documentation or name)
                    self._cache[key] = metric
        return metric


# one cache per registry: observers sharing a registry (two predictors of
# one deployment) share the families and differ only in label values
_CACHES: Dict[int, _MetricCache] = {}
_CACHES_LOCK = threading.Lock()


def _cache_for(registry: Optional[Registry] = None) -> _MetricCache:
    reg = registry if registry is not None else REGISTRY
    with _CACHES_LOCK:
        cache = _CACHES.get(id(reg))
        if cache is None:
            cache = _MetricCache(reg)
            _CACHES[id(reg)] = cache
        return cache


def increment_counter(name: str, documentation: str = "", registry: Optional[Registry] = None) -> None:
    """Label-less counter increment against the (default) registry.
    Never raises: metrics must not break the data path; failures are
    logged so a broken counter is visible, not silent."""
    try:
        _cache_for(registry).get("counter", name, (), documentation).labels().inc()
    except Exception:  # noqa: BLE001 — a broken counter is logged, never fatal
        logger.exception("failed to increment counter %s", name)


class PrometheusObserver:
    """Engine observer -> the registry.

    Handles the executor / service event stream:
      * ``predict_done`` (payload: seconds) -> server request histogram
      * ``node_call`` (payload: (method, seconds)) -> client request histogram
      * ``node_metrics`` (payload: list of metric dicts) -> custom
        counters / gauges / timers tagged deployment / predictor / model
      * ``node_feedback`` (payload: reward) -> feedback counters

    Each series is bound once per label identity and kept, so an event
    is a dict lookup and one add.
    """

    def __init__(self, deployment_name: str = "", predictor_name: str = "",
                 registry: Optional[Registry] = None):
        self.deployment_name = deployment_name
        self.predictor_name = predictor_name
        self._cache = _cache_for(registry)
        self._bound: Dict[tuple, Any] = {}

    def _model_labels(self, unit: str) -> Dict[str, str]:
        return {
            "deployment_name": self.deployment_name,
            "predictor_name": self.predictor_name,
            "model_name": unit,
        }

    def _series(self, key: tuple, kind: str, name: str, labels: Dict[str, str], doc: str = ""):
        series = self._bound.get(key)
        if series is None:
            series = self._cache.get(kind, name, tuple(sorted(labels)), doc).labels(**labels)
            self._bound[key] = series
        return series

    def __call__(self, event: str, unit: str, payload: Any) -> None:
        try:
            if event == "predict_done":
                self.observe_api("predictions", float(payload))
            elif event == "node_call":
                method, seconds = payload
                self.observe_node_call(unit, method, float(seconds))
            elif event == "node_metrics":
                for metric in payload or []:
                    self._apply_custom(unit, metric)
            elif event == "node_feedback":
                labels = self._model_labels(unit)
                self._series(("feedback", unit), "counter", "seldon_api_model_feedback", labels).inc()
                self._series(("reward", unit), "counter", "seldon_api_model_feedback_reward",
                             labels).inc(float(payload or 0.0))
        except Exception:  # noqa: BLE001 — observers must never break the data plane
            logger.exception("metrics observer failed for %s/%s", event, unit)

    def observe_api(self, method: str, seconds: float, code: str = "200") -> None:
        series = self._bound.get(("api", method, code))
        if series is None:
            labels = {"deployment_name": self.deployment_name, "predictor_name": self.predictor_name,
                      "method": method, "code": code}
            series = self._series(("api", method, code), "histogram",
                                  "seldon_api_engine_server_requests_duration_seconds", labels,
                                  "external API request latency")
        series.observe(seconds)

    def observe_node_call(self, unit: str, method: str, seconds: float) -> None:
        series = self._bound.get(("node", unit, method))
        if series is None:
            labels = dict(self._model_labels(unit), method=method)
            series = self._series(("node", unit, method), "histogram",
                                  "seldon_api_engine_client_requests_duration_seconds", labels,
                                  "engine->node call latency")
        series.observe(seconds)

    def _apply_custom(self, unit: str, metric: Dict[str, Any]) -> None:
        key = metric.get("key")
        if not key:
            return
        mtype = metric.get("type", "COUNTER")
        tags = metric.get("tags") or {}
        ident = ("custom", unit, key, mtype, tuple(sorted((str(k), str(v)) for k, v in tags.items())))
        series = self._bound.get(ident)
        if series is None:
            labels = self._model_labels(unit)
            labels.update({str(k): str(v) for k, v in tags.items()})
            kind = {"COUNTER": "counter", "GAUGE": "gauge", "TIMER": "histogram"}.get(mtype)
            if kind is None:
                return
            series = self._series(ident, kind, key, labels)
        value = float(metric.get("value", 0.0))
        if mtype == "COUNTER":
            series.inc(value)
        elif mtype == "GAUGE":
            series.set(value)
        else:  # TIMER: milliseconds, like the reference
            series.observe(value / 1000.0)


# ---------------------------------------------------------------------------
# per-hop transport telemetry (engine -> node clients)
# ---------------------------------------------------------------------------

TRANSPORT_LABELS = ("unit", "method", "transport")

# HopRecord field -> (kind, canonical metric name, doc); the JAX
# module's table, so a hop's series are the same in both packages
TRANSPORT_METRICS: Dict[str, Tuple[str, str, str]] = {
    "requests": ("counter", "seldon_tpu_transport_requests_total",
                 "node-client calls issued (one per NodeClient method call)"),
    "errors": ("counter", "seldon_tpu_transport_errors_total",
               "node-client calls that raised after exhausting retries"),
    "retries": ("counter", "seldon_tpu_transport_retries_total",
                "extra attempts beyond the first (REST/gRPC retry loops)"),
    "failovers": ("counter", "seldon_tpu_transport_failovers_total",
                  "replica failovers by BalancedClient"),
    "request_bytes": ("counter", "seldon_tpu_transport_request_bytes_total",
                      "serialized request payload bytes put on the wire"),
    "response_bytes": ("counter", "seldon_tpu_transport_response_bytes_total",
                       "serialized response payload bytes read off the wire"),
    "zero_copy_bytes": ("counter", "seldon_tpu_transport_zero_copy_bytes_total",
                        "payload bytes passed BY REFERENCE on co-located "
                        "hops (buffer views / device handles) — the bytes "
                        "the zero-copy lane did NOT re-encode"),
    "serialize_seconds": ("histogram", "seldon_tpu_transport_serialize_seconds",
                          "encode+decode (codec) share of one hop"),
    "network_seconds": ("histogram", "seldon_tpu_transport_network_seconds",
                        "on-the-wire share of one hop (total - codec)"),
}

# label-shaped fields of HopRecord, not exported as their own series
TRANSPORT_RECORD_EXCLUDED = {"unit", "method", "transport", "error"}

TRANSPORT_INFLIGHT_METRIC = "seldon_tpu_transport_inflight"


def transport_telemetry_enabled() -> bool:
    """SELDON_TPU_TRANSPORT_TELEMETRY=0 turns the per-hop metrics off."""
    from seldon_core_tpu_torch.runtime import knobs

    return knobs.flag("SELDON_TPU_TRANSPORT_TELEMETRY")


class _BoundHop:
    """The series of one (unit, method, transport), bound once: a hop
    record is then a handful of plain adds."""

    __slots__ = tuple(TRANSPORT_METRICS) + ("inflight",)

    def __init__(self, unit: str, method: str, transport: str, registry: Optional[Registry] = None):
        cache = _cache_for(registry)
        labels = {"unit": unit, "method": method, "transport": transport}
        for name, (kind, metric, doc) in TRANSPORT_METRICS.items():
            setattr(self, name, cache.get(kind, metric, TRANSPORT_LABELS, doc).labels(**labels))
        self.inflight = cache.get(
            "gauge", TRANSPORT_INFLIGHT_METRIC, TRANSPORT_LABELS,
            "node-client calls currently awaiting a response",
        ).labels(**labels)


_BOUND_HOPS: Dict[Tuple[str, str, str, int], _BoundHop] = {}
_BOUND_HOPS_LOCK = threading.Lock()


def _bound_hop(unit: str, method: str, transport: str, registry: Optional[Registry] = None) -> _BoundHop:
    key = (unit, method, transport, id(registry))
    hop = _BOUND_HOPS.get(key)
    if hop is None:
        with _BOUND_HOPS_LOCK:
            hop = _BOUND_HOPS.get(key)
            if hop is None:
                hop = _BoundHop(unit, method, transport, registry)
                _BOUND_HOPS[key] = hop
    return hop


def record_transport_hop(
    unit: str,
    method: str,
    transport: str,
    *,
    request_bytes: int = 0,
    response_bytes: int = 0,
    zero_copy_bytes: int = 0,
    serialize_seconds: float = 0.0,
    network_seconds: float = 0.0,
    retries: int = 0,
    error: bool = False,
    registry: Optional[Registry] = None,
) -> None:
    """Record one completed NodeClient hop.  Never raises: transport
    telemetry must not take the data plane down."""
    if not transport_telemetry_enabled():
        return
    try:
        hop = _bound_hop(unit, method, transport, registry)
        hop.requests.inc()
        if error:
            hop.errors.inc()
        if retries > 0:
            hop.retries.inc(retries)
        if request_bytes > 0:
            hop.request_bytes.inc(request_bytes)
        if response_bytes > 0:
            hop.response_bytes.inc(response_bytes)
        if zero_copy_bytes > 0:
            hop.zero_copy_bytes.inc(zero_copy_bytes)
        if transport != "local":
            # the local transport has no codec or wire share by design;
            # a constant 0.0 would poison the histograms' lower buckets
            hop.serialize_seconds.observe(max(0.0, serialize_seconds))
            hop.network_seconds.observe(max(0.0, network_seconds))
    except Exception:  # noqa: BLE001 — telemetry never fails the hop
        logger.exception("transport telemetry failed for %s/%s", unit, method)


def record_transport_failover(unit: str, method: str, transport: str = "balanced",
                              registry: Optional[Registry] = None) -> None:
    """One replica failover (``BalancedClient``), counted apart from the
    requests: the failed call already recorded its own hop."""
    if not transport_telemetry_enabled():
        return
    try:
        kind, name, doc = TRANSPORT_METRICS["failovers"]
        _cache_for(registry).get(kind, name, TRANSPORT_LABELS, doc).labels(
            unit=unit, method=method, transport=transport).inc()
    except Exception:  # noqa: BLE001 — telemetry never fails the failover
        logger.exception("transport failover counter failed for %s/%s", unit, method)


def transport_inflight(unit: str, method: str, transport: str, registry: Optional[Registry] = None):
    """The in-flight gauge of one (unit, method, transport), or None when
    telemetry is off.  Callers inc() / dec() around the await, so a
    wedged upstream shows as a stuck positive gauge."""
    if not transport_telemetry_enabled():
        return None
    try:
        return _bound_hop(unit, method, transport, registry).inflight
    except Exception:  # noqa: BLE001 — telemetry never fails the hop
        logger.exception("transport inflight gauge failed for %s/%s", unit, method)
        return None


# ---------------------------------------------------------------------------
# failure containment: circuit breakers and hedged requests
# ---------------------------------------------------------------------------

# the breaker state gauge's encoding (the alert rules key on it)
BREAKER_STATE_CODES = {"closed": 0, "half_open": 1, "open": 2}

BREAKER_STATE_METRIC = "seldon_tpu_transport_breaker_state"
BREAKER_TRANSITIONS_METRIC = "seldon_tpu_transport_breaker_transitions_total"
BREAKER_FASTFAIL_METRIC = "seldon_tpu_transport_breaker_fastfail_total"
HEDGES_METRIC = "seldon_tpu_transport_hedges_total"
HEDGE_WINS_METRIC = "seldon_tpu_transport_hedge_wins_total"


def record_breaker_state(endpoint: str, state: str, registry: Optional[Registry] = None) -> None:
    """Set an endpoint's breaker state gauge and count the transition;
    called on each state change, so its cost follows incidents, not
    traffic.  Never raises."""
    if not transport_telemetry_enabled():
        return
    try:
        cache = _cache_for(registry)
        cache.get("gauge", BREAKER_STATE_METRIC, ("endpoint",),
                  "circuit-breaker state per endpoint (0 closed, 1 half-open, 2 open)",
                  ).labels(endpoint=endpoint).set(BREAKER_STATE_CODES.get(state, 0))
        cache.get("counter", BREAKER_TRANSITIONS_METRIC, ("endpoint", "to"),
                  "circuit-breaker state transitions").labels(endpoint=endpoint, to=state).inc()
    except Exception:  # noqa: BLE001 — telemetry never fails the breaker
        logger.exception("breaker state metric failed for %s", endpoint)


def record_breaker_fastfail(unit: str, method: str, transport: str, registry: Optional[Registry] = None) -> None:
    """One call rejected before dispatch because its endpoint's breaker
    was open (or half-open past its probes).  Never raises."""
    if not transport_telemetry_enabled():
        return
    try:
        _cache_for(registry).get(
            "counter", BREAKER_FASTFAIL_METRIC, TRANSPORT_LABELS,
            "calls fast-failed by an open circuit breaker before dispatch",
        ).labels(unit=unit, method=method, transport=transport).inc()
    except Exception:  # noqa: BLE001 — telemetry never fails the fast-fail
        logger.exception("breaker fastfail counter failed for %s/%s", unit, method)


def record_transport_hedge(unit: str, method: str, transport: str, won: bool = False,
                           registry: Optional[Registry] = None) -> None:
    """One hedge duplicate fired (``won=False``) or one hedge that
    answered first (``won=True``: the win rate is a ratio of two
    counters).  Never raises."""
    if not transport_telemetry_enabled():
        return
    try:
        name, doc = ((HEDGE_WINS_METRIC, "hedged duplicates that returned first") if won else
                     (HEDGES_METRIC, "hedged duplicate requests fired after the per-node hedge delay"))
        _cache_for(registry).get("counter", name, TRANSPORT_LABELS, doc).labels(
            unit=unit, method=method, transport=transport).inc()
    except Exception:  # noqa: BLE001 — telemetry never fails the hedge
        logger.exception("hedge counter failed for %s/%s", unit, method)
