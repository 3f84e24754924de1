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

:class:`GenerationPrometheusBridge` exports a ``PagedEngine``'s
``engine_stats()`` and flight-recorder records as the canonical
``seldon_tpu_engine_*`` series (``ENGINE_STATS_METRICS``, the JAX
module's names where the keys are shared).  A histogram observation may
carry a trace exemplar; the text format 0.0.4 has no syntax for one, so
only :func:`openmetrics_exposition` (OpenMetrics 1.0, served when a
scrape's ``Accept`` asks for ``application/openmetrics-text``) renders
them.

Left out, each with its item: the fleet bridge (``FleetPrometheusBridge``,
which reads the control plane's fleet view) with A13; worker health,
``api_latency_sampler`` and ``HistogramQuantileSampler`` (A13).
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
CONTENT_TYPE_OPENMETRICS = "application/openmetrics-text; version=1.0.0; charset=utf-8"

# a family as the exposition sees it: (name, kind, documentation,
# samples), each sample (sample name, sorted label pairs, value); a
# histogram's bucket samples collected with exemplars carry a fourth
# element, the bucket's exemplar (labels, value, timestamp) or None
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
    """One histogram series: per-bucket counts (not cumulative), the sum,
    and each bucket's latest exemplar (OpenMetrics keeps one a bucket)."""

    __slots__ = ("_lock", "_upper", "_counts", "_sum", "_exemplars", "created")

    def __init__(self, upper: Sequence[float]) -> None:
        self._lock = threading.Lock()
        self._upper = upper
        self._counts = [0] * len(upper)
        self._sum = 0.0
        self._exemplars: List[Optional[Tuple[Dict[str, str], float, float]]] = [None] * len(upper)
        self.created = time.time()

    def observe(self, value: float, exemplar: Optional[Dict[str, str]] = None) -> None:
        """One observation; ``exemplar`` (e.g. ``{"trace_id": ...}``)
        links the bucket it lands in to one real request."""
        i = bisect.bisect_left(self._upper, value)  # buckets are inclusive upper bounds
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            if exemplar:
                self._exemplars[i] = (dict(exemplar), float(value), time.time())

    def snapshot(self) -> Tuple[List[int], float]:
        with self._lock:
            return list(self._counts), self._sum

    def exemplars(self) -> list:
        with self._lock:
            return list(self._exemplars)


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

    def collect(self, exemplars: bool = False) -> List[FamilySnapshot]:
        """The family's snapshots; ``exemplars`` gives each histogram
        bucket sample a fourth element, its exemplar or None."""
        with self._lock:
            items = list(self._series.items())
        main: List[Sample] = []
        created: List[Sample] = []
        for key, series in items:
            base = tuple(zip(self.labelnames, key))
            labels = tuple(sorted(base))
            if self.kind == "histogram":
                counts, total = series.snapshot()
                marks = series.exemplars() if exemplars else [None] * len(counts)
                acc = 0
                for upper, n, mark in zip(self._upper, counts, marks):
                    acc += n
                    sample = (self.name + "_bucket", tuple(sorted(base + (("le", _go_float(upper)),))), float(acc))
                    main.append(sample + (mark,) if exemplars else sample)
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

    def collect(self, exemplars: bool = False) -> List[FamilySnapshot]:
        with self._lock:
            families = list(self._families.values())
        return [snap for fam in families for snap in fam.collect(exemplars)]


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
        for sample in samples:
            lines.append(_sample_line(sample))
    return "\n".join(lines) + "\n" if lines else ""


def _label_text(labels) -> str:
    return ",".join(f'{k}="{_escape_label(str(v))}"' for k, v in labels)


def _sample_line(sample) -> str:
    name, labels, value = sample[:3]
    return f"{name}{{{_label_text(labels)}}} {_go_float(value)}" if labels else f"{name} {_go_float(value)}"


def openmetrics_exposition(snapshots: Iterable[FamilySnapshot]) -> str:
    """OpenMetrics 1.0 text of family snapshots: a counter's family is
    named without its ``_total`` (a counter whose samples lack the suffix
    is typed ``unknown``), each ``_created`` gauge family joins the
    counter or histogram it belongs to, histogram buckets carry their
    exemplars (``# {trace_id="..."} value timestamp``), and the text ends
    with ``# EOF``."""
    families: Dict[str, list] = {}
    for name, kind, doc, samples in snapshots:
        first = families.get(name)
        if first is None:
            families[name] = [name, kind, doc, list(samples)]
        elif first[1] == kind:
            first[3].extend(samples)
    for name in [n for n, f in families.items() if n.endswith("_created") and f[1] == "gauge"]:
        base = name[: -len("_created")]
        owner = families.get(base + "_total") or families.get(base)
        if owner is not None and owner[1] in ("counter", "histogram"):
            owner[3].extend(families.pop(name)[3])
    lines: List[str] = []
    for name, kind, doc, samples in families.values():
        if kind == "counter":
            if name.endswith("_total") and all(s[0] in (name, name[:-6] + "_created") for s in samples):
                name = name[:-6]
            else:
                kind = "unknown"
        lines.append(f"# HELP {name} {_escape_help(doc)}")
        lines.append(f"# TYPE {name} {kind}")
        for sample in samples:
            line = _sample_line(sample)
            mark = sample[3] if len(sample) > 3 else None
            if mark is not None:
                ex_labels, ex_value, ex_t = mark
                line += f" # {{{_label_text(sorted(ex_labels.items()))}}} {_go_float(ex_value)} {ex_t:.3f}"
            lines.append(line)
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


def wants_openmetrics(accept: Optional[str]) -> bool:
    """Whether a scrape's ``Accept`` header asks for OpenMetrics."""
    return "application/openmetrics-text" in (accept or "")


def generate_latest(registry: Optional[Registry] = None, collectors: Sequence[Collector] = (),
                    openmetrics: bool = False) -> bytes:
    """The registry's families, then each collector's: the text format
    0.0.4, or with ``openmetrics`` OpenMetrics 1.0 with exemplars."""
    reg = registry if registry is not None else REGISTRY
    snaps: List[FamilySnapshot] = list(reg.collect(exemplars=openmetrics))
    for collector in collectors:
        try:
            snaps.extend(collector())
        except Exception:  # noqa: BLE001 — one broken collector must not blank the scrape
            logger.exception("metrics collector failed")
    return (openmetrics_exposition(snaps) if openmetrics else exposition(snaps)).encode()


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
            # a constant 0.0 would poison the histograms' lower buckets.
            # The wire share carries the active trace as its exemplar (the
            # hop runs inside the caller's span)
            hop.serialize_seconds.observe(max(0.0, serialize_seconds))
            hop.network_seconds.observe(max(0.0, network_seconds), exemplar=_trace_exemplar())
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


# ---------------------------------------------------------------------------
# the generation engine's bridge
# ---------------------------------------------------------------------------

# PagedEngine.engine_stats() key -> (kind, canonical metric name, doc).
# Complete by contract: every key engine_stats() can return is here or in
# ENGINE_STATS_EXCLUDED (tests/test_torch_port_telemetry.py), so a new
# counter cannot skip export.  Keys the JAX engine shares keep its names
# and help strings; the port's own keys follow, ``active`` / ``queued``
# under the JAX names of ``active_slots`` / ``queued_streams``.
ENGINE_STATS_METRICS: Dict[str, Tuple[str, str, str]] = {
    "chunks": ("counter", "seldon_tpu_engine_chunks_total",
         "decode/verify chunk programs executed"),
    "tokens": ("counter", "seldon_tpu_engine_tokens_total",
         "tokens emitted by the generation engine"),
    "prefills": ("counter", "seldon_tpu_engine_prefills_total",
         "streams admitted and prefilled"),
    "completed": ("counter", "seldon_tpu_engine_streams_completed_total",
         "streams finished (result delivered)"),
    "evictions": ("counter", "seldon_tpu_engine_evictions_total",
         "streams evicted to the queue under pool pressure"),
    "stalls": ("counter", "seldon_tpu_engine_stalls_total",
         "stream-chunk stalls on pool pressure"),
    "prefix_hits": ("counter", "seldon_tpu_engine_prefix_cache_hits_total",
         "admissions that mapped >=1 cached prefix page"),
    "prefix_misses": ("counter", "seldon_tpu_engine_prefix_cache_misses_total",
         "admissions with no cached prefix to reuse"),
    "prefix_evictions": ("counter", "seldon_tpu_engine_prefix_cache_evictions_total",
         "LRU-cached prefix pages reclaimed under pool pressure"),
    "prefix_tokens_saved": ("counter", "seldon_tpu_engine_prefix_cache_tokens_saved_total",
         "prompt tokens whose prefill was skipped via cached prefix pages"),
    "shed": ("counter", "seldon_tpu_engine_shed_total",
         "streams dropped by the bounded queue's shedding policy"),
    "expired": ("counter", "seldon_tpu_engine_expired_total",
         "streams whose end-to-end deadline expired (queued or mid-decode)"),
    "preempted": ("counter", "seldon_tpu_engine_preempted_total",
         "streams preemptively evicted for a higher-priority admission"),
    "restored": ("counter", "seldon_tpu_engine_restored_total",
         "preempted streams re-admitted (progress restored)"),
    "prefill_tokens": ("counter", "seldon_tpu_engine_prefill_tokens_total",
         "prompt tokens whose KV was computed by prefill programs (cache hits and KV "
         "imports excluded)"),
    "prefill_chunks": ("counter", "seldon_tpu_engine_prefill_chunks_total",
         "prefill device calls (whole prompts and token-budget chunk slices alike)"),
    "adapter_loads": ("counter", "seldon_tpu_engine_adapter_loads_total",
         "adapters installed into the engine's factor pool (cold loads + explicit warm- "
         "ups)"),
    "adapter_hits": ("counter", "seldon_tpu_engine_adapter_hits_total",
         "adapter-carrying submits that found their adapter resident in the pool"),
    "adapter_misses": ("counter", "seldon_tpu_engine_adapter_misses_total",
         "adapter-carrying submits that had to cold-load through the weight registry"),
    "adapter_evictions": ("counter", "seldon_tpu_engine_adapter_evictions_total",
         "refcount-0 adapters LRU-reclaimed from the factor pool to make room for a cold "
         "load"),
    "bucketed_chunks": ("counter", "seldon_tpu_engine_bucketed_chunks_total",
         "chunks that ran the length-bucketed ctx gather"),
    "spec_drafted": ("counter", "seldon_tpu_engine_spec_drafted_total",
         "speculative tokens drafted"),
    "spec_accepted": ("counter", "seldon_tpu_engine_spec_accepted_total",
         "speculative tokens accepted by verify"),
    "drained": ("counter", "seldon_tpu_engine_drained_total",
         "live streams journaled (and error-terminated) by an engine drain for handoff to "
         "a respawned engine"),
    "replayed": ("counter", "seldon_tpu_engine_replayed_total",
         "journaled streams re-submitted into this engine (the restore half of "
         "drain/handoff)"),
    "kv_exports": ("counter", "seldon_tpu_engine_kv_exports_total",
         "prefills exported as KV-page handoff payloads (prefill-worker role)"),
    "kv_imports": ("counter", "seldon_tpu_engine_kv_imports_total",
         "KV-page payloads scatter-written into this pool (decode-worker role)"),
    "migrated_out": ("counter", "seldon_tpu_engine_migrated_out_total",
         "mid-decode streams live-exported to a peer engine (KV pages + cursors + RNG "
         "state)"),
    "migrated_in": ("counter", "seldon_tpu_engine_migrated_in_total",
         "migrated streams imported and resumed at the exact next token on this engine"),
    "chunk_faults": ("counter", "seldon_tpu_engine_chunk_faults_total",
         "chunk failures contained without fail_all (fault injection / graceful "
         "degradation)"),
    "quarantined": ("counter", "seldon_tpu_engine_quarantined_total",
         "streams retired by the post-chunk NaN/Inf screen (500 NUMERIC_POISON, wave-mates "
         "unaffected)"),
    "watchdog_trips": ("counter", "seldon_tpu_engine_watchdog_trips_total",
         "healthy -> degraded transitions of the device-health watchdog"),
    "cost_page_seconds": ("counter", "seldon_tpu_engine_cost_page_seconds_total",
         "KV page-seconds consumed by terminated streams (occupancy integral)"),
    "cost_prefill_tokens": ("counter", "seldon_tpu_engine_cost_prefill_tokens_total",
         "prompt tokens attributed to terminated streams by the cost ledger"),
    "cost_decode_tokens": ("counter", "seldon_tpu_engine_cost_decode_tokens_total",
         "decode tokens attributed to terminated streams by the cost ledger"),
    "captures": ("counter", "seldon_tpu_engine_captures_total",
         "request capture containers written to the bounded on-disk store "
         "(sample/error/breach triggers)"),
    "kv_tier_demotions": ("counter", "seldon_tpu_engine_kv_tier_demotions_total",
         "LRU-reclaimed prefix pages demoted into the host KV tier instead of discarded"),
    "kv_tier_promotions": ("counter", "seldon_tpu_engine_kv_tier_promotions_total",
         "admissions whose chain walk promoted >= 1 tier page back into HBM via the "
         "scatter import"),
    "kv_tier_host_hits": ("counter", "seldon_tpu_engine_kv_tier_host_hits_total",
         "tier pages promoted from the host-RAM level"),
    "kv_tier_disk_hits": ("counter", "seldon_tpu_engine_kv_tier_disk_hits_total",
         "tier pages promoted from the disk spill level"),
    "kv_tier_misses": ("counter", "seldon_tpu_engine_kv_tier_misses_total",
         "uncached full prompt pages the tier ALSO missed (they re-prefilled — the hit- "
         "rate denominator's other half)"),
    "kv_tier_evictions": ("counter", "seldon_tpu_engine_kv_tier_evictions_total",
         "entries the tier byte budgets pushed out of host AND disk entirely"),
    "kv_tier_bytes_demoted": ("counter", "seldon_tpu_engine_kv_tier_bytes_demoted_total",
         "container bytes demoted into the tier"),
    "kv_tier_bytes_promoted": ("counter", "seldon_tpu_engine_kv_tier_bytes_promoted_total",
         "container bytes promoted back into HBM"),
    "pool_pages_used": ("gauge", "seldon_tpu_engine_pool_pages_used",
         "KV pool pages in use"),
    "pool_pages_total": ("gauge", "seldon_tpu_engine_pool_pages_total",
         "KV pool pages available"),
    "prefix_pages_cached": ("gauge", "seldon_tpu_engine_prefix_cache_pages_cached",
         "pages parked on the LRU prefix cache (refcount 0, reclaimable on demand)"),
    "kv_dtype_int8": ("gauge", "seldon_tpu_engine_kv_dtype_int8",
         "KV pool element type (1 = int8 pages with per-page scales, 0 = native compute "
         "dtype)"),
    "adapters_resident": ("gauge", "seldon_tpu_engine_adapters_resident",
         "adapters resident in the factor pool (pinned + LRU-cached slots)"),
    "adapter_slots": ("gauge", "seldon_tpu_engine_adapter_slots",
         "adapter slots the factor pool was built with (0 = multi-LoRA off)"),
    "health_state": ("gauge", "seldon_tpu_engine_health_state",
         "device-health watchdog state (0 = healthy, 1 = degraded, 2 = evacuating)"),
    "kernel_active": ("gauge", "seldon_tpu_engine_kernel_active",
         "decode lane actually running (1 = fused Pallas paged-decode kernel, 0 = XLA "
         "gather fallback)"),
    "capture_store_bytes": ("gauge", "seldon_tpu_engine_capture_store_bytes",
         "on-disk footprint of the bounded request capture store (LRU-evicted by bytes)"),
    "kv_tier_host_bytes": ("gauge", "seldon_tpu_engine_kv_tier_host_bytes",
         "live container bytes parked in the tier's host-RAM level"),
    "kv_tier_disk_bytes": ("gauge", "seldon_tpu_engine_kv_tier_disk_bytes",
         "live container bytes parked in the tier's disk spill level"),
    "tp_degree": ("gauge", "seldon_tpu_engine_tp_degree",
                  "tensor-parallel degree the engine runs at "
                  "(1 = single-chip)"),
    "dp_degree": ("gauge", "seldon_tpu_engine_dp_degree",
                  "data-parallel degree the engine runs at "
                  "(1 = single replica group)"),
    "pool_shard_bytes": ("gauge", "seldon_tpu_engine_pool_shard_bytes",
                         "K+V pool bytes ONE device holds (per-shard "
                         "under tensor parallelism, full pool at tp=1)"),
    # the port's own keys
    "active": ("gauge", "seldon_tpu_engine_slot_occupancy",
               "slots holding a live stream"),
    "queued": ("gauge", "seldon_tpu_engine_queue_depth",
               "streams waiting for a slot"),
    "free_pages": ("gauge", "seldon_tpu_engine_pool_pages_free",
                   "KV pool pages on the free list (cached prefix pages "
                   "not counted)"),
    "ctx_buckets": ("gauge", "seldon_tpu_engine_ctx_buckets",
                    "length buckets a decode chunk may split its lanes into"),
    "bucketed_steps": ("counter", "seldon_tpu_engine_bucketed_steps_total",
                       "decode steps of chunks split into two length "
                       "buckets (one more paged-decode launch a layer each)"),
    "weight_materializations": ("counter",
                                "seldon_tpu_engine_weight_materializations_total",
                                "int8-at-rest kernels dequantised for a "
                                "device call"),
}

# engine_stats() keys not exported as their own series: the wall-second
# accumulators feed the chunk-duration histogram through the recorder's
# records; ``health`` is the string twin of ``health_state``;
# ``cost_by_adapter`` is exported with adapter labels
# (COST_LEDGER_METRICS); ``chunk_impl`` is a string and ``chunk_steps`` a
# steps -> chunks dict (the debug surfaces read both); ``jit_compiles``
# is exported per program by utils/jitwatch.py itself
ENGINE_STATS_EXCLUDED = {"chunk_wall_s", "prefill_wall_s", "health", "cost_by_adapter", "chunk_impl",
                         "chunk_steps", "jit_compiles"}

ADAPTER_REQUESTS_METRIC = "seldon_tpu_engine_adapter_requests_total"

CHUNK_DURATION_METRIC = "seldon_tpu_engine_chunk_duration_seconds"

# cost_by_adapter field -> (kind, canonical metric name, doc): the
# per-adapter split of the cost_* counters, summing to them exactly
COST_LEDGER_METRICS: Dict[str, Tuple[str, str, str]] = {
    "page_seconds": ("counter", "seldon_tpu_engine_cost_adapter_page_seconds_total",
                     "KV page-seconds by adapter (base = no adapter)"),
    "prefill_tokens": ("counter", "seldon_tpu_engine_cost_adapter_prefill_tokens_total",
                       "prompt tokens by adapter"),
    "decode_tokens": ("counter", "seldon_tpu_engine_cost_adapter_decode_tokens_total",
                      "decode tokens by adapter"),
    "streams": ("counter", "seldon_tpu_engine_cost_adapter_streams_total",
                "terminated streams by adapter"),
}


def _trace_exemplar() -> Optional[Dict[str, str]]:
    """The exemplar of the active trace, or None with the telemetry plane
    off or no active span (OpenMetrics caps an exemplar's label runes at
    128)."""
    from seldon_core_tpu_torch.utils import telemetry as _telemetry

    if not _telemetry.telemetry_enabled():
        return None
    from seldon_core_tpu_torch.utils.tracing import current_span

    span = current_span()
    tid = getattr(span, "trace_id", "") if span is not None else ""
    return {"trace_id": str(tid)[:100]} if tid else None


class GenerationPrometheusBridge:
    """``PagedEngine`` stats and flight-recorder records -> the canonical
    ``seldon_tpu_engine_*`` series on the port's registry (two engines of
    one process share the families and differ in ``model_name``).

    Call :meth:`collect` periodically (``StreamingLM``'s decode loop
    does).  Cumulative engine counters are exported as counters by the
    delta from the previous collect (a smaller value, an engine's reset,
    re-bases instead of subtracting); gauges are set; each recorder
    record is observed once into the chunk-duration histogram, in record
    ``seq`` order, with its wave's trace as the exemplar."""

    def __init__(self, engine, deployment_name: str = "", predictor_name: str = "", model_name: str = "",
                 registry: Optional[Registry] = None):
        self.engine = engine
        self._labels = {"deployment_name": deployment_name, "predictor_name": predictor_name,
                        "model_name": model_name}
        self._names = tuple(sorted(self._labels))
        self._cache = _cache_for(registry)
        self._last: Dict[str, float] = {}
        self._last_seq = 0

    def _metric(self, kind: str, name: str, doc: str = ""):
        return self._cache.get(kind, name, self._names, doc).labels(**self._labels)

    def _counter_delta(self, key: str, value: float) -> float:
        prev = self._last.get(key, 0.0)
        cur = float(value)
        self._last[key] = cur
        return cur - prev if cur >= prev else cur  # a reset re-bases

    def _labelled(self, kind: str, name: str, doc: str, **extra: str):
        labels = dict(self._labels, **extra)
        return self._cache.get(kind, name, tuple(sorted(labels)), doc).labels(**labels)

    def collect(self) -> None:
        """Never raises: the bridge must not take the decode loop down."""
        try:
            self._collect()
        except Exception:  # noqa: BLE001 — the bridge never takes the decode loop down
            logger.exception("generation prometheus bridge collect failed")

    def _collect(self) -> None:
        stats = self.engine.engine_stats()
        requests = stats.get("adapter_requests")
        if requests is None and hasattr(self.engine, "adapter_stats"):
            requests = self.engine.adapter_stats().get("requests")
        for adapter, count in (requests or {}).items():
            delta = self._counter_delta(f"adapter_requests:{adapter}", count)
            if delta > 0:
                self._labelled("counter", ADAPTER_REQUESTS_METRIC,
                               "adapter-carrying requests submitted, by adapter name", adapter=adapter).inc(delta)
        # absent with SELDON_TPU_TELEMETRY=0: the off lane exports no cost series
        for adapter, fields in (stats.get("cost_by_adapter") or {}).items():
            for field, (kind, name, doc) in COST_LEDGER_METRICS.items():
                delta = self._counter_delta(f"cost_adapter:{adapter}:{field}", fields.get(field, 0.0))
                if delta > 0:
                    self._labelled(kind, name, doc, adapter=adapter).inc(delta)
        for key, value in stats.items():
            spec = ENGINE_STATS_METRICS.get(key)
            if spec is None:
                continue  # contract-tested: unmapped => excluded by name
            kind, name, doc = spec
            metric = self._metric(kind, name, doc)
            if kind == "gauge":
                metric.set(float(value))
            else:
                delta = self._counter_delta(key, value)
                if delta > 0:
                    metric.inc(delta)
        recorder = getattr(self.engine, "recorder", None)
        if recorder is not None:
            hist = self._metric("histogram", CHUNK_DURATION_METRIC, "wall time of one decode/verify chunk program")
            for rec in recorder.since(self._last_seq):
                self._last_seq = max(self._last_seq, rec["seq"])
                tid = str(rec.get("trace_id", "") or "")
                hist.observe(float(rec.get("wall_ms", 0.0)) / 1000.0,
                             exemplar={"trace_id": tid[:100]} if tid else None)
            self._metric("gauge", "seldon_tpu_engine_chunk_p99_ms",
                         "chunk-wall p99 over the flight recorder window").set(
                float(recorder.stats()["chunk_p99_ms"]))


# ---------------------------------------------------------------------------
# control plane: the autoscaler's latency signal, worker lifecycle and the
# fleet view (controlplane/{autoscaler,supervisor,fleetview}.py)
# ---------------------------------------------------------------------------

class HistogramQuantileSampler:
    """Windowed quantile over one histogram series.

    Each call diffs the cumulative bucket counts against the previous
    sample and interpolates the quantile from the window's bucket deltas
    (the same estimate PromQL's histogram_quantile(rate(...)) gives) —
    the latency signal the autoscaler consumes for target_p95_ms
    policies.  Returns 0.0 until traffic arrives.
    """

    def __init__(self, histogram_series: "_HistogramSeries", quantile: float = 0.95):
        self._series = histogram_series
        self.quantile = float(quantile)
        self._last: Optional[List[float]] = None

    def _cumulative(self) -> Tuple[List[float], List[float]]:
        counts, _total = self._series.snapshot()  # per bucket, not cumulative
        cum, acc = [], 0.0
        for c in counts:
            acc += c
            cum.append(acc)
        return [float(b) for b in self._series._upper], cum  # noqa: SLF001 — same module

    def __call__(self) -> float:
        bounds, cum = self._cumulative()
        if self._last is None:
            self._last = cum
            return 0.0
        deltas = [c - p for c, p in zip(cum, self._last)]
        self._last = cum
        if any(d < 0 for d in deltas):
            # a counter reset mid-window: this sample is a fresh baseline
            # and reports no traffic, as the first call does (PromQL's
            # rate() makes the same choice on resets)
            return 0.0
        total = deltas[-1]
        if total <= 0:
            return 0.0
        rank = self.quantile * total
        prev_bound = 0.0
        prev_cum = 0.0
        for bound, c in zip(bounds, deltas):
            if c >= rank:
                if bound == math.inf:
                    return prev_bound
                span = c - prev_cum
                frac = (rank - prev_cum) / span if span > 0 else 1.0
                return prev_bound + frac * (bound - prev_bound)
            prev_bound, prev_cum = bound, c
        return prev_bound


def api_latency_sampler(observer: PrometheusObserver, quantile: float = 0.95,
                        method: str = "predictions") -> HistogramQuantileSampler:
    """Quantile sampler over an observer's server-request histogram
    (seconds); multiply by 1000 at the call site for ms targets."""
    labels = {
        "deployment_name": observer.deployment_name,
        "predictor_name": observer.predictor_name,
        "method": method,
        "code": "200",
    }
    hist = observer._cache.get(  # noqa: SLF001 — same module
        "histogram",
        "seldon_api_engine_server_requests_duration_seconds",
        tuple(sorted(labels)),
        "external API request latency",
    )
    return HistogramQuantileSampler(hist.labels(**labels), quantile=quantile)


def record_worker_health(worker: str, restarts: int, exhausted: bool,
                         registry: Optional[Registry] = None) -> None:
    """Supervised-worker lifecycle for the alert layer: cumulative
    restart count and the restart-budget-exhausted flag (the silent-dead
    state ``WorkerRestartsExhausted`` alerts on).  Never raises."""
    try:
        cache = _cache_for(registry)
        cache.get("gauge", "seldon_tpu_worker_restarts", ("worker",),
                  "restarts performed by the supervisor for this worker").labels(worker=worker).set(float(restarts))
        cache.get("gauge", "seldon_tpu_worker_exhausted", ("worker",),
                  "1 when the worker exceeded its restart budget and the supervisor gave up "
                  "(the worker is dead until redeployed)").labels(worker=worker).set(1.0 if exhausted else 0.0)
    except Exception:  # noqa: BLE001 — metrics never break supervision
        logger.exception("worker health metric failed for %s", worker)


# TelemetryAggregator.fleet_rollup() key -> (kind, metric name, doc).
# COMPLETE BY CONTRACT like the engine bridge: every rollup key must
# appear here or in FLEET_EXCLUDED (tests/test_torch_port_fleetview.py),
# so a new fleet aggregate cannot silently skip export.
# All gauges: the rollup is a point-in-time merge, re-summed per poll.
FLEET_METRICS: Dict[str, Tuple[str, str, str]] = {
    "replicas_total": ("gauge", "seldon_tpu_fleet_replicas",
                       "replica endpoints the aggregator polls"),
    "replicas_ok": ("gauge", "seldon_tpu_fleet_replicas_ok",
                    "replicas with a fresh telemetry snapshot"),
    "replicas_stale": ("gauge", "seldon_tpu_fleet_replicas_stale",
                       "replicas whose last snapshot aged past the "
                       "staleness window (not crashed — unpolled)"),
    "replicas_incompatible": ("gauge",
                              "seldon_tpu_fleet_replicas_incompatible",
                              "replicas answering with a future/invalid "
                              "telemetry schema"),
    "fleet_queue_depth": ("gauge", "seldon_tpu_fleet_queue_depth",
                          "queued streams across ok replicas"),
    "fleet_active_slots": ("gauge", "seldon_tpu_fleet_active_slots",
                           "live decode slots across ok replicas"),
    "fleet_slots_total": ("gauge", "seldon_tpu_fleet_slot_capacity",
                          "decode slot capacity across ok replicas"),
    "fleet_goodput_tok_s": ("gauge", "seldon_tpu_fleet_goodput_tok_s",
                            "decode tokens/s served across ok replicas"),
    "fleet_prefill_tok_s": ("gauge", "seldon_tpu_fleet_prefill_tok_s",
                            "prefill tokens/s across ok replicas"),
    "fleet_completed_s": ("gauge", "seldon_tpu_fleet_completed_s",
                          "streams completed/s across ok replicas"),
    "fleet_shed_s": ("gauge", "seldon_tpu_fleet_shed_s",
                     "streams shed/s across ok replicas"),
    "fleet_preempted_s": ("gauge", "seldon_tpu_fleet_preempted_s",
                          "streams preempted/s across ok replicas"),
    "fleet_migrated_out_s": ("gauge", "seldon_tpu_fleet_migrated_out_s",
                             "streams live-migrated/s across ok replicas"),
    "fleet_pool_pages_used": ("gauge", "seldon_tpu_fleet_pool_pages_used",
                              "KV pool pages in use across ok replicas"),
    "fleet_pool_pages_total": ("gauge", "seldon_tpu_fleet_pool_page_capacity",
                               "KV pool page capacity across ok replicas"),
    "fleet_cost_page_s_s": ("gauge", "seldon_tpu_fleet_cost_page_s_s",
                            "KV page-seconds accrued per second across "
                            "ok replicas (cost ledger burn rate)"),
    "fleet_prefix_hit_pct": ("gauge", "seldon_tpu_fleet_prefix_hit_pct",
                             "mean prefix-cache hit % across ok replicas"),
    "fleet_saturation_max": ("gauge", "seldon_tpu_fleet_saturation_max",
                             "worst replica saturation score [0,1] — the "
                             "FleetReplicaSaturated alert reads this"),
    "fleet_saturation_mean": ("gauge", "seldon_tpu_fleet_saturation_mean",
                              "mean replica saturation score [0,1]"),
    "fleet_chunk_p99_ms": ("gauge", "seldon_tpu_fleet_chunk_p99_ms",
                           "worst per-replica chunk-wall p99 (ms)"),
    "fleet_predict_cost_s_max": ("gauge",
                                 "seldon_tpu_fleet_predict_cost_s_max",
                                 "worst predicted service seconds for a "
                                 "nominal request across ok replicas"),
    "fleet_kv_tier_host_bytes": ("gauge",
                                 "seldon_tpu_fleet_kv_tier_host_bytes",
                                 "demoted KV bytes parked in host RAM "
                                 "across ok replicas (r22 KV tier)"),
    "fleet_kv_tier_hit_rate": ("gauge",
                               "seldon_tpu_fleet_kv_tier_hit_rate",
                               "mean KV-tier promote hit rate [0,1] "
                               "across replicas running the tier"),
}

# rollup keys not exported as their own series ("t" is the poll stamp)
FLEET_EXCLUDED = {"t"}

FLEET_REPLICA_SATURATION_METRIC = "seldon_tpu_fleet_replica_saturation"
FLEET_REPLICA_STATE_METRIC = "seldon_tpu_fleet_replica_state"

# replica freshness encoding for the per-replica state gauge
FLEET_STATE_CODES = {"ok": 0, "stale": 1, "incompatible": 2, "never": 3}


class FleetPrometheusBridge:
    """TelemetryAggregator fleet view -> ``seldon_tpu_fleet_*`` gauges,
    collected after every poll (the aggregator calls :meth:`collect`
    when attached as its ``bridge``).  Complete-by-contract against
    FLEET_METRICS/FLEET_EXCLUDED; per-replica saturation and state
    export with a ``replica`` label the flat rollup can't carry."""

    def __init__(self, aggregator, registry=None):
        self.aggregator = aggregator
        self._cache = _cache_for(registry)

    def collect(self) -> None:
        """Never raises — the bridge must not take the poll loop down."""
        try:
            self._collect()
        except Exception:  # noqa: BLE001 — same discipline as the engine bridge
            logger.exception("fleet prometheus bridge collect failed")

    def _collect(self) -> None:
        rollup = self.aggregator.fleet_rollup()
        for key, value in rollup.items():
            spec = FLEET_METRICS.get(key)
            if spec is None:
                continue  # contract-tested: unmapped => in FLEET_EXCLUDED
            kind, name, doc = spec
            self._cache.get(kind, name, (), doc).labels().set(float(value))
        for replica, row in self.aggregator.replica_states().items():
            self._cache.get(
                "gauge", FLEET_REPLICA_SATURATION_METRIC, ("replica",),
                "per-replica saturation score [0,1]",
            ).labels(replica=replica).set(float(row.get("saturation", 0.0)))
            self._cache.get(
                "gauge", FLEET_REPLICA_STATE_METRIC, ("replica",),
                "replica telemetry freshness (0 ok, 1 stale, "
                "2 incompatible, 3 never polled)",
            ).labels(replica=replica).set(
                FLEET_STATE_CODES.get(row.get("state"), 3)
            )

