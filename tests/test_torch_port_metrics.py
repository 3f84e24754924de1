"""The port's metrics registry against ``prometheus_client`` under the JAX package.

The same observer events (requests, node calls, custom COUNTER / GAUGE /
TIMER metrics with tags, feedback), label-less counters and transport
hops go through ``seldon_core_tpu/utils/metrics.py`` on a fresh
``prometheus_client`` registry and through
``seldon_core_tpu_torch/utils/metrics.py`` on a fresh port registry.
Both expositions are parsed into ``{(sample name, labels): value}``:
names, label sets and bucket bounds are equal exactly, and so are the
values, except those that are times (the ``_sum`` of a duration
histogram and the ``_created`` timestamps).  Then the exposition's
format (Go floats, escaping, ``# HELP`` / ``# TYPE``), the collectors
that keep the component's custom metrics under their current names,
the gateway's ``/metrics`` with an observer, and the kill switch.
"""

import asyncio
import math
import re

import numpy as np
import pytest

prom = pytest.importorskip("prometheus_client")

from seldon_core_tpu.utils import metrics as jax_metrics  # noqa: E402
from seldon_core_tpu_torch.utils import metrics  # noqa: E402
from seldon_core_tpu_torch.engine.transport import CircuitBreaker  # noqa: E402


@pytest.fixture(autouse=True)
def fresh_breakers():
    """The breaker registry is process-wide: start and leave every test
    with every endpoint closed."""
    CircuitBreaker.reset_all()
    yield
    CircuitBreaker.reset_all()


_LINE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})? (\S+)$')
_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse(text: str):
    """``{(sample, ((label, value), ...)): value}`` and ``{family: type}``."""
    samples, types = {}, {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ", 3)
            types[name] = kind
        elif line and not line.startswith("#"):
            m = _LINE.match(line)
            assert m, line
            labels = tuple(sorted(_LABEL.findall(m.group(3) or "")))
            samples[(m.group(1), labels)] = float(m.group(4))
    return samples, types


TIMED = ("_sum", "_created")


def drive(mod, registry):
    obs = mod.PrometheusObserver(deployment_name="resnet50", predictor_name="main", registry=registry)
    for seconds in (0.0004, 0.002, 0.07, 3.0, 12.0):
        obs("predict_done", "main", seconds)
    obs("node_call", "resnet", ("transform_input", 0.004))
    obs("node_call", "resnet", ("transform_input", 0.0009))
    obs("node_call", "router", ("route", 0.0001))
    custom = [{"key": "cudaserver_batches_total", "type": "GAUGE", "value": 7.0},
              {"key": "cudaserver_kernel_launches", "type": "GAUGE", "value": 7.0, "tags": {"kernel": "fused_normalize"}},
              {"key": "my_calls", "type": "COUNTER", "value": 2.0, "tags": {"lane": "a"}},
              {"key": "my_latency", "type": "TIMER", "value": 30.0},
              {"key": "", "type": "COUNTER", "value": 1.0}]
    obs("node_metrics", "resnet", custom)
    obs("node_metrics", "resnet", custom[:3])
    obs("node_feedback", "router", 1.0)
    obs("node_feedback", "router", 0.5)
    obs("weird_event", "x", None)
    mod.increment_counter("seldon_api_gateway_feedback_unrouted", "doc", registry=registry)
    mod.increment_counter("seldon_api_gateway_feedback_unrouted", "doc", registry=registry)
    for hop in (dict(request_bytes=100, response_bytes=40, serialize_seconds=0.001, network_seconds=0.002),
                dict(request_bytes=50, retries=2, error=True, serialize_seconds=0.0, network_seconds=0.3)):
        mod.record_transport_hop("resnet", "predict", "grpc", registry=registry, **hop)
    mod.record_transport_hop("resnet", "predict", "local", zero_copy_bytes=4096, registry=registry)
    gauge = mod.transport_inflight("resnet", "predict", "rest", registry=registry)
    gauge.inc()
    gauge.inc()
    gauge.dec()


def test_exposition_equals_prometheus_client():
    jreg, preg = prom.CollectorRegistry(), metrics.Registry()
    drive(jax_metrics, jreg)
    drive(metrics, preg)
    theirs, their_types = parse(prom.generate_latest(jreg).decode())
    ours, our_types = parse(metrics.generate_latest(preg).decode())
    assert set(ours) == set(theirs)
    assert our_types == their_types
    for key, value in theirs.items():
        if not key[0].endswith(TIMED):
            assert ours[key] == value, key
        elif key[0].endswith("_sum") and not key[0].startswith("seldon_api_engine"):
            assert ours[key] == pytest.approx(value), key  # sums of fixed values, not measured times
    # the reference's names are all there
    names = {k[0] for k in ours}
    assert {"seldon_api_engine_server_requests_duration_seconds_count",
            "seldon_api_engine_client_requests_duration_seconds_bucket",
            "seldon_api_model_feedback_total", "seldon_api_model_feedback_reward_total",
            "seldon_api_gateway_feedback_unrouted_total", "seldon_tpu_transport_zero_copy_bytes_total",
            "seldon_tpu_transport_inflight"} <= names
    buckets = sorted(float(dict(k[1])["le"]) for k in ours
                     if k[0] == "seldon_api_engine_server_requests_duration_seconds_bucket")
    assert buckets == sorted(list(jax_metrics._BUCKETS) + [math.inf])


def test_exposition_format():
    reg = metrics.Registry()
    reg.family("gauge", "g", ("u",), 'a "doc" \\ with\nnewline').labels(u='x"y\\z\n').set(1e7)
    reg.family("counter", "c_total").labels().inc(3)
    text = metrics.generate_latest(reg).decode()
    assert text.splitlines()[:3] == ['# HELP g a "doc" \\\\ with\\nnewline', "# TYPE g gauge",
                                     'g{u="x\\"y\\\\z\\n"} 1e+07']
    assert "# TYPE c_total counter\nc_total 3.0\n" in text and "# TYPE c_created gauge" in text
    for v in (0.0, 1.0, 0.0005, 123456789.0, 1e-12, -2.5, math.inf, -math.inf, math.nan):
        assert metrics._go_float(v) == prom.utils.floatToGoString(v)
    with pytest.raises(ValueError):
        reg.family("gauge", "g", ("v",))  # same name, other labels: refused, as prometheus_client does
    with pytest.raises(ValueError):
        reg.family("counter", "c").labels().inc(-1)


def test_collectors_keep_current_names_and_repeat_no_family():
    """A collector's family joins a registered one of the same name and
    kind; one of another kind is dropped."""
    reg = metrics.Registry()
    reg.family("gauge", "dup", ()).labels().set(1.0)
    custom = [{"key": "scaler_calls", "type": "COUNTER", "value": 1.0},
              {"key": "cudaserver_kernel_launches", "type": "GAUGE", "value": 4.0, "tags": {"kernel": "k1"}},
              {"key": "cudaserver_kernel_launches", "type": "GAUGE", "value": 2.0, "tags": {"kernel": "k2"}},
              {"key": "dup", "type": "GAUGE", "value": 9.0}]
    text = metrics.generate_latest(reg, collectors=[
        lambda: metrics.custom_metric_families(custom, labels={"unit": "m"})]).decode()
    assert "# TYPE scaler_calls counter\nscaler_calls{unit=\"m\"} 1.0" in text
    assert 'cudaserver_kernel_launches{kernel="k1",unit="m"} 4.0' in text
    assert text.count("# TYPE cudaserver_kernel_launches gauge") == 1
    assert text.count("# TYPE dup gauge") == 1 and "dup 1.0" in text and 'dup{unit="m"} 9.0' in text
    other_kind = metrics.generate_latest(reg, collectors=[
        lambda: metrics.custom_metric_families([{"key": "dup", "type": "COUNTER", "value": 5.0}])]).decode()
    assert other_kind.count("# TYPE dup") == 1 and "5.0" not in other_kind


def test_kill_switch_disables_transport_telemetry(monkeypatch):
    reg = metrics.Registry()
    monkeypatch.setenv("SELDON_TPU_TRANSPORT_TELEMETRY", "0")
    metrics.record_transport_hop("u", "predict", "grpc", request_bytes=10, registry=reg)
    assert metrics.transport_inflight("u", "predict", "grpc", registry=reg) is None
    assert metrics.generate_latest(reg) == b""
    monkeypatch.setenv("SELDON_TPU_TRANSPORT_TELEMETRY", "1")
    metrics.record_transport_hop("u", "predict", "grpc", request_bytes=10, registry=reg)
    samples, _ = parse(metrics.generate_latest(reg).decode())
    labels = (("method", "predict"), ("transport", "grpc"), ("unit", "u"))
    assert samples[("seldon_tpu_transport_request_bytes_total", labels)] == 10.0


def test_observer_series_are_bound_once():
    """The hot path resolves labels once per identity."""
    reg = metrics.Registry()
    obs = metrics.PrometheusObserver(deployment_name="d", predictor_name="p", registry=reg)
    for _ in range(3):
        obs("predict_done", "p", 0.01)
        obs("node_metrics", "m", [{"key": "k", "type": "GAUGE", "value": 1.0, "tags": {"a": "b"}}])
    assert len(obs._bound) == 2
    samples, _ = parse(metrics.generate_latest(reg).decode())
    key = ("seldon_api_engine_server_requests_duration_seconds_count",
           (("code", "200"), ("deployment_name", "d"), ("method", "predictions"), ("predictor_name", "p")))
    assert samples[key] == 3.0


class Doubler:
    def predict(self, X, names, meta=None):
        return np.asarray(X) * 2

    def metrics(self):
        return [{"key": "doubler_calls", "type": "GAUGE", "value": 1.0}]


def test_gateway_metrics_with_an_observer_and_without():
    """A predictor with an observer feeds the registry under the
    reference's labels; one without keeps its components' metrics under
    {predictor, unit}.  Both show on the gateway's /metrics, with the
    per-predictor counts."""
    from aiohttp.test_utils import TestClient, TestServer

    from seldon_core_tpu_torch.engine import PredictorService, UnitSpec
    from seldon_core_tpu_torch.engine import server

    observer = metrics.PrometheusObserver(deployment_name="dep", predictor_name="observed")
    observed = PredictorService(UnitSpec(name="m", type="MODEL", component=Doubler()), name="observed",
                                observer=observer)
    plain = PredictorService(UnitSpec(name="m", type="MODEL", component=Doubler()), name="plain")
    gw = server.Gateway([(observed, 1.0), (plain, 0.0)])

    async def go():
        async with TestClient(TestServer(server.build_gateway_app(gw))) as client:
            for name in ("observed", "observed", "plain"):
                resp = await client.post(f"/api/v0.1/predictions?predictor={name}",
                                         json={"data": {"ndarray": [[1.0]]}})
                assert resp.status == 200, await resp.text()
            return await (await client.get("/metrics")).text()

    samples, _ = parse(asyncio.run(go()))
    api = ("seldon_api_engine_server_requests_duration_seconds_count",
           (("code", "200"), ("deployment_name", "dep"), ("method", "predictions"), ("predictor_name", "observed")))
    assert samples[api] == 2.0
    assert samples[("doubler_calls", (("deployment_name", "dep"), ("model_name", "m"),
                                      ("predictor_name", "observed")))] == 1.0
    assert samples[("doubler_calls", (("predictor", "plain"), ("unit", "m")))] == 1.0
    assert ("doubler_calls", (("predictor", "observed"), ("unit", "m"))) not in samples
    assert samples[("seldon_api_gateway_requests_total", (("predictor", "plain"),))] == 1.0
    assert samples[("seldon_api_gateway_requests_total", (("predictor", "observed"),))] == 2.0
    local = (("method", "predict"), ("transport", "local"), ("unit", "m"))
    assert samples[("seldon_tpu_transport_inflight", local)] == 0.0
    assert samples[("seldon_tpu_transport_requests_total", local)] >= 3.0
