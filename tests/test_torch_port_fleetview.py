"""The port's fleet view against the JAX package's.

Mirrors ``tests/test_fleetview.py``: stub replicas answer
``/debug/telemetry`` with canned snapshots, and the port's
``TelemetryAggregator`` and the JAX package's poll the same replicas on
the same clock: the same polls give the same ``fleet_view()``.  Then the
port's ``FleetPrometheusBridge`` (complete by contract against the
rollup's keys), the gateway's ``/debug/fleet`` and ``/debug/workers``.
"""

import asyncio
import http.server
import json
import socket
import threading

import numpy as np
import pytest

from seldon_core_tpu.controlplane import fleetview as jax_fleetview
from seldon_core_tpu.engine.transport import CircuitBreaker as JaxCircuitBreaker
from seldon_core_tpu_torch.controlplane import fleetview
from seldon_core_tpu_torch.engine.transport import CircuitBreaker
from seldon_core_tpu_torch.utils import telemetry


@pytest.fixture(autouse=True)
def _fresh_breakers():
    CircuitBreaker.reset_all()
    JaxCircuitBreaker.reset_all()
    yield
    CircuitBreaker.reset_all()
    JaxCircuitBreaker.reset_all()


def _point(**over):
    p = {
        "t": 1.0, "queue_depth": 2, "active_slots": 1, "active_slots_total": 4, "goodput_tok_s": 100.0,
        "prefill_tok_s": 40.0, "completed_s": 1.5, "prefix_hit_pct": 50.0, "prefix_pages_cached": 6,
        "pool_pages_used": 10, "pool_pages_total": 40, "adapters": [], "shed_s": 0.0, "expired_s": 0.0,
        "preempted_s": 0.0, "restored_s": 0.0, "migrated_out_s": 0.0, "migrated_in_s": 0.0,
        "cost_page_s_s": 2.0, "chunk_p99_ms": 12.0, "predict_cost_s": 0.3, "health": "healthy",
    }
    p.update(over)
    p["saturation"] = telemetry.saturation_score(p)
    return p


def _snapshot(replica_id, point):
    return {"schema_version": telemetry.TELEMETRY_SCHEMA_VERSION, "replica_id": replica_id, "t": 1.0,
            "window_s": 30.0, "capacity": 256, "points": [point], "latest": point}


class _StubReplica:
    """A threaded HTTP server answering /debug/telemetry with a canned
    snapshot (or raw bytes), capturing every request's headers."""

    def __init__(self, snapshot):
        self.snapshot = snapshot
        self.raw_body = None
        self.headers = []
        stub = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — stdlib naming
                stub.headers.append(dict(self.headers))
                body = stub.raw_body if stub.raw_body is not None else json.dumps(stub.snapshot).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        threading.Thread(target=self.server.serve_forever, daemon=True).start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()


class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _pair(endpoints, clock, **kw):
    return (fleetview.TelemetryAggregator(endpoints=endpoints, clock=clock, **kw),
            jax_fleetview.TelemetryAggregator(endpoints=endpoints, clock=clock, **kw))


class TestEndpointParsing:
    @pytest.mark.parametrize("raw", ["r0=http://h0:9000, http://h1:9100/,r2=https://h2:9200", "", "0",
                                     "http://a:1,b=http://b:2/"])
    def test_knob_grammar_equals_jax(self, raw):
        assert fleetview.endpoints_from_knob(raw) == jax_fleetview.endpoints_from_knob(raw)

    def test_endpoints_from_supervisor_specs(self):
        class Spec:
            def __init__(self, port):
                self.http_port = port

        class SP:
            def __init__(self, port):
                self.spec = Spec(port)

        class Sup:
            processes = {"lm-0": SP(9700), "lm-1": SP(9701)}

        assert fleetview.endpoints_from_supervisor(Sup()) == jax_fleetview.endpoints_from_supervisor(Sup()) == {
            "lm-0": "http://127.0.0.1:9700", "lm-1": "http://127.0.0.1:9701"}


class TestSameRollupAsJax:
    def test_two_replicas_merge_in_one_poll(self):
        a = _StubReplica(_snapshot("ra", _point(adapters=["tenant-a"])))
        b = _StubReplica(_snapshot("rb", _point(goodput_tok_s=60.0, queue_depth=6, adapters=["tenant-a", "tenant-b"],
                                                prefix_pages_cached=2, kv_tier_hit_rate=0.5,
                                                kv_tier_host_bytes=4096)))
        mine, theirs = _pair({"a": a.url, "b": b.url}, _Clock(), poll_s=0.1, stale_s=5.0)
        try:
            view = mine.poll_once()
            assert view == theirs.poll_once()
            roll = view["rollup"]
            assert (roll["replicas_total"], roll["replicas_ok"]) == (2, 2)
            assert roll["fleet_goodput_tok_s"] == pytest.approx(160.0) and roll["fleet_queue_depth"] == 8
            assert view["adapters"] == {"tenant-a": ["a", "b"], "tenant-b": ["b"]}
            assert view["prefix_pages"] == {"a": 6, "b": 2}
        finally:
            a.close()
            b.close()

    def test_random_fleets_roll_up_alike(self):
        rng = np.random.default_rng(11)
        stubs = []
        try:
            for i in range(4):
                point = _point(queue_depth=int(rng.integers(0, 9)), goodput_tok_s=float(rng.uniform(0, 500)),
                               active_slots=int(rng.integers(0, 5)), chunk_p99_ms=float(rng.uniform(1, 40)),
                               predict_cost_s=float(rng.uniform(0, 2)), pool_pages_used=int(rng.integers(0, 40)),
                               adapters=[f"t{j}" for j in range(int(rng.integers(0, 3)))])
                stubs.append(_StubReplica(_snapshot(f"r{i}", point)))
            clock = _Clock()
            mine, theirs = _pair({f"r{i}": s.url for i, s in enumerate(stubs)}, clock, poll_s=0.1, stale_s=5.0)
            assert mine.poll_once() == theirs.poll_once()
            stubs[1].close()
            clock.t += 6.0
            assert mine.poll_once() == theirs.poll_once()  # r1 stale in both, the rest ok
            assert mine.replica_states()["r1"]["state"] == "stale"
        finally:
            for i, s in enumerate(stubs):
                if i != 1:
                    s.close()

    def test_future_schema_and_garbage_mark_incompatible(self):
        snap = _snapshot("ra", _point())
        snap["schema_version"] = telemetry.TELEMETRY_SCHEMA_VERSION + 1
        a, g = _StubReplica(snap), _StubReplica(None)
        g.raw_body = b"not json at all"
        mine, theirs = _pair({"a": a.url, "g": g.url}, _Clock(), poll_s=0.1, stale_s=5.0)
        try:
            for _ in range(6):
                view = mine.poll_once()
                assert view == theirs.poll_once()
            assert {r["state"] for r in view["replicas"].values()} == {"incompatible"}
            assert view["rollup"]["replicas_incompatible"] == 2
            breaker = CircuitBreaker._registry.get(f"fleet:{g.url}")
            assert breaker is None or breaker.counters["trips"] == 0
        finally:
            a.close()
            g.close()

    def test_dead_endpoint_trips_breaker_then_fast_fails(self):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            dead = f"http://127.0.0.1:{s.getsockname()[1]}"
        agg = fleetview.TelemetryAggregator(endpoints={"a": dead}, poll_s=0.1, stale_s=5.0, timeout_s=0.5)
        for _ in range(8):
            agg.poll_once()
        breaker = CircuitBreaker._registry.get(f"fleet:{dead}")
        assert breaker is not None and breaker.counters["trips"] >= 1 and breaker.counters["fastfails"] >= 1
        assert agg.replica_states()["a"]["state"] == "never"

    def test_poll_hops_carry_deadline_and_trace_headers(self):
        from seldon_core_tpu_torch.utils import deadlines, tracing

        a = _StubReplica(_snapshot("ra", _point()))
        agg = fleetview.TelemetryAggregator(endpoints={"a": a.url}, poll_s=0.1, stale_s=5.0)
        before = tracing._tracer
        tracer = tracing.setup_tracing("fleet-test")
        try:
            with deadlines.activate(deadlines.Deadline.after_ms(30000)):
                with tracer.span("fleet.poll", trace_id="fleet-puid"):
                    agg.poll_once()
            hdrs = {k.lower(): v for k, v in a.headers[-1].items()}
            assert int(hdrs["x-seldon-deadline-ms"]) > 0 and "traceparent" in hdrs
        finally:
            tracing._tracer = before
            a.close()

    def test_set_endpoints_adds_and_drops_replicas(self):
        a = _StubReplica(_snapshot("ra", _point()))
        agg = fleetview.TelemetryAggregator(endpoints={"a": a.url}, poll_s=0.1, stale_s=5.0)
        try:
            agg.poll_once()
            agg.set_endpoints({"a": a.url, "b": a.url})
            assert agg.replica_states()["b"]["state"] == "never"
            assert agg.poll_once()["rollup"]["replicas_ok"] == 2
            agg.set_endpoints({"b": a.url})
            assert list(agg.replica_states()) == ["b"]
        finally:
            a.close()


class TestFleetBridge:
    def test_rollup_and_replica_gauges_export(self):
        from seldon_core_tpu.utils.metrics import FLEET_METRICS as JAX_FLEET_METRICS
        from seldon_core_tpu_torch.utils import metrics

        a = _StubReplica(_snapshot("ra", _point()))
        registry = metrics.Registry()
        agg = fleetview.TelemetryAggregator(endpoints={"a": a.url}, poll_s=0.1, stale_s=5.0)
        agg.bridge = metrics.FleetPrometheusBridge(agg, registry=registry)
        try:
            agg.poll_once()
            text = metrics.generate_latest(registry).decode()
            rollup = agg.fleet_rollup()
            for key, (_, metric, _) in metrics.FLEET_METRICS.items():
                assert f"\n{metric} " in text, f"{key} -> {metric} not exported"
            assert 'seldon_tpu_fleet_replica_saturation{replica="a"}' in text
            assert 'seldon_tpu_fleet_replica_state{replica="a"} 0.0' in text
            assert f"seldon_tpu_fleet_replicas {float(rollup['replicas_total'])}" in text
            assert set(rollup) == set(metrics.FLEET_METRICS) | metrics.FLEET_EXCLUDED
            assert metrics.FLEET_METRICS == JAX_FLEET_METRICS
        finally:
            a.close()


class _Plain:
    def predict(self, X, names, meta=None):
        return np.asarray(X)


def _gateway(supervisor=None):
    from seldon_core_tpu_torch.engine.graph import UnitSpec
    from seldon_core_tpu_torch.engine.server import Gateway
    from seldon_core_tpu_torch.engine.service import PredictorService

    svc = PredictorService(UnitSpec(name="m", type="MODEL", component=_Plain()), name="main")
    return Gateway([(svc, 1.0)], supervisor=supervisor)


async def _get(app, *paths):
    from aiohttp.test_utils import TestClient, TestServer

    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        return [await (await client.get(p)).json() for p in paths]
    finally:
        await client.close()


class TestGatewayDebugEndpoints:
    def test_debug_fleet_polls_knob_endpoints(self, monkeypatch):
        from seldon_core_tpu_torch.engine.server import build_gateway_app

        a = _StubReplica(_snapshot("ra", _point()))
        monkeypatch.setenv("SELDON_TPU_FLEET_ENDPOINTS", f"ra={a.url}")
        try:
            view, again = asyncio.run(_get(build_gateway_app(_gateway()), "/debug/fleet", "/debug/fleet"))
            assert view["enabled"] is True and view["replicas"]["ra"]["state"] == "ok"
            assert view["rollup"]["replicas_ok"] == 1
            assert again["polls"] == view["polls"] == 1  # throttled to the poll interval
        finally:
            a.close()

    def test_debug_fleet_and_workers_without_workers(self, monkeypatch):
        from seldon_core_tpu_torch.engine.server import build_gateway_app

        monkeypatch.delenv("SELDON_TPU_FLEET_ENDPOINTS", raising=False)
        fleet, workers = asyncio.run(_get(build_gateway_app(_gateway()), "/debug/fleet", "/debug/workers"))
        assert fleet["enabled"] is False
        assert workers == {"workers": {}, "engines": {}, "degraded": [], "exhausted": []}

    def test_debug_workers_and_fleet_read_the_supervisor(self, monkeypatch):
        """The gateway's supervisor (the deployer's worker view) feeds
        both routes: lifecycle rows, the exhausted list, and the fleet's
        endpoints, read again as workers come and go."""
        from seldon_core_tpu_torch.engine.server import build_gateway_app

        monkeypatch.delenv("SELDON_TPU_FLEET_ENDPOINTS", raising=False)
        a, b = _StubReplica(_snapshot("ra", _point())), _StubReplica(_snapshot("rb", _point(goodput_tok_s=50.0)))
        ports = {"w-0": int(a.url.rsplit(":", 1)[1]), "w-1": int(b.url.rsplit(":", 1)[1])}

        class Spec:
            def __init__(self, port):
                self.http_port = port

        class SP:
            def __init__(self, port):
                self.spec = Spec(port)

        class Sup:
            def __init__(self):
                self.processes = {"w-0": SP(ports["w-0"])}

            def health(self):
                return {name: {"alive": True, "ready": True, "restarts": 0, "max_restarts": 5,
                               "exhausted": name == "w-1", "state": "exhausted" if name == "w-1" else "running"}
                        for name in self.processes}

        sup = Sup()
        app = build_gateway_app(_gateway(sup))

        async def scenario():
            from aiohttp.test_utils import TestClient, TestServer

            client = TestClient(TestServer(app))
            await client.start_server()
            try:
                first = await (await client.get("/debug/fleet")).json()
                sup.processes["w-1"] = SP(ports["w-1"])
                second = await (await client.get("/debug/fleet")).json()
                workers = await (await client.get("/debug/workers")).json()
                return first, second, workers
            finally:
                await client.close()

        try:
            first, second, workers = asyncio.run(scenario())
            assert list(first["replicas"]) == ["w-0"] and first["rollup"]["replicas_ok"] == 1
            # the new worker joins the view at once; it is polled at the next interval
            assert second["replicas"]["w-1"]["state"] == "never" and second["polls"] == 1
            assert set(workers["workers"]) == {"w-0", "w-1"} and workers["exhausted"] == ["w-1"]
            gw = _gateway(sup)
            view, = asyncio.run(_get(build_gateway_app(gw), "/debug/fleet"))
            assert set(view["replicas"]) == {"w-0", "w-1"} and view["rollup"]["replicas_ok"] == 2
            assert view["rollup"]["fleet_goodput_tok_s"] == pytest.approx(150.0)
        finally:
            a.close()
            b.close()
