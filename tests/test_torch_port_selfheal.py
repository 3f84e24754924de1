"""The port's failure containment against the JAX package's.

``tests/test_selfheal.py``'s four containment classes run on the port's
classes (``seldon_core_tpu_torch/engine/{transport,executor,graph}.py``):
the breaker state machine, the breaker wired through the gRPC, REST and
local lanes and ``BalancedClient``, hedging, and fallback routes.  A
straggler here is a server whose first answer is slow (the JAX tests
inject ``transport.slow``; the port has no fault injector).

Then the parity cases, held exactly against the JAX package:

* one event script drives both packages' ``CircuitBreaker`` on one fake
  clock (``time.monotonic`` replaced in both transport modules): state,
  counters, ``stats()`` and each fast-fail's status, reason and message
  at each step;
* ``_fallback_worthy`` on a table of errors;
* ``UnitSpec`` serde of a spec with a fallback, and ``validate_graph``'s
  refusals of chains and duplicates;
* ``BalancedClient`` over scripted replicas: rotation, failover order,
  4xx surfacing, feedback without failover, ``NO_REPLICAS``;
* the breaker, hedge, failover and fallback series through both metrics
  modules, parsed into ``{(name, labels): value}``;
* C16: a one-node local MODEL with a fallback stays fast-path eligible,
  so its fallback answers on the async path only, in both packages.

The served ResNetTiny graph with a fallback, and two replicas behind a
``BalancedClient`` across a killed process, are in
``tests/test_torch_port_grpc.py`` (beside its JaxServer / CudaServer
pair).
"""

import asyncio
import os
import socket
import sys
import time
import types

import numpy as np
import pytest

import seldon_core_tpu.engine as jax_engine
from seldon_core_tpu.engine import executor as jax_executor
from seldon_core_tpu.engine import graph as jax_graph
from seldon_core_tpu.engine import transport as jax_transport
from seldon_core_tpu.runtime import component as jax_component
from seldon_core_tpu.runtime import message as jax_message
import seldon_core_tpu_torch.engine as engine
from seldon_core_tpu_torch.engine import executor, graph, transport
from seldon_core_tpu_torch.engine.graph import Endpoint, GraphSpecError, UnitSpec, validate_graph
from seldon_core_tpu_torch.engine.transport import (
    BREAKER_CLOSED,
    BREAKER_HALF_OPEN,
    BREAKER_OPEN,
    BalancedClient,
    CircuitBreaker,
    GrpcClient,
    LocalClient,
    RestClient,
    breakers_enabled,
)
from seldon_core_tpu_torch.runtime import component, message
from seldon_core_tpu_torch.runtime.component import MicroserviceError
from seldon_core_tpu_torch.runtime.message import InternalFeedback

PACKAGES = {
    "jax": types.SimpleNamespace(engine=jax_engine, executor=jax_executor, graph=jax_graph, transport=jax_transport,
                                 component=jax_component, message=jax_message),
    "torch_port": types.SimpleNamespace(engine=engine, executor=executor, graph=graph, transport=transport,
                                        component=component, message=message),
}


def _run(coro):
    return asyncio.run(coro)


def _msg(arr=((1.0, 2.0),), pkg="torch_port"):
    return PACKAGES[pkg].message.InternalMessage(payload=np.asarray(arr, dtype=np.float64), kind="tensor")


@pytest.fixture(autouse=True)
def _fresh_breakers():
    """Breakers are a process-wide per-endpoint registry by design: no
    test may leak tripped state into another."""
    for pkg in PACKAGES.values():
        pkg.transport.CircuitBreaker.reset_all()
    yield
    for pkg in PACKAGES.values():
        pkg.transport.CircuitBreaker.reset_all()


class Doubler:
    def predict(self, X, names, meta=None):
        return np.asarray(X) * 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# breaker state machine
# ---------------------------------------------------------------------------


class TestBreakerStateMachine:
    def test_trips_after_consecutive_transient_failures(self):
        b = CircuitBreaker("ep:1", failures=3, reset_s=60.0)
        for _ in range(2):
            b.on_transient()
            assert b.state == BREAKER_CLOSED
        b.on_transient()
        assert b.state == BREAKER_OPEN
        assert b.counters["trips"] == 1

    def test_deterministic_reply_resets_the_streak(self):
        b = CircuitBreaker("ep:2", failures=3, reset_s=60.0)
        b.on_transient()
        b.on_transient()
        probe = b.acquire("u", "m", "grpc")
        b.release(probe, healthy=True)  # a 4xx reply: the endpoint is alive
        b.on_transient()
        b.on_transient()
        assert b.state == BREAKER_CLOSED  # the streak restarted from zero

    def test_open_fast_fails_naming_endpoint_and_reason(self):
        b = CircuitBreaker("ep:3", failures=1, reset_s=60.0)
        b.on_transient()
        with pytest.raises(MicroserviceError) as ei:
            b.acquire("node-a", "predict", "grpc")
        assert ei.value.reason == "CIRCUIT_OPEN"
        assert ei.value.status_code == 503
        assert "ep:3" in str(ei.value)
        assert b.counters["fastfails"] == 1

    def test_cooldown_half_opens_with_probe_budget(self):
        b = CircuitBreaker("ep:4", failures=1, reset_s=0.05, probes=2)
        b.on_transient()
        assert b.state == BREAKER_OPEN
        time.sleep(0.06)
        assert b.state == BREAKER_HALF_OPEN
        # concurrent half-open: exactly `probes` pass, the rest fast-fail
        p1 = b.acquire("u", "m", "grpc")
        p2 = b.acquire("u", "m", "grpc")
        assert p1 is True and p2 is True
        with pytest.raises(MicroserviceError):
            b.acquire("u", "m", "grpc")
        b.release(p1, healthy=None)
        b.release(p2, healthy=None)
        # released slots admit probes again: none is wedged
        p3 = b.acquire("u", "m", "grpc")
        assert p3 is True
        b.release(p3, healthy=None)

    def test_probe_success_closes(self):
        b = CircuitBreaker("ep:5", failures=1, reset_s=0.05, probes=1)
        b.on_transient()
        time.sleep(0.06)
        probe = b.acquire("u", "m", "grpc")
        b.release(probe, healthy=True)
        assert b.state == BREAKER_CLOSED
        assert b.counters["closes"] == 1

    def test_probe_failure_reopens_immediately(self):
        b = CircuitBreaker("ep:6", failures=3, reset_s=0.05, probes=1)
        for _ in range(3):
            b.on_transient()
        time.sleep(0.06)
        probe = b.acquire("u", "m", "grpc")
        b.on_transient()  # ONE failure while half-open, not `failures`
        b.release(probe, healthy=False)
        assert b.state == BREAKER_OPEN
        assert b.counters["reopens"] == 1

    def test_registry_shares_one_breaker_per_endpoint(self):
        a = CircuitBreaker.for_endpoint("host:9000", failures=7)
        b = CircuitBreaker.for_endpoint("host:9000", failures=3)
        assert a is b and a.failures == 7  # the first creator's config wins
        assert CircuitBreaker.for_endpoint("host:9001") is not a
        CircuitBreaker.reset_all()
        assert CircuitBreaker.for_endpoint("host:9000") is not a

    def test_env_kill_switch_disables_breakers(self, monkeypatch):
        monkeypatch.setenv("SELDON_TPU_BREAKER", "0")
        assert not breakers_enabled()
        unit = UnitSpec(name="m", type="MODEL", endpoint=Endpoint(host="h", port=1, transport="REST"))
        assert RestClient(unit).breaker is None
        assert GrpcClient(unit).breaker is None
        assert LocalClient(unit, Doubler()).breaker is None


def test_breaker_shared_by_threads_loses_no_update():
    """The gateway's loop, the sync gRPC handler threads and the native
    ingress's workers share one breaker: under a tiny switch interval,
    16 threads' transient reports all count, and every probe slot taken
    is given back (none wedges the endpoint half-open)."""
    import threading

    b = CircuitBreaker("ep:threads", failures=10**9, reset_s=0.0, probes=3)
    probe_b = CircuitBreaker("ep:probes", failures=1, reset_s=0.0, probes=3)
    probe_b.on_transient()  # open, and half-open at once (no cooldown)
    admitted = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def worker():
        for _ in range(300):
            b.on_transient()
            try:
                probe = probe_b.acquire("u", "m", "grpc")
            except MicroserviceError:
                continue
            admitted.append(probe)
            probe_b.release(probe, healthy=None)

    threads = [threading.Thread(target=worker) for _ in range(16)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert b.counters["transient_failures"] == 16 * 300 and b.state == BREAKER_CLOSED
    assert admitted and all(admitted)
    assert probe_b.state == BREAKER_HALF_OPEN
    assert [probe_b.acquire("u", "m", "grpc") for _ in range(3)] == [True, True, True]  # every slot came back


# ---------------------------------------------------------------------------
# breaker wired through the transports
# ---------------------------------------------------------------------------


class TestBreakerTransport:
    def test_grpc_ladder_stops_when_breaker_trips_mid_call(self):
        """retries=5 against a dead endpoint with failures=2: the trip
        lands mid-ladder and the remaining attempts are not dialled."""
        unit = UnitSpec(name="dead", type="MODEL")
        unit.endpoint = Endpoint(host="127.0.0.1", port=_free_port(), transport="GRPC")
        client = GrpcClient(unit, deadline_s=0.4, retries=5,
                            breaker=CircuitBreaker("grpc-ladder", failures=2, reset_s=60.0))

        async def scenario():
            try:
                await client.transform_input(_msg())
            except MicroserviceError as e:
                return e
            finally:
                await client.close()

        err = _run(scenario())
        assert err.reason == "UPSTREAM_GRPC_ERROR"
        assert len(err.attempts) == 2  # 5 budgeted, 2 dialled, the trip stopped it
        assert err.transient is True
        assert client.breaker.state == BREAKER_OPEN

    def test_grpc_open_circuit_fast_fails_before_dial(self):
        unit = UnitSpec(name="dead", type="MODEL")
        unit.endpoint = Endpoint(host="127.0.0.1", port=_free_port(), transport="GRPC")
        breaker = CircuitBreaker("grpc-ff", failures=2, reset_s=60.0)
        client = GrpcClient(unit, deadline_s=0.4, retries=3, breaker=breaker)

        async def scenario():
            with pytest.raises(MicroserviceError):
                await client.transform_input(_msg())  # trips
            t0 = time.perf_counter()
            with pytest.raises(MicroserviceError) as ei:
                await client.transform_input(_msg())
            elapsed_ms = (time.perf_counter() - t0) * 1000.0
            await client.close()
            return ei.value, elapsed_ms

        err, elapsed_ms = _run(scenario())
        assert err.reason == "CIRCUIT_OPEN"
        assert not hasattr(err, "attempts")  # nothing was dialled
        assert elapsed_ms < 50.0  # no ladder, no backoff sleeps
        assert breaker.counters["fastfails"] == 1

    def test_grpc_recovers_through_half_open_probe(self):
        """A dead endpoint trips the breaker; a server appears on the same
        port; after the cooldown ONE probe dials and its success closes
        the circuit."""
        from seldon_core_tpu_torch.runtime import grpc_server

        port = _free_port()
        unit = UnitSpec(name="respawn", type="MODEL")
        unit.endpoint = Endpoint(host="127.0.0.1", port=port, transport="GRPC")
        breaker = CircuitBreaker("grpc-probe", failures=2, reset_s=0.1, probes=1)
        client = GrpcClient(unit, deadline_s=2.0, retries=2, breaker=breaker)

        async def scenario():
            with pytest.raises(MicroserviceError):
                await client.transform_input(_msg())
            assert breaker.state == BREAKER_OPEN
            server = grpc_server.build_server(Doubler())
            assert server.add_insecure_port(f"127.0.0.1:{port}") == port
            await server.start()
            try:
                await asyncio.sleep(0.15)  # past the cooldown
                return await client.transform_input(_msg())
            finally:
                await client.close()
                await server.stop(grace=None)

        out = _run(scenario())
        np.testing.assert_allclose(np.asarray(out.host_payload()), [[2.0, 4.0]])
        assert breaker.state == BREAKER_CLOSED
        assert breaker.counters["probes"] == 1
        assert breaker.counters["closes"] == 1

    def test_rest_5xx_trips_and_4xx_does_not(self):
        from aiohttp import web
        from aiohttp.test_utils import TestServer

        async def unavailable(_r):
            return web.json_response({"oops": True}, status=503)

        async def bad_request(_r):
            return web.json_response({"bad": True}, status=400)

        async def scenario():
            app = web.Application()
            app.router.add_post("/predict", unavailable)
            app.router.add_post("/transform-output", bad_request)
            server = TestServer(app)
            await server.start_server()
            unit = UnitSpec(name="m", type="MODEL",
                            endpoint=Endpoint(host="127.0.0.1", port=server.port, transport="REST"))
            breaker = CircuitBreaker("rest-5xx", failures=2, reset_s=60.0)
            client = RestClient(unit, retries=1, breaker=breaker)
            try:
                for _ in range(2):  # two 503s = the trip threshold
                    with pytest.raises(MicroserviceError) as ei:
                        await client.transform_input(_msg())
                    assert ei.value.transient is True
                assert breaker.state == BREAKER_OPEN
                with pytest.raises(MicroserviceError) as ei:
                    await client.transform_input(_msg())
                assert ei.value.reason == "CIRCUIT_OPEN"
                # deterministic replies never trip
                b2 = CircuitBreaker("rest-4xx", failures=2, reset_s=60.0)
                client2 = RestClient(unit, retries=1, breaker=b2)
                for _ in range(4):
                    with pytest.raises(MicroserviceError) as ei:
                        await client2.transform_output(_msg())
                    assert ei.value.transient is False
                assert b2.state == BREAKER_CLOSED
                await client2.close()
            finally:
                await client.close()
                await server.close()

        _run(scenario())

    def test_local_crash_trips_but_clean_errors_do_not(self):
        class Crasher:
            def predict(self, X, names, meta=None):
                raise RuntimeError("segfault-adjacent")

        class Shedder:
            def predict(self, X, names, meta=None):
                raise MicroserviceError("shed", status_code=503, reason="SHED")

        async def scenario():
            cb = CircuitBreaker("local-crash", failures=2, reset_s=60.0)
            crash = LocalClient(UnitSpec(name="crash", type="MODEL"), Crasher(), breaker=cb)
            for _ in range(2):
                with pytest.raises(RuntimeError):
                    await crash.transform_input(_msg())
            assert cb.state == BREAKER_OPEN
            with pytest.raises(MicroserviceError) as ei:
                await crash.transform_input(_msg())
            assert ei.value.reason == "CIRCUIT_OPEN"
            # a well-formed error (SHED) never trips: a breaker on top of
            # load shedding would turn overload into an outage
            sb = CircuitBreaker("local-shed", failures=2, reset_s=60.0)
            shed = LocalClient(UnitSpec(name="shedder", type="MODEL"), Shedder(), breaker=sb)
            for _ in range(5):
                with pytest.raises(MicroserviceError) as ei:
                    await shed.transform_input(_msg())
                assert ei.value.reason == "SHED"
            assert sb.state == BREAKER_CLOSED

        _run(scenario())

    def test_cancelled_probe_frees_its_slot(self):
        """A half-open probe whose call is cancelled (a hedge loser, a
        caller gone) settles with no evidence: its slot is free again and
        the breaker stays half-open, neither closed nor wedged."""
        async def scenario():
            app, served = _rest_app(first_delay_s=5.0)
            server, unit = await _rest_node(app)
            breaker = CircuitBreaker("cancelled-probe", failures=1, reset_s=0.05, probes=1)
            breaker.on_transient()
            await asyncio.sleep(0.06)  # half-open, one probe slot
            client = RestClient(unit, retries=1, breaker=breaker)
            task = asyncio.ensure_future(client.transform_input(_msg()))
            while served["n"] == 0:  # the probe is on the wire
                await asyncio.sleep(0.005)
            with pytest.raises(MicroserviceError):
                breaker.acquire("u", "m", "rest")  # the one slot is taken
            task.cancel()
            with pytest.raises(asyncio.CancelledError):
                await task
            state = breaker.state
            probe = breaker.acquire("u", "m", "rest")
            breaker.release(probe, healthy=None)
            await client.close()
            await server.close()
            return state, probe

        state, probe = _run(scenario())
        assert state == BREAKER_HALF_OPEN and probe is True

    def test_balanced_client_fails_over_an_open_circuit_fast(self):
        """A replica whose breaker is open costs its callers one cheap
        CIRCUIT_OPEN rejection (503 -> failover), not a dial ladder."""
        async def scenario():
            dead_unit = UnitSpec(name="lm", type="MODEL")
            dead_unit.endpoint = Endpoint(host="127.0.0.1", port=_free_port(), transport="GRPC")
            dead_breaker = CircuitBreaker("bal-dead", failures=1, reset_s=60.0)
            dead_breaker.on_transient()  # pre-tripped
            dead = GrpcClient(dead_unit, retries=3, breaker=dead_breaker)
            live = LocalClient(UnitSpec(name="lm", type="MODEL"), Doubler(), breaker=False)
            balanced = BalancedClient([dead, live])
            t0 = time.perf_counter()
            outs = [await balanced.transform_input(_msg()) for _ in range(4)]
            elapsed_ms = (time.perf_counter() - t0) * 1000.0
            await dead.close()
            return outs, elapsed_ms, dead_breaker

        outs, elapsed_ms, breaker = _run(scenario())
        for out in outs:
            np.testing.assert_allclose(np.asarray(out.host_payload()), [[2.0, 4.0]])
        assert elapsed_ms < 200.0  # 4 requests, ~2 fast-fail + failover hops
        assert breaker.counters["fastfails"] >= 1
        assert breaker.counters["transient_failures"] == 1  # only the pre-trip


# ---------------------------------------------------------------------------
# hedged requests
# ---------------------------------------------------------------------------


def _rest_app(first_delay_s: float = 0.0, path: str = "/predict"):
    """A REST node answering [[9.0]]; its first answer on `path` waits
    `first_delay_s` (the straggler)."""
    from aiohttp import web

    served = {"n": 0}

    async def ok(request):
        served["n"] += 1
        if served["n"] == 1 and request.path == path and first_delay_s:
            await asyncio.sleep(first_delay_s)
        return web.json_response({"data": {"ndarray": [[9.0]]}})

    app = web.Application()
    app.router.add_post("/predict", ok)
    app.router.add_post("/send-feedback", ok)
    return app, served


async def _rest_node(app):
    from aiohttp.test_utils import TestServer

    server = TestServer(app)
    await server.start_server()
    return server, UnitSpec(name="m", type="MODEL", endpoint=Endpoint(host="127.0.0.1", port=server.port,
                                                                      transport="REST"))


class TestHedging:
    def test_hedge_fires_on_straggler_and_wins(self):
        async def scenario():
            app, served = _rest_app(first_delay_s=0.5)
            server, unit = await _rest_node(app)
            client = RestClient(unit, retries=1, breaker=False, hedge_ms=60.0)
            t0 = time.perf_counter()
            out = await client.transform_input(_msg())
            elapsed = time.perf_counter() - t0
            await client.close()
            await server.close()
            return out, elapsed, client

        out, elapsed, client = _run(scenario())
        assert np.asarray(out.host_payload()).tolist() == [[9.0]]
        assert elapsed < 0.45  # beat the 500 ms straggler
        assert client.hedges_fired == 1
        assert client.hedge_wins == 1

    def test_no_hedge_when_primary_answers_in_time(self):
        async def scenario():
            app, served = _rest_app()
            server, unit = await _rest_node(app)
            client = RestClient(unit, breaker=False, hedge_ms=5000.0)
            out = await client.transform_input(_msg())
            await client.close()
            await server.close()
            return out, served, client

        out, served, client = _run(scenario())
        assert np.asarray(out.host_payload()).tolist() == [[9.0]]
        assert served["n"] == 1
        assert client.hedges_fired == 0

    def test_hedge_suppressed_when_budget_cannot_cover_it(self):
        from seldon_core_tpu_torch.utils import deadlines

        async def scenario():
            app, served = _rest_app()
            server, unit = await _rest_node(app)
            # remaining budget (2 s) < hedge delay (10 s): suppressed
            client = RestClient(unit, breaker=False, hedge_ms=10_000.0)
            with deadlines.activate_ms(2000):
                out = await client.transform_input(_msg())
            await client.close()
            await server.close()
            return out, client

        out, client = _run(scenario())
        assert np.asarray(out.host_payload()).tolist() == [[9.0]]
        assert client.hedges_fired == 0

    def test_hedge_suppressed_while_half_open(self):
        async def scenario():
            app, served = _rest_app(first_delay_s=0.12)
            server, unit = await _rest_node(app)
            breaker = CircuitBreaker("hedge-half", failures=1, reset_s=0.05, probes=1)
            breaker.on_transient()  # open
            await asyncio.sleep(0.06)  # ... half-open
            # a straggling probe would hedge at 1 ms, but a recovering
            # upstream must see a trickle, not double load
            client = RestClient(unit, retries=1, breaker=breaker, hedge_ms=1.0)
            out = await client.transform_input(_msg())
            await client.close()
            await server.close()
            return out, client, breaker, served

        out, client, breaker, served = _run(scenario())
        assert np.asarray(out.host_payload()).tolist() == [[9.0]]
        assert client.hedges_fired == 0 and served["n"] == 1
        assert breaker.state == BREAKER_CLOSED  # the probe closed it

    def test_send_feedback_never_hedges(self):
        async def scenario():
            app, served = _rest_app(first_delay_s=0.15, path="/send-feedback")
            server, unit = await _rest_node(app)
            client = RestClient(unit, breaker=False, hedge_ms=10.0)
            t0 = time.perf_counter()
            await client.send_feedback(InternalFeedback(request=_msg(), reward=1.0))
            elapsed = time.perf_counter() - t0
            await client.close()
            await server.close()
            return elapsed, served, client

        elapsed, served, client = _run(scenario())
        # the straggler was waited out: a duplicated reward would count twice
        assert elapsed >= 0.15
        assert served["n"] == 1
        assert client.hedges_fired == 0


# ---------------------------------------------------------------------------
# fallback routes
# ---------------------------------------------------------------------------


class TestFallbackRoutes:
    def test_validation_catches_duplicate_names_and_chains(self):
        dup = UnitSpec(name="a", type="MODEL", component=Doubler())
        dup.fallback = UnitSpec(name="a", type="MODEL", component=Doubler())
        with pytest.raises(GraphSpecError, match="duplicate"):
            validate_graph(dup)
        chain = UnitSpec(name="a", type="MODEL", component=Doubler())
        chain.fallback = UnitSpec(name="b", type="MODEL", component=Doubler())
        chain.fallback.fallback = UnitSpec(name="c", type="MODEL", component=Doubler())
        with pytest.raises(GraphSpecError, match="degradation"):
            validate_graph(chain)
        # an unexecutable fallback fails like any unexecutable node
        bad = UnitSpec(name="a", type="MODEL", component=Doubler())
        bad.fallback = UnitSpec(name="b", type="MODEL")
        with pytest.raises(GraphSpecError, match="no component"):
            validate_graph(bad)

    def test_serde_and_clone_round_trip_fallback(self):
        spec = UnitSpec.from_dict({
            "name": "big", "type": "MODEL",
            "endpoint": {"host": "h", "port": 9000, "transport": "GRPC"},
            "fallback": {"name": "small", "type": "MODEL", "implementation": "SIMPLE_MODEL"},
        })
        assert spec.fallback is not None and spec.fallback.name == "small"
        assert [u.name for u in spec.walk()] == ["big", "small"]
        assert spec.to_dict()["fallback"]["name"] == "small"
        clone = spec.clone()
        assert clone.fallback is not spec.fallback
        assert clone.fallback.name == "small"

    def test_fallback_taken_on_open_circuit_with_degraded_tag(self):
        primary = UnitSpec(name="big", type="MODEL")
        primary.endpoint = Endpoint(host="127.0.0.1", port=_free_port(), transport="GRPC")
        primary.fallback = UnitSpec(name="small", type="MODEL", component=Doubler())
        events = []
        ex = executor.GraphExecutor(
            primary,
            observer=lambda ev, unit, payload: events.append((ev, unit, payload)),
            annotations={"seldon.io/breaker-failures": "2", "seldon.io/grpc-retries": "2",
                         "seldon.io/grpc-read-timeout": "400"},
        )

        async def scenario():
            m = _msg()
            m.meta.puid = "fb-1"
            out1 = await ex.predict(m)  # retries exhaust -> fallback
            m2 = _msg()
            m2.meta.puid = "fb-2"
            t0 = time.perf_counter()
            out2 = await ex.predict(m2)  # breaker open -> instant fallback
            fast_ms = (time.perf_counter() - t0) * 1000.0
            await ex.close()
            return out1, out2, fast_ms

        out1, out2, fast_ms = _run(scenario())
        for out in (out1, out2):
            np.testing.assert_allclose(np.asarray(out.host_payload()), [[2.0, 4.0]])
            assert out.meta.tags["degraded"] is True
            assert out.meta.tags["fallback_for"] == "big"
            assert out.meta.request_path.get("small") is not None
        assert fast_ms < 100.0
        assert [p for ev, unit, p in events if ev == "node_fallback"] == ["UPSTREAM_GRPC_ERROR", "CIRCUIT_OPEN"]

    def test_fallback_not_taken_for_deterministic_errors(self):
        class Rejecter:
            def predict(self, X, names, meta=None):
                raise MicroserviceError("bad input", status_code=400, reason="BAD_REQUEST")

        primary = UnitSpec(name="big", type="MODEL", component=Rejecter())
        primary.fallback = UnitSpec(name="small", type="MODEL", component=Doubler())
        ex = executor.GraphExecutor(primary)

        async def scenario():
            with pytest.raises(MicroserviceError) as ei:
                await ex.predict(_msg())
            await ex.close()
            return ei.value

        assert _run(scenario()).reason == "BAD_REQUEST"  # the 4xx surfaces, undegraded

    def test_fallback_not_taken_for_remote_deterministic_4xx(self):
        """A remote 4xx comes back as a 502 UPSTREAM_REST_ERROR tagged
        ``transient=False``, so the fallback layer refuses it: a malformed
        payload would fail the same way on the fallback."""
        from aiohttp import web

        async def bad_request(_r):
            return web.json_response({"bad": True}, status=400)

        async def scenario():
            app = web.Application()
            app.router.add_post("/predict", bad_request)
            server, _ = await _rest_node(app)
            primary = UnitSpec(name="big", type="MODEL",
                               endpoint=Endpoint(host="127.0.0.1", port=server.port, transport="REST"))
            primary.fallback = UnitSpec(name="small", type="MODEL", component=Doubler())
            ex = executor.GraphExecutor(primary)
            try:
                with pytest.raises(MicroserviceError) as ei:
                    await ex.predict(_msg())
            finally:
                await ex.close()
                await server.close()
            return ei.value

        err = _run(scenario())
        assert err.reason == "UPSTREAM_REST_ERROR"
        assert err.transient is False
        assert "400" in str(err)  # the real status surfaces, undegraded

    def test_executor_builds_clients_for_fallback_subtree(self):
        primary = UnitSpec(name="big", type="MODEL", component=Doubler())
        primary.fallback = UnitSpec(name="small", type="MODEL", component=Doubler())
        ex = executor.GraphExecutor(primary)
        assert "small" in ex.clients  # built with the graph, not on failure


# ---------------------------------------------------------------------------
# parity with the JAX package, held exactly
# ---------------------------------------------------------------------------


class FakeClock:
    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now


BREAKER_SCRIPT = [
    # (step, argument): a trip, fast-fails, the cooldown, probes, a probe
    # success, a second trip, a probe failure, a cancelled probe, discard
    ("transient", None), ("transient", None), ("acquire", None), ("transient", None),
    ("acquire", None), ("advance", 0.25), ("acquire", None), ("advance", 0.5), ("state", None),
    ("acquire", None), ("acquire", None), ("acquire", None), ("release", (0, None)),
    ("acquire", None), ("release", (1, True)), ("release", (2, None)), ("state", None),
    ("transient", None), ("release", (None, True)), ("transient", None), ("transient", None),
    ("transient", None), ("acquire", None), ("advance", 0.75), ("acquire", None), ("transient", None),
    ("release", (3, False)), ("acquire", None), ("advance", 0.76), ("acquire", None), ("release", (4, None)),
    ("state", None), ("discard", None),
]


def _drive_breaker(pkg, monkeypatch):
    mod = PACKAGES[pkg].transport
    clock = FakeClock()
    monkeypatch.setattr(mod, "time", types.SimpleNamespace(monotonic=clock.monotonic,
                                                          perf_counter=time.perf_counter))
    b = mod.CircuitBreaker.for_endpoint("10.0.0.7:5001", failures=3, reset_s=0.75, probes=2)
    probes, trace = [], []
    for step, arg in BREAKER_SCRIPT:
        seen = None
        if step == "transient":
            b.on_transient()
        elif step == "advance":
            clock.now += arg
        elif step == "acquire":
            try:
                probes.append(b.acquire("resnet", "predict", "grpc"))
                seen = ("admitted", probes[-1])
            except PACKAGES[pkg].component.MicroserviceError as e:
                seen = ("fastfail", e.status_code, e.reason, e.message)
        elif step == "release":
            index, healthy = arg
            b.release(False if index is None else probes[index], healthy)
        elif step == "discard":
            mod.CircuitBreaker.discard("10.0.0.7:5001")
            seen = mod.CircuitBreaker.for_endpoint("10.0.0.7:5001") is not b
        trace.append((step, seen, b.state, dict(b.counters), b.stats()))
    return trace


def test_breaker_event_script_matches_jax_exactly(monkeypatch):
    ours, theirs = _drive_breaker("torch_port", monkeypatch), _drive_breaker("jax", monkeypatch)
    assert ours == theirs
    fastfails = [s[1] for s in ours if isinstance(s[1], tuple) and s[1][0] == "fastfail"]
    assert len(fastfails) >= 4 and "next probe in 0.75s" in fastfails[0][3]
    assert {s[2] for s in ours} == {BREAKER_CLOSED, BREAKER_OPEN, BREAKER_HALF_OPEN}
    assert ours[-1][1] is True  # discard evicted the breaker


def _errors(pkg):
    err = PACKAGES[pkg].component.MicroserviceError

    def make(status, reason, transient=None):
        e = err("x", status_code=status, reason=reason)
        if transient is not None:
            e.transient = transient
        return e

    return {
        "502_transient": make(502, "UPSTREAM_GRPC_ERROR", True),
        "502_deterministic": make(502, "UPSTREAM_REST_ERROR", False),
        "502_untagged": make(502, "UPSTREAM_GRPC_ERROR"),
        "503_circuit_open": make(503, "CIRCUIT_OPEN"),
        "503_shed": make(503, "SHED"),
        "504_deadline": make(504, "DEADLINE_EXCEEDED"),
        "503_deadline": make(503, "DEADLINE_EXCEEDED"),
        "400": make(400, "BAD_REQUEST"),
        "500": make(500, "MICROSERVICE_ERROR"),
        "runtime_error": RuntimeError("boom"),
    }


def test_fallback_worthy_matches_jax():
    ours = {k: executor.GraphExecutor._fallback_worthy(e) for k, e in _errors("torch_port").items()}
    theirs = {k: jax_executor.GraphExecutor._fallback_worthy(e) for k, e in _errors("jax").items()}
    assert ours == theirs
    assert {k for k, v in ours.items() if v} == {"502_transient", "502_untagged", "503_circuit_open", "503_shed"}


FALLBACK_SPEC = {
    "name": "big", "type": "MODEL", "endpoint": {"host": "h", "port": 9000, "transport": "GRPC"},
    "parameters": [{"name": "seed", "value": "1", "type": "INT"}],
    "fallback": {"name": "small", "type": "MODEL", "implementation": "SIMPLE_MODEL",
                 "parameters": [{"name": "precision", "value": "int8w", "type": "STRING"}]},
}

INVALID_FALLBACKS = {
    "chain": {"name": "a", "type": "MODEL", "implementation": "SIMPLE_MODEL",
              "fallback": {"name": "b", "type": "MODEL", "implementation": "SIMPLE_MODEL",
                           "fallback": {"name": "c", "type": "MODEL", "implementation": "SIMPLE_MODEL"}}},
    "duplicate": {"name": "a", "type": "MODEL", "implementation": "SIMPLE_MODEL",
                  "fallback": {"name": "a", "type": "MODEL", "implementation": "SIMPLE_MODEL"}},
    "unexecutable": {"name": "a", "type": "MODEL", "implementation": "SIMPLE_MODEL",
                     "fallback": {"name": "b", "type": "MODEL"}},
    "chain_in_a_child": {"name": "r", "type": "ROUTER", "implementation": "RANDOM_ABTEST", "children": [
        {"name": "a", "type": "MODEL", "implementation": "SIMPLE_MODEL",
         "fallback": {"name": "b", "type": "MODEL", "implementation": "SIMPLE_MODEL",
                      "fallback": {"name": "c", "type": "MODEL", "implementation": "SIMPLE_MODEL"}}}]},
}


def test_fallback_serde_matches_jax():
    ours, theirs = UnitSpec.from_dict(FALLBACK_SPEC), jax_graph.UnitSpec.from_dict(FALLBACK_SPEC)
    assert ours.to_dict() == theirs.to_dict() == FALLBACK_SPEC
    assert ours.clone().to_dict() == theirs.clone().to_dict()
    assert [u.name for u in ours.walk()] == [u.name for u in theirs.walk()]


@pytest.mark.parametrize("case", sorted(INVALID_FALLBACKS))
def test_fallback_validation_matches_jax(case):
    errors = {}
    for pkg, ns in PACKAGES.items():
        with pytest.raises(ns.graph.GraphSpecError) as info:
            ns.graph.validate_graph(ns.graph.UnitSpec.from_dict(INVALID_FALLBACKS[case]))
        errors[pkg] = str(info.value)
    assert errors["torch_port"] == errors["jax"]


class ScriptedReplica:
    """A replica client that records its calls and raises its script's
    next error (None answers)."""

    def __init__(self, pkg, name, log, script=()):
        self.unit = PACKAGES[pkg].graph.UnitSpec(name=name, type="MODEL")
        self.pkg, self.log, self.script = pkg, log, list(script)
        self.closed = False

    async def _answer(self, method):
        self.log.append((self.unit.name, method))
        error = self.script.pop(0) if self.script else None
        if error is not None:
            status, reason = error
            if status is None:
                raise ConnectionError(reason)
            raise PACKAGES[self.pkg].component.MicroserviceError(reason, status_code=status, reason=reason)
        return self.unit.name

    async def transform_input(self, msg):
        return await self._answer("transform_input")

    async def send_feedback(self, feedback):
        return await self._answer("send_feedback")

    async def ready(self):
        return True

    async def close(self):
        self.closed = True


def _balanced_story(pkg):
    """Rotation, failover order, 4xx surfacing, feedback without
    failover, replica swap and NO_REPLICAS on one BalancedClient."""
    ns = PACKAGES[pkg]
    log, outcomes = [], []
    r = {name: ScriptedReplica(pkg, name, log, script) for name, script in (
        ("r0", [None, None, (502, "UPSTREAM_GRPC_ERROR"), None, (400, "BAD_REQUEST"), (502, "UPSTREAM_GRPC_ERROR")]),
        ("r1", [None, (503, "CIRCUIT_OPEN"), (None, "reset"), None]),
        ("r2", [(502, "UPSTREAM_GRPC_ERROR"), None, (503, "CIRCUIT_OPEN"), (502, "UPSTREAM_GRPC_ERROR")]))}
    balanced = ns.transport.BalancedClient([r["r0"], r["r1"], r["r2"]])

    async def call(method, arg):
        try:
            outcomes.append(("ok", await getattr(balanced, method)(arg)))
        except Exception as e:  # noqa: BLE001 — the outcome is what is compared
            outcomes.append(("error", type(e).__name__, getattr(e, "status_code", None), getattr(e, "reason", None)))

    async def story():
        for _ in range(6):
            await call("transform_input", None)
        await call("send_feedback", None)
        await call("send_feedback", None)
        balanced.set_clients([r["r2"]])
        await call("transform_input", None)
        balanced.set_clients([])
        await call("transform_input", None)
        return await balanced.ready()

    ready = _run(story())
    return log, outcomes, ready, balanced.replica_count, {k: v.closed for k, v in r.items()}


def test_balanced_client_matches_jax():
    ours, theirs = _balanced_story("torch_port"), _balanced_story("jax")
    assert ours == theirs
    log, outcomes, ready, count, closed = ours
    assert ("error", "MicroserviceError", 503, "NO_REPLICAS") == outcomes[-1]
    assert any(o[2:] == (400, "BAD_REQUEST") for o in outcomes)  # a 4xx surfaced at once
    feedback = [entry for entry in log if entry[1] == "send_feedback"]
    assert feedback == [("r0", "send_feedback"), ("r1", "send_feedback")]  # the failed one was not replayed
    assert outcomes[6:8] == [("error", "MicroserviceError", 502, "UPSTREAM_GRPC_ERROR"), ("ok", "r1")]
    assert ready is False and count == 0
    assert closed == {"r0": True, "r1": True, "r2": True}  # each retired replica closed at the next call


def _containment_series(mod, registry):
    mod.record_breaker_state("127.0.0.1:5001", "open", registry=registry)
    mod.record_breaker_state("127.0.0.1:5001", "half_open", registry=registry)
    mod.record_breaker_state("127.0.0.1:5001", "open", registry=registry)
    mod.record_breaker_state("127.0.0.1:5002", "half_open", registry=registry)
    mod.record_breaker_state("127.0.0.1:5002", "closed", registry=registry)
    for _ in range(3):
        mod.record_breaker_fastfail("model", "predict", "grpc", registry=registry)
    mod.record_breaker_fastfail("model", "route", "local", registry=registry)
    mod.record_transport_hedge("model", "predict", "grpc", registry=registry)
    mod.record_transport_hedge("model", "predict", "grpc", registry=registry)
    mod.record_transport_hedge("model", "predict", "grpc", won=True, registry=registry)
    mod.record_transport_hedge("router", "route", "rest", registry=registry)
    mod.record_transport_failover("model", "transform_input", registry=registry)
    mod.record_transport_failover("model", "transform_input", registry=registry)
    mod.record_transport_failover("model", "aggregate", transport="grpc", registry=registry)
    for _ in range(4):
        mod.increment_counter("seldon_tpu_graph_fallbacks_total",
                              "requests answered by a fallback route because the "
                              "primary's breaker was open or its retries exhausted", registry=registry)


def test_containment_series_match_prometheus_client():
    prom = pytest.importorskip("prometheus_client")
    from seldon_core_tpu.utils import metrics as jax_metrics
    from seldon_core_tpu_torch.utils import metrics

    sys.path.insert(0, os.path.dirname(__file__))
    from test_torch_port_metrics import parse  # noqa: E402

    jreg, preg = prom.CollectorRegistry(), metrics.Registry()
    _containment_series(jax_metrics, jreg)
    _containment_series(metrics, preg)
    theirs, their_types = parse(prom.generate_latest(jreg).decode())
    ours, our_types = parse(metrics.generate_latest(preg).decode())
    assert our_types == their_types
    assert set(ours) == set(theirs)
    for key, value in theirs.items():
        if not key[0].endswith("_created"):
            assert ours[key] == value, key
    assert ours[("seldon_tpu_transport_breaker_state", (("endpoint", "127.0.0.1:5001"),))] == 2.0
    assert ours[("seldon_tpu_transport_breaker_state", (("endpoint", "127.0.0.1:5002"),))] == 0.0
    assert ours[("seldon_tpu_graph_fallbacks_total", ())] == 4.0
    # the help strings are JAX's too
    help_lines = lambda text: sorted(x for x in text.splitlines() if x.startswith("# HELP"))  # noqa: E731
    assert help_lines(metrics.generate_latest(preg).decode()) == help_lines(prom.generate_latest(jreg).decode())


def test_c16_local_model_with_fallback_is_fast_path_eligible_in_both():
    """ROADMAP.md C16, by design: JAX's single_local_model looks only at
    the node's children and type, so a one-node local MODEL with a
    fallback takes the sync fast path, which never runs the fallback,
    while the async path degrades.  The port mirrors it."""
    results = {}
    for pkg, ns in PACKAGES.items():
        error = ns.component.MicroserviceError

        class Shedding:
            def predict(self, X, names, meta=None):
                raise error("shed", status_code=503, reason="SHED")

        spec = ns.graph.UnitSpec(name="m", type="MODEL", component=Shedding())
        spec.fallback = ns.graph.UnitSpec(name="f", type="MODEL", component=Doubler())
        svc = ns.engine.PredictorService(spec, name="p")
        eligible = svc.single_local_model() is not None
        sync = svc.predict_sync(_msg(pkg=pkg))
        asyn = _run(svc.predict(_msg(pkg=pkg)))
        results[pkg] = (eligible, sync.status["code"], sync.status["reason"], asyn.status["code"],
                        dict(asyn.meta.tags), np.asarray(asyn.host_payload()).tolist())
    assert results["torch_port"] == results["jax"]
    assert results["torch_port"] == (True, 503, "SHED", 200, {"degraded": True, "fallback_for": "m"},
                                     [[2.0, 4.0]])
