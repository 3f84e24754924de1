"""The port's engine graph against the JAX package's.

The scenarios of ``tests/test_executor.py`` (single model, chains,
combiners, routing, meta semantics, feedback propagation, validation,
lifecycle) run through both packages' ``PredictorService`` from the same
graph dict, with stub units: the builtins (``SIMPLE_MODEL``,
``AVERAGE_COMBINER``, ``RANDOM_ABTEST``) and the seeded learned routers
(``EPSILON_GREEDY``, ``THOMPSON_SAMPLING``) by name, and duck-typed toy
components defined here (one class serves both packages).  Held equal:
every response as deterministic proto bytes with the puid cleared
(payload, ``requestPath``, ``routing``, merged tags, collected metrics),
the branch sequences, and the routers' state after feedback.  Then the
remote hops (``GrpcClient``, ``RestClient``) to a port microservice on
loopback, the self-healing annotations and fallback routes, and the
refusals of what the port leaves out.
"""

import asyncio
import socket

import numpy as np
import pytest

import seldon_core_tpu.engine as jax_engine
from seldon_core_tpu.engine import graph as jax_graph
from seldon_core_tpu.runtime.message import InternalFeedback as JaxFeedback
from seldon_core_tpu.runtime.message import InternalMessage as JaxMessage
import seldon_core_tpu_torch.engine as engine
from seldon_core_tpu_torch.engine import graph, transport
from seldon_core_tpu_torch.engine.executor import build_client
from seldon_core_tpu_torch.runtime import MicroserviceError, grpc_server, rest
from seldon_core_tpu_torch.runtime.message import InternalFeedback, InternalMessage

PACKAGES = {
    "jax": (jax_engine, jax_graph, JaxMessage, JaxFeedback),
    "torch_port": (engine, graph, InternalMessage, InternalFeedback),
}


class AddN:
    def __init__(self, n=1.0, tag=None):
        self.n = n
        self.tag = tag

    def predict(self, X, names, meta=None):
        return np.asarray(X) + self.n

    def tags(self):
        return {self.tag: True} if self.tag else {}

    def metrics(self):
        return [{"key": f"addn_{self.n}", "type": "COUNTER", "value": 1.0}]


class FbModel(AddN):
    def __init__(self, n=1.0):
        super().__init__(n)
        self.rewards = []

    def send_feedback(self, features, names, reward, truth, routing=None):
        self.rewards.append(reward)


class TimesN:
    def __init__(self, n=2.0):
        self.n = n

    def transform_input(self, X, names, meta=None):
        return np.asarray(X) * self.n


class NegOutput:
    def transform_output(self, X, names, meta=None):
        return -np.asarray(X)


class FixedRouter:
    def __init__(self, branch=0):
        self.branch = branch
        self.feedback = []

    def route(self, features, names):
        return self.branch

    def send_feedback(self, features, names, reward, truth, routing=None):
        self.feedback.append((reward, routing))


class SumCombiner:
    def aggregate(self, features_list, names_list):
        return np.sum([np.asarray(f) for f in features_list], axis=0)


class Boom:
    def predict(self, X, names, meta=None):
        raise RuntimeError("boom")


@pytest.fixture(autouse=True)
def fresh_breakers():
    """Breakers are a process-wide registry keyed by endpoint: a breaker
    one test tripped must not fast-fail the next test's calls."""
    jax_engine.CircuitBreaker.reset_all()
    engine.CircuitBreaker.reset_all()
    yield
    jax_engine.CircuitBreaker.reset_all()
    engine.CircuitBreaker.reset_all()


def node(name, type_, children=(), **kw):
    return {"name": name, "type": type_, "children": list(children), **kw}


def service(pkg, graph_dict, components=None, **kw):
    eng = PACKAGES[pkg][0]
    spec = eng.UnitSpec.from_dict(graph_dict)
    for unit in spec.walk():
        if components and unit.name in components:
            unit.component = components[unit.name]()
    return eng.PredictorService(spec, **kw)


def request(pkg, arr, puid=""):
    msg = PACKAGES[pkg][2](payload=np.asarray(arr, dtype=np.float64), kind="tensor")
    msg.meta.puid = puid
    return msg


def wire(out) -> bytes:
    proto = out.to_proto()
    proto.meta.puid = ""
    return proto.SerializeToString(deterministic=True)


def run(coro):
    return asyncio.run(coro)


def predict_all(pkg, graph_dict, components, inputs, feedback_reward=None):
    """Serve `inputs` in order (optionally feeding back a reward after
    each); returns (wire bytes, status dicts, routing maps, service)."""
    svc = service(pkg, graph_dict, components)

    async def go():
        outs = []
        for x in inputs:
            out = await svc.predict(request(pkg, x))
            outs.append(out)
            if feedback_reward is not None:
                fb = PACKAGES[pkg][3](request=request(pkg, x), response=out, reward=feedback_reward(out))
                await svc.send_feedback(fb)
        return outs

    outs = run(go())
    return [wire(o) for o in outs], [o.status for o in outs], [dict(o.meta.routing) for o in outs], svc


M = {"type": "MODEL"}
SCENARIOS = {
    # TestSingleModel
    "single_model": (node("m", "MODEL"), {"m": lambda: AddN(5.0)}, [[[1.0]]]),
    "stub_model_builtin": (node("stub", "MODEL", implementation="SIMPLE_MODEL"), None, [[[1.0, 2.0]]]),
    # TestChains
    "transformer_model_chain": (node("t", "TRANSFORMER", [node("m", "MODEL")]),
                                {"t": lambda: TimesN(3.0), "m": lambda: AddN(1.0)}, [[[2.0]]]),
    "output_transformer": (node("ot", "OUTPUT_TRANSFORMER", [node("m", "MODEL")]),
                           {"ot": NegOutput, "m": lambda: AddN(1.0)}, [[[2.0]]]),
    # TestCombiner
    "average_combiner_builtin": (node("c", "COMBINER", [node("m1", "MODEL"), node("m2", "MODEL")],
                                      implementation="AVERAGE_COMBINER"),
                                 {"m1": lambda: AddN(0.0), "m2": lambda: AddN(2.0)}, [[[1.0, 3.0]]]),
    "sum_combiner_fanout": (node("c", "COMBINER", [node(f"m{i}", "MODEL") for i in range(4)]),
                            {"c": SumCombiner, **{f"m{i}": (lambda i=i: AddN(float(i))) for i in range(4)}},
                            [[[0.0]]]),
    "multi_child_without_combiner_fails": (node("t", "TRANSFORMER", [node("m1", "MODEL"), node("m2", "MODEL")]),
                                           {"t": TimesN, "m1": AddN, "m2": AddN}, [[[1.0]]]),
    "combiner_shape_mismatch": (node("c", "COMBINER", [node("m1", "MODEL", implementation="SIMPLE_MODEL"),
                                                       node("m2", "MODEL")], implementation="AVERAGE_COMBINER"),
                                {"m2": AddN}, [[[1.0]]]),
    # TestRouting
    "router_selects_branch": (node("r", "ROUTER", [node("a", "MODEL"), node("b", "MODEL")]),
                              {"r": lambda: FixedRouter(1), "a": lambda: AddN(10.0), "b": lambda: AddN(20.0)},
                              [[[1.0]]]),
    "router_minus_one_needs_combiner": (node("r", "ROUTER", [node("a", "MODEL"), node("b", "MODEL")]),
                                        {"r": lambda: FixedRouter(-1), "a": AddN, "b": AddN}, [[[1.0]]]),
    "invalid_branch_rejected": (node("r", "ROUTER", [node("a", "MODEL")]),
                                {"r": lambda: FixedRouter(7), "a": AddN}, [[[1.0]]]),
    "simple_router_builtin": (node("r", "ROUTER", [node("a", "MODEL"), node("b", "MODEL")],
                                   implementation="SIMPLE_ROUTER"),
                              {"a": lambda: AddN(1.0), "b": lambda: AddN(2.0)}, [[[1.0]]]),
    # TestMetaSemantics
    "tags_merge_latest_wins": (node("outer", "TRANSFORMER", [node("inner", "MODEL")]),
                               {"outer": lambda: TimesN(1.0), "inner": lambda: AddN(0.0, tag="inner")}, [[[1.0]]]),
    "metrics_collected_across_nodes": (node("c", "COMBINER", [node("m1", "MODEL"), node("m2", "MODEL")]),
                                       {"c": SumCombiner, "m1": lambda: AddN(1.0), "m2": lambda: AddN(2.0)},
                                       [[[0.0]]]),
    # TestLifecycle
    "failure_status_on_component_error": (node("m", "MODEL"), {"m": Boom}, [[[1.0]]]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jax(name):
    graph_dict, components, inputs = SCENARIOS[name]
    got = {pkg: predict_all(pkg, graph_dict, components, inputs) for pkg in PACKAGES}
    assert got["torch_port"][0] == got["jax"][0]
    assert got["torch_port"][1] == got["jax"][1]
    assert got["torch_port"][2] == got["jax"][2]


def test_scenarios_give_the_reference_answers():
    """The parity above holds answers the executor tests expect."""
    def one(name):
        _, statuses, routing, svc = predict_all("torch_port", *SCENARIOS[name])
        return statuses[0], routing[0], svc

    def payload(name):
        graph_dict, components, inputs = SCENARIOS[name]
        svc = service("torch_port", graph_dict, components)
        return run(svc.predict(request("torch_port", inputs[0])))

    assert np.array_equal(payload("single_model").payload, [[6.0]])
    assert np.array_equal(payload("transformer_model_chain").payload, [[7.0]])
    assert np.array_equal(payload("output_transformer").payload, [[-3.0]])
    assert np.array_equal(payload("average_combiner_builtin").payload, [[2.0, 4.0]])
    assert np.array_equal(payload("sum_combiner_fanout").payload, [[6.0]])
    out = payload("router_selects_branch")
    assert np.array_equal(out.payload, [[21.0]]) and out.meta.routing["r"] == 1
    assert "b" in out.meta.request_path and "a" not in out.meta.request_path
    assert payload("tags_merge_latest_wins").meta.tags == {"inner": True}
    assert sorted(m["key"] for m in payload("metrics_collected_across_nodes").meta.metrics) == [
        "addn_1.0", "addn_2.0"]
    assert one("multi_child_without_combiner_fails")[0]["reason"] == "ENGINE_MISSING_COMBINER"
    assert one("router_minus_one_needs_combiner")[0]["reason"] == "ENGINE_MISSING_COMBINER"
    assert one("invalid_branch_rejected")[0]["reason"] == "ENGINE_INVALID_ROUTING"
    assert one("combiner_shape_mismatch")[0]["reason"] == "COMBINER_SHAPE_MISMATCH"
    status, _, svc = one("failure_status_on_component_error")
    assert status["status"] == "FAILURE" and svc.stats["failures"] == 1
    out = payload("stub_model_builtin")
    assert np.array_equal(out.payload, engine.StubModel.OUTPUT) and out.names == engine.StubModel.NAMES


ROUTERS = {
    "RANDOM_ABTEST": ([{"name": "ratio_a", "value": "0.5", "type": "FLOAT"},
                       {"name": "seed", "value": "42", "type": "INT"}],
                      lambda r: {"requests": list(r.branch_requests), "reward": list(r.branch_reward)}),
    "EPSILON_GREEDY": ([{"name": "n_branches", "value": "2", "type": "INT"},
                        {"name": "epsilon", "value": "0.3", "type": "FLOAT"},
                        {"name": "seed", "value": "7", "type": "INT"}],
                       lambda r: {"counts": r.counts.tolist(), "sums": r.reward_sums.tolist(), "eps": r.epsilon}),
    "THOMPSON_SAMPLING": ([{"name": "n_branches", "value": "2", "type": "INT"},
                           {"name": "seed", "value": "7", "type": "INT"}],
                          lambda r: {"alpha": r.alpha.tolist(), "beta": r.beta.tolist()}),
}


@pytest.mark.parametrize("impl", sorted(ROUTERS))
def test_seeded_router_branch_sequence_and_state_after_feedback(impl):
    params, state_of = ROUTERS[impl]
    graph_dict = node("ab", "ROUTER", [node("a", "MODEL"), node("b", "MODEL")], implementation=impl,
                      parameters=params)
    components = {"a": lambda: AddN(1.0), "b": lambda: AddN(2.0)}
    inputs = [[[float(i)]] for i in range(30)]

    def reward(out):  # branch b pays: the learned routers drift to it
        return 1.0 if out.meta.routing["ab"] == 1 else 0.0

    got = {pkg: predict_all(pkg, graph_dict, components, inputs, feedback_reward=reward) for pkg in PACKAGES}
    assert got["torch_port"][0] == got["jax"][0]
    branches = [r["ab"] for r in got["torch_port"][2]]
    assert branches == [r["ab"] for r in got["jax"][2]]
    assert set(branches) == {0, 1}
    states = {pkg: state_of(got[pkg][3].executor.component("ab")) for pkg in PACKAGES}
    assert states["torch_port"] == states["jax"]


def test_feedback_reaches_routed_model_only():
    for pkg in PACKAGES:
        models = {"a": FbModel(1.0), "b": FbModel(2.0)}
        router = FixedRouter(0)
        comps = {"r": lambda: router, "a": lambda: models["a"], "b": lambda: models["b"]}
        svc = service(pkg, node("r", "ROUTER", [node("a", "MODEL"), node("b", "MODEL")]), comps)

        async def go():
            resp = await svc.predict(request(pkg, [[1.0]]))
            await svc.send_feedback(PACKAGES[pkg][3](request=request(pkg, [[1.0]]), response=resp, reward=0.5))

        run(go())
        assert models["a"].rewards == [0.5] and models["b"].rewards == [], pkg
        assert router.feedback == [(0.5, 0)], pkg


def test_puid_generated_and_stable():
    svc = service("torch_port", node("m", "MODEL"), {"m": AddN})
    assert run(svc.predict(request("torch_port", [[1.0]]))).meta.puid
    assert run(svc.predict(request("torch_port", [[1.0]], puid="fixed"))).meta.puid == "fixed"
    puids = {engine.new_puid() for _ in range(1000)}
    assert len(puids) == 1000


INVALID = {
    "duplicate_names": node("x", "TRANSFORMER", [node("x", "MODEL", implementation="SIMPLE_MODEL")],
                            implementation="SIMPLE_MODEL"),
    "combiner_without_children": node("c", "COMBINER", implementation="AVERAGE_COMBINER"),
    "router_without_children": node("r", "ROUTER", implementation="SIMPLE_ROUTER"),
    "unexecutable_node": node("m", "MODEL"),
    "unknown_type": node("m", "DETECTOR"),
    "missing_name": {"type": "MODEL"},
}


@pytest.mark.parametrize("case", sorted(INVALID))
def test_validate_graph_errors_match(case):
    errors = {}
    for pkg, (_, g, _, _) in PACKAGES.items():
        with pytest.raises(g.GraphSpecError) as info:
            g.validate_graph(g.UnitSpec.from_dict(INVALID[case]))
        errors[pkg] = str(info.value)
    assert errors["torch_port"] == errors["jax"]


def test_from_dict_roundtrip_matches():
    d = node("r", "ROUTER", [
        node("a", "MODEL", implementation="SIMPLE_MODEL"),
        node("b", "MODEL", endpoint={"host": "h", "port": 9001, "transport": "GRPC"}),
    ], implementation="RANDOM_ABTEST", parameters=[{"name": "ratio_a", "value": "0.7", "type": "FLOAT"}])
    back = {pkg: g.UnitSpec.from_dict(d).to_dict() for pkg, (_, g, _, _) in PACKAGES.items()}
    assert back["torch_port"] == back["jax"]
    assert back["torch_port"]["children"][1]["endpoint"]["port"] == 9001


def test_pause_flips_readiness_and_drain_completes():
    svc = service("torch_port", node("m", "MODEL"), {"m": AddN})
    assert run(svc.ready()) is True
    svc.pause()
    assert run(svc.ready()) is False
    svc.unpause()
    assert run(svc.ready()) is True

    async def scenario():
        await svc.predict(request("torch_port", [[1.0]]))
        return await svc.drain(timeout_s=1.0)

    assert run(scenario()) is True and svc.paused


def test_predict_sync_matches_the_async_path():
    svc = service("torch_port", node("m", "MODEL"), {"m": lambda: AddN(2.0, tag="t")})
    sync = svc.predict_sync(request("torch_port", [[1.0]], puid="p"))
    asyn = run(svc.predict(request("torch_port", [[1.0]], puid="p")))
    assert wire(sync) == wire(asyn) and sync.status == asyn.status
    chain = service("torch_port", node("t", "TRANSFORMER", [node("m", "MODEL")]), {"t": TimesN, "m": AddN})
    with pytest.raises(MicroserviceError) as info:
        chain.predict_sync(request("torch_port", [[1.0]]))
    assert info.value.reason == "NOT_FAST_PATH"


def test_cuda_server_and_streaming_lm_are_registered():
    from seldon_core_tpu_torch.engine import units
    from seldon_core_tpu_torch.models.cudaserver import CudaServer
    from seldon_core_tpu_torch.models.paged import StreamingLM

    assert units._lookup_builtin("CUDA_SERVER") is CudaServer
    assert units._lookup_builtin("STREAMING_LM") is StreamingLM
    assert units._lookup_builtin("epsilon_greedy").__name__ == "EpsilonGreedy"
    with pytest.raises(MicroserviceError) as info:
        units.make_builtin("JAX_SERVER")
    assert info.value.reason == "UNKNOWN_IMPLEMENTATION"


def test_cuda_server_by_name_serves_through_the_graph():
    params = [{"name": "model", "value": "resnet_tiny", "type": "STRING"},
              {"name": "num_classes", "value": "4", "type": "INT"},
              {"name": "dtype", "value": "float32", "type": "STRING"},
              {"name": "max_batch_size", "value": "2", "type": "INT"},
              {"name": "warmup", "value": "false", "type": "BOOL"},
              {"name": "device", "value": "cpu", "type": "STRING"}]
    svc = service("torch_port", node("resnet", "MODEL", implementation="CUDA_SERVER", parameters=params))
    try:
        x = np.random.default_rng(0).integers(0, 256, (2, 32, 32, 3)).astype(np.uint8)
        out = run(svc.predict(InternalMessage(payload=x, kind="rawTensor")))
        assert out.status["status"] == "SUCCESS" and np.asarray(out.payload).shape == (2, 4)
        assert out.meta.request_path == {"resnet": "CUDA_SERVER"}
        assert any(m["key"] == "cudaserver_batches_total" for m in out.meta.metrics)
    finally:
        svc.executor.component("resnet").unload()


# ---------------------------------------------------------------- remote hops


class Doubler:
    def predict(self, X, names, meta=None):
        return np.asarray(X) * 2

    def class_names(self):
        return ["a", "b"]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("transport_name", ["GRPC", "REST"])
def test_remote_hop_to_a_port_microservice(transport_name):
    async def scenario():
        port = free_port()
        if transport_name == "GRPC":
            server = grpc_server.build_server(Doubler())
            server.add_insecure_port(f"127.0.0.1:{port}")
            await server.start()
        else:
            runner = await rest.serve(rest.build_app(Doubler()), host="127.0.0.1", port=port)
        svc = service("torch_port", node("remote-m", "MODEL", endpoint={
            "host": "127.0.0.1", "port": port, "transport": transport_name}))
        try:
            client = svc.executor.clients["remote-m"]
            assert isinstance(client, transport.GrpcClient if transport_name == "GRPC" else transport.RestClient)
            assert await svc.ready()
            out = await svc.predict(InternalMessage(payload=np.array([[7.0, 1.5]]), kind="tensor"))
        finally:
            await svc.close()
            if transport_name == "GRPC":
                await server.stop(grace=None)
            else:
                await runner.cleanup()
        return out

    out = run(scenario())
    local = run(service("jax", node("remote-m", "MODEL"), {"remote-m": Doubler}).predict(
        JaxMessage(payload=np.array([[7.0, 1.5]]), kind="tensor")))
    assert wire(out) == wire(local)
    np.testing.assert_array_equal(out.payload, [[14.0, 3.0]])


@pytest.mark.parametrize("transport_name", ["GRPC", "REST"])
def test_remote_hop_retries_then_reports_every_attempt(transport_name):
    port = free_port()  # nothing listens there
    ann = {"seldon.io/grpc-retries": "2", "seldon.io/rest-retries": "2",
           "seldon.io/grpc-read-timeout": "2000", "seldon.io/rest-read-timeout": "2000"}
    svc = service("torch_port", node("m", "MODEL", endpoint={
        "host": "127.0.0.1", "port": port, "transport": transport_name}), annotations=ann)

    async def go():
        try:
            return await svc.predict(InternalMessage(payload=np.array([[1.0]]), kind="tensor"))
        finally:
            await svc.close()

    out = run(go())
    assert out.status["status"] == "FAILURE" and out.status["code"] == 502
    assert out.status["reason"] == f"UPSTREAM_{transport_name}_ERROR"
    assert '"attempt": 2' in out.status["info"] and '"attempt": 3' not in out.status["info"]


def test_build_client_honours_the_timeout_and_retry_annotations():
    ann = {"seldon.io/rest-connection-timeout": "250", "seldon.io/rest-read-timeout": "1500",
           "seldon.io/rest-retries": "4", "seldon.io/grpc-read-timeout": "750", "seldon.io/grpc-retries": "bad"}
    rest_client = build_client(graph.UnitSpec.from_dict(
        node("r", "MODEL", endpoint={"host": "h", "port": 1, "transport": "REST"})), ann)
    grpc_client = build_client(graph.UnitSpec.from_dict(
        node("g", "MODEL", endpoint={"host": "h", "port": 2, "transport": "GRPC"})), ann)
    assert (rest_client.connect_timeout_s, rest_client.read_timeout_s, rest_client.retries) == (0.25, 1.5, 4)
    assert (grpc_client.deadline_s, grpc_client.retries) == (0.75, 3)


def test_backoff_is_full_jitter_and_capped():
    for attempt in range(8):
        for _ in range(50):
            assert 0.0 <= engine.backoff_s(attempt) <= min(2.0, 0.05 * 2 ** attempt)


SELF_HEALING = {
    # annotation -> (value, what the built remote client carries); once
    # refused by name, each now configures the client as in JAX
    "seldon.io/breaker": ("off", lambda c: c.breaker is None),
    "seldon.io/breaker-failures": ("7", lambda c: (c.breaker.failures, c.breaker.reset_s, c.breaker.probes) == (7, 1.0, 2)),
    "seldon.io/hedge-ms": ("5", lambda c: c.hedge_ms == 5.0 and c.breaker.failures == 5),
}


@pytest.mark.parametrize("annotation", sorted(SELF_HEALING))
def test_self_healing_annotations_are_refused_by_name(annotation):
    """Each self-healing annotation configures the breaker or the hedge
    delay on the built client, as JAX's build_client does, and a graph
    carrying it serves."""
    value, holds = SELF_HEALING[annotation]
    ann = {annotation: value}
    remote = node("g", "MODEL", endpoint={"host": "h", "port": 2, "transport": "GRPC"})
    built = {}
    for pkg, (eng, g, _, _) in PACKAGES.items():
        eng.CircuitBreaker.reset_all()
        built[pkg] = eng.build_client(g.UnitSpec.from_dict(remote), ann)
        assert holds(built[pkg]), pkg
    ours, theirs = built["torch_port"], built["jax"]
    assert ours.hedge_ms == theirs.hedge_ms
    assert (ours.breaker is None) == (theirs.breaker is None)
    if ours.breaker is not None:
        assert ours.breaker.key == theirs.breaker.key == "h:2"
        assert ours.breaker is transport.CircuitBreaker.for_endpoint("h:2")
    svc = service("torch_port", node("m", "MODEL", implementation="SIMPLE_MODEL"), annotations=ann)
    assert run(svc.predict(request("torch_port", [[1.0]]))).status["status"] == "SUCCESS"


FALLBACKS = {
    "one_step": node("m", "MODEL", implementation="SIMPLE_MODEL",
                     fallback=node("f", "MODEL", implementation="SIMPLE_MODEL")),
    "fallback_of_a_fallback": node("m", "MODEL", implementation="SIMPLE_MODEL", fallback=node(
        "f", "MODEL", implementation="SIMPLE_MODEL",
        fallback=node("g", "MODEL", implementation="SIMPLE_MODEL"))),
}


def shedding(pkg):
    """A MODEL that sheds every request with a transient 503 (SHED)."""
    from seldon_core_tpu.runtime.component import MicroserviceError as JaxError

    error = JaxError if pkg == "jax" else MicroserviceError

    class Shedding:
        def predict(self, X, names, meta=None):
            raise error("shed", status_code=503, reason="SHED")

    return Shedding


@pytest.mark.parametrize("case", sorted(FALLBACKS))
def test_fallback_routes_are_refused_by_name(case):
    """A single fallback is built and answers, degraded, when its primary
    sheds, as in JAX; a fallback of a fallback is refused at validation
    with JAX's message."""
    if case == "fallback_of_a_fallback":
        errors = {}
        for pkg, (_, g, _, _) in PACKAGES.items():
            with pytest.raises(g.GraphSpecError) as info:
                service(pkg, FALLBACKS[case])
            errors[pkg] = str(info.value)
        assert errors["torch_port"] == errors["jax"]
        assert "only one degradation step is allowed" in errors["torch_port"]
        return
    outs = {}
    for pkg in PACKAGES:
        svc = service(pkg, FALLBACKS[case], {"m": shedding(pkg)})
        assert "f" in svc.executor.clients
        outs[pkg] = run(svc.predict(request(pkg, [[1.0, 2.0]], puid="p")))
    assert wire(outs["torch_port"]) == wire(outs["jax"])
    assert outs["torch_port"].meta.tags == {"degraded": True, "fallback_for": "m"}
    assert outs["torch_port"].meta.request_path == {"m": "SIMPLE_MODEL", "f": "SIMPLE_MODEL"}


def test_remote_node_without_endpoint_is_refused():
    with pytest.raises(MicroserviceError) as info:
        service("torch_port", node("m", "MODEL", implementation="SIMPLE_MODEL", remote=True))
    assert info.value.reason == "BAD_GRAPH"
