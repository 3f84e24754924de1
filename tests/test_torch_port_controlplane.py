"""The port's control plane against the JAX package's.

Mirrors ``tests/test_controlplane.py`` (spec, defaulting and validation,
placement, the deployer's rolling updates, the supervisor, annotations)
and holds the port's own rules: C26 rewrites ``JAX_SERVER`` to
``CUDA_SERVER``, a JAX-package ``component_class`` or a mesh of more
than one device is refused, placement never plans a quiet CPU
deployment, and a native front end that cannot start raises.  Every
``examples/*.yaml`` defaults to the JAX package's dict, and an applied
``CUDA_SERVER`` ``mlp`` answers within 1e-5 of the JAX deployer's.
"""

import asyncio
import json
import logging
import pathlib
import socket
import ssl
import time
import urllib.request

import numpy as np
import pytest

from seldon_core_tpu.controlplane import Deployer as JaxDeployer
from seldon_core_tpu.controlplane import TpuDeployment as JaxTpuDeployment
from seldon_core_tpu.controlplane import default_and_validate as jax_default_and_validate
from seldon_core_tpu.runtime.message import InternalMessage as JaxInternalMessage
from seldon_core_tpu_torch.controlplane import (
    Deployer,
    DeploymentSpecError,
    TpuDeployment,
    apply_defaults,
    default_and_validate,
    plan_placement,
    serve_deployment,
    validate,
)
from seldon_core_tpu_torch.runtime.message import InternalMessage

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = sorted((ROOT / "examples").glob("*.yaml"))
TLS_DIR = ROOT / "tests" / "data" / "torch_port_tls"


def run(coro):
    return asyncio.run(coro)


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


SIMPLE_SPEC = {
    "name": "simple",
    "predictors": [{"name": "main", "graph": {"name": "stub", "type": "MODEL", "implementation": "SIMPLE_MODEL"}}],
}

AB_SPEC = {
    "name": "abtest",
    "predictors": [
        {"name": "a", "traffic": 75, "graph": {"name": "stub", "type": "MODEL", "implementation": "SIMPLE_MODEL"}},
        {"name": "b", "traffic": 25, "graph": {"name": "stub", "type": "MODEL", "implementation": "SIMPLE_MODEL"}},
    ],
}


def fixed_model_spec(name, values):
    return {
        "name": name,
        "predictors": [{
            "name": "main",
            "graph": {
                "name": "fixed", "type": "MODEL",
                "componentClass": "tests.test_torch_port_controlplane.FixedModel",
                "parameters": [{"name": "values_json", "value": str(list(values)), "type": "STRING"}],
            },
        }],
    }


class FixedModel:
    """Deterministic model for rolling-update tests."""

    def __init__(self, values_json="[1, 2, 3, 4]"):
        self.values = json.loads(values_json.replace("'", '"'))

    def predict(self, X, names, meta=None):
        return np.array([self.values], dtype=np.float64)


def _msg(value=0.0):
    return InternalMessage(payload=np.array([[value]]), kind="tensor")


def _jax_server_to_cuda_server(d):
    if isinstance(d, dict):
        return {k: ("CUDA_SERVER" if k == "implementation" and str(v).upper() == "JAX_SERVER"
                    else _jax_server_to_cuda_server(v)) for k, v in d.items()}
    if isinstance(d, list):
        return [_jax_server_to_cuda_server(v) for v in d]
    return d


class TestSpec:
    def test_yaml_roundtrip(self):
        dep = TpuDeployment.from_yaml("""
name: img
annotations: {seldon.io/grpc-read-timeout: "5000"}
predictors:
  - name: main
    traffic: 100
    replicas: 2
    graph:
      name: clf
      type: MODEL
      implementation: SIMPLE_MODEL
""")
        assert dep.name == "img" and dep.predictors[0].replicas == 2
        assert dep.annotation_float("seldon.io/grpc-read-timeout", 0) == 5000
        assert TpuDeployment.from_dict(dep.to_dict()).predictors[0].graph.implementation == "SIMPLE_MODEL"
        assert dep.to_dict() == JaxTpuDeployment.from_dict(dep.to_dict()).to_dict()

    def test_missing_graph(self):
        with pytest.raises(DeploymentSpecError):
            TpuDeployment.from_dict({"name": "x", "predictors": [{"name": "p"}]})


class TestDefaultingValidation:
    def test_ports_and_traffic_defaulted(self):
        dep = apply_defaults(TpuDeployment.from_dict(AB_SPEC | {"predictors": [
            {**AB_SPEC["predictors"][0], "traffic": 0}, {**AB_SPEC["predictors"][1], "traffic": 0}]}))
        assert dep.http_port == 8000 and dep.grpc_port == 5001
        assert [p.traffic for p in dep.predictors] == [50.0, 50.0]

    def test_traffic_sum_validated(self):
        dep = TpuDeployment.from_dict(AB_SPEC)
        dep.predictors[0].traffic = 90
        assert any("traffic" in p for p in validate(apply_defaults(dep)))

    def test_bad_graph_rejected(self):
        dep = TpuDeployment.from_dict({"name": "bad", "predictors": [{"name": "p", "graph": {"name": "c",
                                                                                             "type": "COMBINER"}}]})
        with pytest.raises(DeploymentSpecError, match="COMBINER"):
            default_and_validate(dep)

    def test_duplicate_predictors_rejected(self):
        dep = TpuDeployment.from_dict(SIMPLE_SPEC)
        dep.predictors.append(dep.predictors[0])
        assert any("duplicate" in p for p in validate(dep))

    def test_jax_server_rewritten_logged_and_recorded(self, caplog):
        """C26: a JAX_SERVER node serves as CUDA_SERVER; the rewrite is
        logged and recorded in the spec's status, not in its dict."""
        spec = {"name": "c26", "predictors": [{"name": "main", "graph": {
            "name": "router", "type": "ROUTER", "implementation": "RANDOM_ABTEST", "children": [
                {"name": "a", "type": "MODEL", "implementation": "JAX_SERVER"},
                {"name": "b", "type": "MODEL", "implementation": "jax_server"}]}}]}
        with caplog.at_level(logging.INFO, logger="seldon_core_tpu_torch.controlplane.defaulting"):
            dep = default_and_validate(TpuDeployment.from_dict(spec))
        assert [u.implementation for u in dep.predictors[0].graph.walk()] == ["RANDOM_ABTEST", "CUDA_SERVER",
                                                                              "CUDA_SERVER"]
        assert len(dep.status["rewrites"]) == 2 and "'a': JAX_SERVER -> CUDA_SERVER" in dep.status["rewrites"][0]
        assert sum("C26" in r.getMessage() for r in caplog.records) == 2
        assert "status" not in dep.to_dict()
        jax_dict = jax_default_and_validate(JaxTpuDeployment.from_dict(spec)).to_dict()
        assert dep.to_dict() == _jax_server_to_cuda_server(jax_dict) != jax_dict

    def test_jax_package_component_class_refused(self):
        spec = {"name": "iso", "predictors": [{"name": "main", "graph": {
            "name": "clf", "type": "MODEL", "componentClass": "seldon_core_tpu.models.jaxserver.JaxServer"}}]}
        with pytest.raises(DeploymentSpecError, match="belongs to the JAX package.*never imports it"):
            default_and_validate(TpuDeployment.from_dict(spec))
        ok = json.loads(json.dumps(spec).replace("seldon_core_tpu.", "seldon_core_tpu_torch."))
        default_and_validate(TpuDeployment.from_dict(ok))

    def test_mesh_of_more_than_one_device_defaults_like_jax(self):
        """A mesh of more than one device was refused here until A12
        landed; now it passes the webhook as the JAX package's does, and
        the spec defaults to the JAX package's."""
        for axes in ({"data": 2, "model": 2}, {"data": 1}):
            dep = TpuDeployment.from_dict(SIMPLE_SPEC)
            dep.predictors[0].mesh_axes = dict(axes)
            theirs = JaxTpuDeployment.from_dict(SIMPLE_SPEC)
            theirs.predictors[0].mesh_axes = dict(axes)
            mine = default_and_validate(dep)
            assert mine.predictors[0].mesh_axes == axes
            assert mine.to_dict() == _jax_server_to_cuda_server(jax_default_and_validate(theirs).to_dict())

    @pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.name)
    def test_examples_default_like_the_jax_package(self, path):
        theirs = jax_default_and_validate(JaxTpuDeployment.load(str(path))).to_dict()
        mine = TpuDeployment.load(str(path))
        assert default_and_validate(mine).to_dict() == _jax_server_to_cuda_server(theirs)


class TestPlacement:
    def test_round_robin(self):
        dep = default_and_validate(TpuDeployment.from_dict(AB_SPEC))
        plan = plan_placement(dep, device_ids=[0, 1, 2, 3])
        a, b = plan.for_predictor("a").device_ids, plan.for_predictor("b").device_ids
        assert len(a) == len(b) == 1 and a != b

    def test_explicit_claims(self):
        dep = default_and_validate(TpuDeployment.from_dict(AB_SPEC))
        dep.predictors[0].device_ids = [3]
        plan = plan_placement(dep, device_ids=[0, 1, 2, 3])
        assert plan.for_predictor("a").device_ids == [3] and plan.for_predictor("b").device_ids != [3]

    def test_mesh_request_sizes_group(self, monkeypatch):
        """The group is sized by the mesh; ``build_mesh`` (once refused,
        A12) returns the port's Mesh over the group's CUDA devices, shaped
        as the JAX package's, and fails placement for ids the host's
        cards do not have."""
        import torch

        from seldon_core_tpu_torch.parallel import Mesh, mesh_shape

        dep = default_and_validate(TpuDeployment.from_dict(SIMPLE_SPEC))
        dep.predictors[0].mesh_axes = {"data": 2, "model": 2}
        plan = plan_placement(dep, device_ids=list(range(8)))
        placement = plan.for_predictor("main")
        assert len(placement.device_ids) == 4
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
        mesh = placement.build_mesh()
        assert isinstance(mesh, Mesh) and mesh_shape(mesh) == {"data": 2, "model": 2}
        assert [str(d) for d in mesh.devices.flat] == [f"cuda:{i}" for i in placement.device_ids]
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        with pytest.raises(DeploymentSpecError, match="not among this host's 2 CUDA devices"):
            placement.build_mesh()

    def test_unavailable_claim_rejected(self):
        dep = default_and_validate(TpuDeployment.from_dict(SIMPLE_SPEC))
        dep.predictors[0].device_ids = [99]
        with pytest.raises(DeploymentSpecError):
            plan_placement(dep, device_ids=[0, 1])

    def test_no_card_and_no_device_ids_raises(self, monkeypatch):
        import torch

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
        dep = default_and_validate(TpuDeployment.from_dict(SIMPLE_SPEC))
        with pytest.raises(DeploymentSpecError, match="no CUDA device.*device_ids"):
            plan_placement(dep)
        with pytest.raises(DeploymentSpecError, match="no CUDA device"):
            run(Deployer().apply(TpuDeployment.from_dict(SIMPLE_SPEC)))

    def test_cards_are_counted_by_torch(self, monkeypatch):
        import torch

        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        plan = plan_placement(default_and_validate(TpuDeployment.from_dict(AB_SPEC)))
        assert {plan.for_predictor("a").device_ids[0], plan.for_predictor("b").device_ids[0]} == {0, 1}


class TestDeployer:
    def test_apply_and_predict(self):
        async def scenario():
            deployer = Deployer(device_ids=[0])
            managed = await deployer.apply(TpuDeployment.from_dict(SIMPLE_SPEC))
            out = await managed.gateway.predict(_msg(1.0))
            status = await deployer.status("simple")
            await deployer.delete("simple")
            return out, status, await deployer.status("simple")

        out, status, gone = run(scenario())
        assert out.status["status"] == "SUCCESS"
        assert status["state"] == "Available" and status["generation"] == 1 and status["rewrites"] == []
        assert status["predictors"]["main"]["devices"] == [0]
        assert gone["state"] == "Absent"

    def test_rolling_update_swaps_model(self):
        async def scenario():
            deployer = Deployer(device_ids=[0])
            managed = await deployer.apply(TpuDeployment.from_dict(fixed_model_spec("roll", [1, 2, 3, 4])))
            out1 = await managed.gateway.predict(_msg())
            await deployer.apply(TpuDeployment.from_dict(fixed_model_spec("roll", [5, 6, 7, 8])))
            out2 = await managed.gateway.predict(_msg())
            status = await deployer.status("roll")
            await deployer.delete("roll")
            return out1, out2, status

        out1, out2, status = run(scenario())
        np.testing.assert_array_equal(out1.payload, [[1, 2, 3, 4]])
        np.testing.assert_array_equal(out2.payload, [[5, 6, 7, 8]])
        assert status["generation"] == 2

    def test_rolling_reapply_under_load_loses_no_request(self):
        async def scenario():
            deployer = Deployer(device_ids=[0])
            managed = await deployer.apply(TpuDeployment.from_dict(fixed_model_spec("load", [1, 1, 1, 1])))
            seen, failures, stop = [], [], asyncio.Event()

            async def client():
                while not stop.is_set():
                    out = await managed.gateway.predict(_msg())
                    if out.status and out.status.get("status") == "FAILURE":
                        failures.append(out.status)
                    else:
                        seen.append(float(np.asarray(out.payload).ravel()[0]))
                    await asyncio.sleep(0)

            tasks = [asyncio.ensure_future(client()) for _ in range(4)]
            await asyncio.sleep(0.2)
            await deployer.apply(TpuDeployment.from_dict(fixed_model_spec("load", [2, 2, 2, 2])))
            await asyncio.sleep(0.2)
            stop.set()
            await asyncio.gather(*tasks)
            status = await deployer.status("load")
            await deployer.delete("load")
            return seen, failures, status

        seen, failures, status = run(scenario())
        assert failures == [] and status["generation"] == 2
        first_two = seen.index(2.0)
        assert set(seen[:first_two]) == {1.0} and set(seen[first_two:]) == {2.0} and len(seen) > 20

    def test_invalid_update_keeps_old_generation(self):
        async def scenario():
            deployer = Deployer(device_ids=[0])
            managed = await deployer.apply(TpuDeployment.from_dict(fixed_model_spec("keep", [1, 1, 1, 1])))
            bad = TpuDeployment.from_dict({"name": "keep", "predictors": [{"name": "p", "graph": {
                "name": "c", "type": "COMBINER"}}]})
            with pytest.raises(DeploymentSpecError):
                await deployer.apply(bad)
            out = await managed.gateway.predict(_msg())
            await deployer.delete("keep")
            return out

        np.testing.assert_array_equal(run(scenario()).payload, [[1, 1, 1, 1]])

    def test_ab_traffic_split(self):
        async def scenario():
            deployer = Deployer(device_ids=[0, 1])
            spec = TpuDeployment.from_dict({"name": "ab", "predictors": [
                {"name": "a", "traffic": 50, "graph": fixed_model_spec("x", [1, 1, 1, 1])["predictors"][0]["graph"]},
                {"name": "b", "traffic": 50, "graph": fixed_model_spec("x", [2, 2, 2, 2])["predictors"][0]["graph"]},
            ]})
            managed = await deployer.apply(spec)
            seen = set()
            for _ in range(40):
                seen.add(tuple(np.asarray((await managed.gateway.predict(_msg())).payload).ravel()))
            status = await deployer.status("ab")
            await deployer.delete("ab")
            return seen, status

        seen, status = run(scenario())
        assert seen == {(1.0,) * 4, (2.0,) * 4}
        assert sorted(p["devices"][0] for p in status["predictors"].values()) == [0, 1]

    def test_mlp_deployment_answers_like_the_jax_deployers(self, tmp_path):
        """One spec, both deployers: the JAX one serves JAX_SERVER, the
        port's serves it as CUDA_SERVER on the CPU with the JAX server's
        weights (a flax msgpack read by models/convert.py)."""
        from flax import serialization

        params = [{"name": "model", "value": "mlp", "type": "STRING"},
                  {"name": "num_classes", "value": "3", "type": "INT"},
                  {"name": "input_shape", "value": "[4]", "type": "JSON"},
                  {"name": "dtype", "value": "float32", "type": "STRING"},
                  {"name": "warmup", "value": "false", "type": "BOOL"}]

        def spec(extra):
            return {"name": "mlp", "predictors": [{"name": "main", "graph": {
                "name": "clf", "type": "MODEL", "implementation": "JAX_SERVER", "parameters": params + extra}}]}

        x = np.random.default_rng(0).normal(size=(5, 4))
        ckpt = tmp_path / "mlp.msgpack"

        async def jax_side():
            deployer = JaxDeployer(device_ids=[0])
            managed = await deployer.apply(JaxTpuDeployment.from_dict(spec([])))
            component = managed.gateway.predictors[0].executor.component("clf")
            ckpt.write_bytes(serialization.to_bytes(component.variables))
            out = await managed.gateway.predict(JaxInternalMessage(payload=x, kind="tensor"))
            await deployer.delete("mlp")
            return np.asarray(out.payload)

        async def port_side():
            deployer = Deployer(device_ids=[0])
            managed = await deployer.apply(TpuDeployment.from_dict(spec([
                {"name": "device", "value": "cpu", "type": "STRING"},
                {"name": "model_uri", "value": f"file://{ckpt}", "type": "STRING"}])))
            status = await deployer.status("mlp")
            out = await managed.gateway.predict(InternalMessage(payload=x, kind="tensor"))
            component = managed.gateway.predictors[0].executor.component("clf")
            await deployer.delete("mlp")
            return np.asarray(out.payload), status, component

        theirs = run(jax_side())
        mine, status, component = run(port_side())
        # a deleted generation is unloaded: its batcher stopped, its weights let go
        assert not component._loaded and component.module is None and not component.batcher._running
        assert status["rewrites"] == ["predictor 'main' node 'clf': JAX_SERVER -> CUDA_SERVER"]
        assert mine.shape == theirs.shape == (5, 3)
        np.testing.assert_allclose(mine, theirs, atol=1e-5, rtol=0)


def test_reapply_keeps_an_in_process_component_loaded():
    """A component object the spec carries is shared by both generations
    (``UnitSpec.clone``): draining the old one must not unload it."""
    from seldon_core_tpu_torch.models.cudaserver import CudaServer

    server = CudaServer(model="mlp", num_classes=3, input_shape=[4], dtype="float32", device="cpu", warmup=False)
    x = np.random.default_rng(1).normal(size=(2, 4))

    def spec():
        s = TpuDeployment.from_dict({"name": "obj", "predictors": [{"name": "main", "graph": {
            "name": "clf", "type": "MODEL"}}]})
        s.predictors[0].graph.component = server
        return s

    async def scenario():
        deployer = Deployer(device_ids=[0])
        managed = await deployer.apply(spec())
        first = await managed.gateway.predict(InternalMessage(payload=x, kind="tensor"))
        old = managed.current
        await deployer.apply(spec())
        assert await asyncio.to_thread(old.drained.wait, 30)
        # read before the next request, which would load an unloaded server again
        loaded = server._loaded and server.module is not None and server.batcher._running
        after = await managed.gateway.predict(InternalMessage(payload=x, kind="tensor"))
        status = await deployer.status("obj")
        await deployer.delete("obj")
        return first, after, status, loaded

    try:
        first, after, status, loaded = run(scenario())
        assert status["generation"] == 2 and loaded
        assert after.status is None or after.status.get("status") != "FAILURE"
        np.testing.assert_array_equal(np.asarray(after.payload), np.asarray(first.payload))
    finally:
        server.unload()


def test_drain_waits_for_work_held_in_flight():
    """The native fast lane calls a component without ``predict``; it
    holds ``in_flight`` so a drain (and the unload after it) waits."""
    import threading

    from seldon_core_tpu_torch.engine.graph import UnitSpec
    from seldon_core_tpu_torch.engine.service import PredictorService

    svc = PredictorService(UnitSpec(name="m", type="MODEL", component=FixedModel()), name="main")
    entered, release = threading.Event(), threading.Event()

    def batch():
        with svc.in_flight():
            entered.set()
            release.wait(10)

    t = threading.Thread(target=batch)
    t.start()
    assert entered.wait(10)

    async def drain(timeout_s):
        return await svc.drain(timeout_s=timeout_s)

    assert run(drain(0.2)) is False and svc.paused  # held: the drain times out
    release.set()
    t.join(10)
    assert not t.is_alive() and run(drain(5.0)) is True and svc.stats["requests"] == 0


class TestServeDeployment:
    def test_native_frontend_that_cannot_start_raises(self, monkeypatch):
        """No quiet fallback: the JAX deployer serves the Python app when
        the C++ front server cannot start; the port raises."""
        from seldon_core_tpu_torch.engine import native_ingress

        async def broken(*a, **k):
            raise RuntimeError("native library unavailable")

        monkeypatch.setattr(native_ingress, "serve_native_ingress", broken)
        http_port = free_port()

        async def scenario():
            deployer = Deployer(device_ids=[0])
            await deployer.apply(TpuDeployment.from_dict(SIMPLE_SPEC | {"annotations": {
                "seldon.io/frontend": "native"}}))
            try:
                with pytest.raises(RuntimeError, match="native library unavailable"):
                    await serve_deployment(deployer, "simple", host="127.0.0.1", http_port=http_port,
                                           grpc_port=free_port())
            finally:
                await deployer.delete("simple")

        run(scenario())
        with pytest.raises(OSError):  # nothing serves the port in its place
            urllib.request.urlopen(f"http://127.0.0.1:{http_port}/ready", timeout=2)

    def test_unknown_frontend_refused(self):
        async def scenario():
            deployer = Deployer(device_ids=[0])
            await deployer.apply(TpuDeployment.from_dict(SIMPLE_SPEC | {"annotations": {
                "seldon.io/frontend": "nginx"}}))
            try:
                with pytest.raises(DeploymentSpecError, match="frontend"):
                    await serve_deployment(deployer, "simple", host="127.0.0.1", http_port=free_port(),
                                           grpc_port=free_port())
            finally:
                await deployer.delete("simple")

        run(scenario())

    def test_tls_annotation_selects_the_python_front_end(self, caplog):
        http_port = free_port()
        annotations = {"seldon.io/frontend": "native", "seldon.io/tls-cert": str(TLS_DIR / "server.crt"),
                       "seldon.io/tls-key": str(TLS_DIR / "server.key")}

        async def scenario():
            deployer = Deployer(device_ids=[0])
            await deployer.apply(TpuDeployment.from_dict(SIMPLE_SPEC | {"annotations": annotations}))
            runner, grpc_srv = await serve_deployment(deployer, "simple", host="127.0.0.1", http_port=http_port,
                                                      grpc_port=free_port())
            try:
                ctx = ssl.create_default_context(cafile=str(TLS_DIR / "ca.crt"))
                ctx.check_hostname = False

                def get():
                    body = json.dumps({"data": {"ndarray": [[1.0]]}}).encode()
                    req = urllib.request.Request(f"https://127.0.0.1:{http_port}/api/v0.1/predictions", data=body,
                                                 headers={"Content-Type": "application/json"})
                    with urllib.request.urlopen(req, context=ctx, timeout=10) as resp:
                        return json.loads(resp.read())

                return await asyncio.get_running_loop().run_in_executor(None, get)
            finally:
                await runner.cleanup()
                await grpc_srv.stop(0)
                await deployer.delete("simple")

        with caplog.at_level(logging.WARNING):
            out = run(scenario())
        assert out["meta"]["tags"]["predictor"] == "main"
        assert any("TLS requested: using python frontend" in r.getMessage() for r in caplog.records)


class TestSupervisor:
    def test_spawn_ready_restart(self):
        from seldon_core_tpu_torch.controlplane import ProcessSpec, Supervisor

        sup = Supervisor()
        try:
            sp = sup.add(ProcessSpec(name="stub", component="seldon_core_tpu_torch.engine.units.StubModel",
                                     http_port=free_port(), grpc_port=free_port(), api="REST"), wait_ready_s=60.0)
            assert sp._command()[1:3] == ["-m", "seldon_core_tpu_torch.runtime.microservice"]
            assert sp.ready()
            sp.proc.kill()
            assert sp.wait_ready(timeout_s=60.0) and sp.restarts >= 1
            health = sup.health()["stub"]
            assert health["ready"] and health["state"] == "running" and not health["exhausted"]
        finally:
            sup.stop_all()

    def test_worker_specs_run_the_ports_components(self):
        from seldon_core_tpu_torch.controlplane.supervisor import disagg_worker_specs, replica_worker_specs

        disagg = disagg_worker_specs("lm", prefill_workers=2)
        assert [s.component for s in disagg] == ["seldon_core_tpu_torch.models.disagg.PrefillLM"] * 2 + [
            "seldon_core_tpu_torch.models.disagg.DisaggregatedLM"]
        endpoints = json.loads(json.loads(disagg[-1].parameters_json)[-1]["value"])
        assert endpoints == ["grpc://127.0.0.1:9601", "grpc://127.0.0.1:9602"]
        replicas = replica_worker_specs("lm", replicas=3)
        assert {s.component for s in replicas} == {"seldon_core_tpu_torch.models.paged.StreamingLM"}
        assert [s.env["SELDON_TPU_EVACUATE_TO"] for s in replicas] == [
            "grpc://127.0.0.1:9801", "grpc://127.0.0.1:9802", "grpc://127.0.0.1:9800"]

    def test_remote_node_runs_as_a_supervised_worker(self):
        """A ``remote: true`` node is spawned as the port's microservice
        and reached over gRPC; /debug/workers lists it."""
        from aiohttp.test_utils import TestClient, TestServer

        from seldon_core_tpu_torch.engine import server

        spec = {"name": "remote", "predictors": [{"name": "main", "graph": {
            "name": "stub", "type": "MODEL", "implementation": "SIMPLE_MODEL", "remote": True}}]}

        async def scenario():
            deployer = Deployer(device_ids=[0])
            managed = await deployer.apply(TpuDeployment.from_dict(spec))
            try:
                out = await managed.gateway.predict(_msg(3.0))
                client = TestClient(TestServer(server.build_gateway_app(managed.gateway)))
                await client.start_server()
                try:
                    workers = await (await client.get("/debug/workers")).json()
                    fleet = await (await client.get("/debug/fleet")).json()
                finally:
                    await client.close()
                proc = managed.current.supervisor.processes["remote-main-stub"].proc
            finally:
                await deployer.delete("remote")
            return out, workers, fleet, proc

        out, workers, fleet, proc = run(scenario())
        assert out.status["status"] == "SUCCESS"
        assert workers["workers"]["remote-main-stub"]["state"] == "running"
        assert fleet["enabled"] and list(fleet["replicas"]) == ["remote-main-stub"]
        assert fleet["rollup"]["replicas_total"] == 1
        assert "seldon_core_tpu_torch.runtime.microservice" in proc.args
        deadline = time.monotonic() + 10
        while proc.poll() is None and time.monotonic() < deadline:
            time.sleep(0.1)
        assert proc.poll() is not None


class TestAnnotations:
    def test_transport_knobs_from_annotations(self):
        from seldon_core_tpu_torch.engine.executor import build_client
        from seldon_core_tpu_torch.engine.graph import Endpoint, UnitSpec
        from seldon_core_tpu_torch.engine.transport import GrpcClient, RestClient

        ann = {"seldon.io/rest-connection-timeout": "1500", "seldon.io/rest-read-timeout": "9000",
               "seldon.io/rest-retries": "7", "seldon.io/grpc-read-timeout": "2500"}
        rest = build_client(UnitSpec(name="r", type="MODEL", endpoint=Endpoint(transport="REST")), ann)
        assert isinstance(rest, RestClient)
        assert (rest.connect_timeout_s, rest.read_timeout_s, rest.retries) == (1.5, 9.0, 7)
        grpc_client = build_client(UnitSpec(name="g", type="MODEL", endpoint=Endpoint(transport="GRPC")), ann)
        assert isinstance(grpc_client, GrpcClient) and grpc_client.deadline_s == 2.5

    def test_request_logger_annotations(self, tmp_path):
        from seldon_core_tpu_torch.controlplane import deployer
        from seldon_core_tpu_torch.utils.reqlogger import HttpPairLogger, JsonlPairLogger

        path = str(tmp_path / "pairs.jsonl")
        assert isinstance(deployer._gateway_logger_from_annotations({"seldon.io/request-logger": path}),
                          JsonlPairLogger)
        assert isinstance(deployer._request_logger_from_annotations({"seldon.io/request-log-jsonl": path}),
                          JsonlPairLogger)
        http = deployer._gateway_logger_from_annotations({"seldon.io/request-logger": "http://127.0.0.1:9/"})
        assert isinstance(http, HttpPairLogger)
        http.close(timeout_s=0.5)
        with pytest.raises(DeploymentSpecError, match="kafka:brokers/topic"):
            deployer._gateway_logger_from_annotations({"seldon.io/request-logger": "kafka:nobroker"})

        async def scenario():
            d = Deployer(device_ids=[0])
            managed = await d.apply(TpuDeployment.from_dict(SIMPLE_SPEC | {"annotations": {
                "seldon.io/request-logger": path}}))
            out = await managed.gateway.predict(_msg(2.0))
            await d.delete("simple")
            return out

        out = run(scenario())
        (pair,) = [json.loads(line) for line in open(path)]
        assert pair["puid"] == out.meta.puid

    def test_worker_ready_timeout_validated(self):
        spec = {"name": "r", "annotations": {"seldon.io/worker-ready-timeout-s": "0"}, "predictors": [{
            "name": "main", "graph": {"name": "stub", "type": "MODEL", "implementation": "SIMPLE_MODEL",
                                      "remote": True}}]}
        with pytest.raises(DeploymentSpecError, match="worker-ready-timeout-s"):
            run(Deployer(device_ids=[0]).apply(TpuDeployment.from_dict(spec)))

    def test_control_plane_annotations_are_declared(self):
        from seldon_core_tpu_torch.runtime import knobs

        for name in ("seldon.io/frontend", "seldon.io/tls-cert", "seldon.io/oauth-key", "seldon.io/request-logger",
                     "seldon.io/request-log-kafka", "seldon.io/worker-ready-timeout-s"):
            assert knobs.declared(name), name
