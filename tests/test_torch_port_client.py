"""The port's client SDK and tools.

Mirrors ``tests/test_client_and_tools.py``'s ``TestClientSdk``,
``TestContractTester``, ``TestLoadgen``, ``TestPackager`` and
``TestGraphVisualizer`` against the port's gateway (REST and the sync
gRPC server), plus ``RawFrameClient`` against the port's C++ front
server, the three gRPC stream helpers, and ``seldon_top`` over a stub
fleet.  Where both packages compute the same thing (contract batches,
load summaries, DOT and ASCII graphs) the JAX package's output is the
oracle.
"""

import asyncio
import http.server
import json
import os
import socket
import subprocess
import threading
import time
import urllib.request

import numpy as np
import pytest

from seldon_core_tpu.testing.contract import Contract as JaxContract
from seldon_core_tpu.utils import graphviz as jax_graphviz
from seldon_core_tpu_torch.client.client import RawFrameClient, SeldonTpuClient, random_payload
from seldon_core_tpu_torch.engine.graph import UnitSpec
from seldon_core_tpu_torch.engine.server import Gateway, serve_gateway
from seldon_core_tpu_torch.engine.service import PredictorService
from seldon_core_tpu_torch.runtime.component import TPUComponent
from seldon_core_tpu_torch.testing.contract import Contract, run_contract_test
from seldon_core_tpu_torch.testing.loadgen import run_load

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class Doubler(TPUComponent):
    def predict(self, X, names, meta=None):
        return np.asarray(X) * 2


class Counter(TPUComponent):
    """Streams 0..n-1 for a prompt through the gateway's token lane."""

    def predict(self, X, names, meta=None):
        return np.arange(3, dtype=np.int32)[None, :]

    def predict_stream(self, X, names, meta=None):
        for i in range(3):
            yield np.asarray([i], np.int32)


@pytest.fixture(scope="module")
def live_gateway():
    """A port gateway served on loopback REST + sync gRPC."""
    holder, started = {}, threading.Event()

    async def serve():
        gw = Gateway([(PredictorService(UnitSpec(name="m", type="MODEL", component=Doubler())), 1.0)])
        holder["http_port"], holder["grpc_port"] = free_port(), free_port()
        runner, grpc_srv = await serve_gateway(gw, host="127.0.0.1", http_port=holder["http_port"],
                                               grpc_port=holder["grpc_port"])
        holder["loop"], holder["stop"] = asyncio.get_running_loop(), asyncio.Event()
        started.set()
        await holder["stop"].wait()
        await grpc_srv.stop(0)
        await runner.cleanup()

    t = threading.Thread(target=lambda: asyncio.run(serve()), daemon=True)
    t.start()
    assert started.wait(timeout=30)
    yield holder
    holder["loop"].call_soon_threadsafe(holder["stop"].set)
    t.join(timeout=30)


class TestClientSdk:
    def test_rest_predict(self, live_gateway):
        client = SeldonTpuClient(http_port=live_gateway["http_port"], transport="rest")
        for _ in range(3):  # one keep-alive connection carries them all
            resp = client.predict(np.array([[1.0, 2.0]]))
            assert resp.success
            np.testing.assert_array_equal(resp.data, [[2.0, 4.0]])
            assert resp.meta.puid
        client.close()

    def test_grpc_predict(self, live_gateway):
        client = SeldonTpuClient(grpc_port=live_gateway["grpc_port"], transport="grpc")
        resp = client.predict(np.array([[3.0]]))
        assert resp.success
        np.testing.assert_array_equal(resp.data, [[6.0]])
        client.close()

    def test_raw_tensor_payload(self, live_gateway):
        client = SeldonTpuClient(grpc_port=live_gateway["grpc_port"], transport="grpc")
        resp = client.predict(np.ones((2, 3), np.float32))
        assert resp.success and resp.response.kind == "rawTensor"
        np.testing.assert_array_equal(resp.data, np.full((2, 3), 2.0, np.float32))
        client.close()

    def test_predict_stream_chunks_both_ways(self, live_gateway):
        client = SeldonTpuClient(grpc_port=live_gateway["grpc_port"], transport="grpc")
        x = np.random.default_rng(0).normal(size=(64, 32)).astype(np.float32)
        resp = client.predict_stream(x, chunk_bytes=1024)
        assert resp.success
        np.testing.assert_array_equal(resp.data, x * 2)
        client.close()

    def test_feedback(self, live_gateway):
        client = SeldonTpuClient(http_port=live_gateway["http_port"], transport="rest")
        pred = client.predict(np.array([[1.0]]))
        assert client.feedback(request=np.array([[1.0]]), response=pred.response, reward=1.0).success
        client.close()

    def test_rest_failure_is_reported(self, live_gateway):
        client = SeldonTpuClient(http_port=live_gateway["http_port"], transport="rest")
        resp = client.predict({"not": "an array"})
        assert not resp.success and resp.raw["status"]["status"] == "FAILURE"
        client.close()

    def test_random_payload_shapes(self):
        assert random_payload((3, 7)).shape == (3, 7)
        assert random_payload((2, 2), dtype="uint8").dtype == np.uint8


class TestStreamHelpers:
    def test_generate_stream_over_grpc_and_rest(self):
        holder, started = {}, threading.Event()

        async def serve():
            gw = Gateway([(PredictorService(UnitSpec(name="lm", type="MODEL", component=Counter())), 1.0)])
            holder["http_port"], holder["grpc_port"] = free_port(), free_port()
            runner, grpc_srv = await serve_gateway(gw, host="127.0.0.1", http_port=holder["http_port"],
                                                   grpc_port=holder["grpc_port"])
            holder["loop"], holder["stop"] = asyncio.get_running_loop(), asyncio.Event()
            started.set()
            await holder["stop"].wait()
            await grpc_srv.stop(0)
            await runner.cleanup()

        t = threading.Thread(target=lambda: asyncio.run(serve()), daemon=True)
        t.start()
        assert started.wait(timeout=30)
        try:
            for transport in ("grpc", "rest"):
                client = SeldonTpuClient(http_port=holder["http_port"], grpc_port=holder["grpc_port"],
                                         transport=transport)
                chunks = list(client.generate_stream([1, 2, 3], timeout_s=30))
                client.close()
                assert np.concatenate(chunks).tolist() == [0, 1, 2], transport
        finally:
            holder["loop"].call_soon_threadsafe(holder["stop"].set)
            t.join(timeout=30)

    def test_assemble_chunks_inverts_chunk_message(self):
        from seldon_core_tpu.proto import services as jax_services
        from seldon_core_tpu_torch.proto import pb, services

        msg = pb.SeldonMessage(strData="x" * 5000)
        chunks = list(services.chunk_message(msg, 700))
        assert len(chunks) == 8
        assert services.assemble_chunks(chunks, pb.SeldonMessage) == msg
        assert jax_services.assemble_chunks(chunks, pb.SeldonMessage).strData == msg.strData
        assert services.stream_callable.__doc__ and services.unary_stream_callable.__doc__


class TestRawFrameClient:
    def test_frames_round_trip_through_the_front_server(self):
        from seldon_core_tpu_torch.native.frontserver import NativeFrontServer, pack_raw_frame, unpack_raw_frame

        x = np.random.default_rng(1).normal(size=(3, 4)).astype(np.float32)
        np.testing.assert_array_equal(unpack_raw_frame(pack_raw_frame(x)), x)
        with NativeFrontServer(stub=True, feature_dim=4, out_dim=3, model_name="stub") as srv:
            with RawFrameClient(port=srv.port) as client:
                for rows in (1, 3, 2):  # keep-alive: one connection for all
                    out = client.predict(x[:rows])
                    assert out.shape == (rows, 3)
                    np.testing.assert_allclose(out[:, 0], 0.9)
                sock = client._sock
                out = client.predict(x)
                assert client._sock is sock


class TestContractTester:
    def test_generate_equals_jax(self):
        features = [{"name": "a", "dtype": "float64", "range": [0, 1]},
                    {"name": "b", "dtype": "int64", "range": [1, 5]}]
        mine = Contract(features=features).generate_batch(8, np.random.default_rng(0))
        theirs = JaxContract(features=features).generate_batch(8, np.random.default_rng(0))
        np.testing.assert_array_equal(mine, theirs)
        assert mine.shape == (8, 2) and (mine[:, 1] >= 1).all() and (mine[:, 1] <= 5).all()

    def test_generate_image_shaped(self):
        batch = Contract(features=[{"name": "img", "dtype": "uint8", "range": [0, 255],
                                    "shape": [8, 8, 3]}]).generate_batch(2)
        assert batch.shape == (2, 8, 8, 3) and batch.dtype == np.uint8

    def test_end_to_end_against_gateway(self, live_gateway):
        client = SeldonTpuClient(http_port=live_gateway["http_port"], transport="rest")
        contract = Contract(features=[{"name": "x", "dtype": "float64", "range": [0, 1]}])
        assert run_contract_test(contract, client, n_requests=5, seed=0) == {
            "requests": 5, "succeeded": 5, "failed": 0, "failures": []}
        client.close()


class TestLoadgen:
    def test_percentiles_and_rate(self):
        result = run_load(lambda: True, duration_s=0.2, concurrency=4)
        summary = result.summary()
        assert result.requests > 0 and result.errors == 0
        assert summary["p50_ms"] is not None and summary["qps"] > 0

    def test_cli_native_lane_against_front_server(self, capsys):
        from seldon_core_tpu_torch.native.frontserver import NativeFrontServer
        from seldon_core_tpu_torch.testing.loadgen import main

        with NativeFrontServer(stub=True, feature_dim=4, out_dim=3, model_name="stub") as srv:
            rc = main(["127.0.0.1", str(srv.port), "--native", "--duration", "0.5", "--shape", "1,4",
                       "--connections", "2", "--depth", "4"])
        out = json.loads(capsys.readouterr().out)
        assert rc == 0 and out["ok"] > 0 and out["errors"] == 0 and out["non2xx"] == 0

    def test_cli_python_lane_against_rest_microservice(self, capsys):
        from seldon_core_tpu_torch.runtime import rest
        from seldon_core_tpu_torch.testing.loadgen import main

        async def scenario():
            runner = await rest.serve(rest.build_app(Doubler()), host="127.0.0.1", port=0)
            port = runner.addresses[0][1]
            rc = await asyncio.to_thread(main, ["127.0.0.1", str(port), "--path", "/predict", "--shape", "1,4",
                                                "--duration", "0.5", "--concurrency", "2"])
            await runner.cleanup()
            return rc

        rc = asyncio.run(scenario())
        out = json.loads(capsys.readouterr().out)
        assert rc == 0 and out["qps"] > 0 and out["errors"] == 0

    def test_cli_native_refuses_remote_hosts(self):
        from seldon_core_tpu_torch.testing.loadgen import main

        assert main(["10.0.0.1", "80", "--native", "--duration", "0.1"]) == 2


class TestPackager:
    def _user_repo(self, tmp_path, body=None):
        src = tmp_path / "user-model"
        src.mkdir(parents=True)
        (src / "MyModel.py").write_text(body or (
            "class MyModel:\n    def predict(self, X, names, meta=None):\n        return X\n"))
        (src / "requirements.txt").write_text("numpy\n")
        (src / "environment").write_text("MODEL_NAME=MyModel\nAPI_TYPE=REST\nSERVICE_TYPE=MODEL\nPERSISTENCE=0\n")
        return src

    def test_artifact_names_the_ports_microservice(self, tmp_path):
        from seldon_core_tpu_torch.runtime.packager import package

        meta = package(str(self._user_repo(tmp_path)), str(tmp_path / "artifact"))
        assert meta["model_name"] == "MyModel"
        dockerfile = (tmp_path / "artifact" / "Dockerfile").read_text()
        assert "seldon-tpu-torch-microservice $MODEL_NAME" in dockerfile and "requirements.txt" in dockerfile
        run_sh = (tmp_path / "artifact" / "run.sh").read_text()
        assert "MyModel --api REST" in run_sh and "seldon_core_tpu_torch.runtime.microservice" in run_sh
        assert "LAUNCH=(seldon-tpu-torch-microservice)" in run_sh
        assert json.loads((tmp_path / "artifact" / "artifact.json").read_text())["service_type"] == "MODEL"

    def test_validation_rejects_wrong_surface_and_missing_class(self, tmp_path):
        from seldon_core_tpu_torch.runtime.packager import package

        with pytest.raises(ValueError, match="predict"):
            package(str(self._user_repo(tmp_path, body="class MyModel:\n    pass\n")), str(tmp_path / "a"))
        with pytest.raises(ValueError, match="must define a class"):
            package(str(self._user_repo(tmp_path / "b", body="x = 1\n")), str(tmp_path / "c"))

    def test_run_sh_serves_locally(self, tmp_path):
        from seldon_core_tpu_torch.runtime.packager import package

        out = tmp_path / "artifact"
        package(str(self._user_repo(tmp_path)), str(out))
        port = free_port()
        env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
        proc = subprocess.Popen(["bash", str(out / "run.sh"), "--http-port", str(port), "--host", "127.0.0.1"],
                                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        try:
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                try:
                    with urllib.request.urlopen(f"http://127.0.0.1:{port}/health/ping", timeout=1):
                        break
                except OSError:
                    time.sleep(0.2)
            req = urllib.request.Request(f"http://127.0.0.1:{port}/predict",
                                         data=json.dumps({"data": {"ndarray": [[5.0, 6.0]]}}).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=10) as resp:
                assert json.loads(resp.read())["data"]["ndarray"] == [[5.0, 6.0]]
        finally:
            proc.terminate()
            proc.wait(timeout=10)

    def test_service_types_aligned_with_microservice(self):
        from seldon_core_tpu_torch.runtime.microservice import SERVICE_TYPES
        from seldon_core_tpu_torch.runtime.packager import SERVICE_METHODS

        assert set(SERVICE_METHODS) == set(SERVICE_TYPES)


class TestGraphVisualizer:
    @pytest.mark.parametrize("name", ["mab_abtest.yaml", "combiner_pipeline.yaml", "canary_shadow.yaml",
                                      "remote_graph.yaml"])
    def test_dot_and_ascii_equal_the_jax_packages(self, name):
        from seldon_core_tpu.controlplane.spec import TpuDeployment as JaxTpuDeployment
        from seldon_core_tpu_torch.controlplane.spec import TpuDeployment
        from seldon_core_tpu_torch.utils.graphviz import to_ascii, to_dot

        path = os.path.join(ROOT, "examples", name)
        mine, theirs = TpuDeployment.load(path), JaxTpuDeployment.load(path)
        assert to_dot(mine) == jax_graphviz.to_dot(theirs)
        assert to_ascii(mine) == jax_graphviz.to_ascii(theirs)

    def test_mab_dot_shape(self):
        from seldon_core_tpu_torch.controlplane.spec import TpuDeployment
        from seldon_core_tpu_torch.utils.graphviz import to_dot

        dot = to_dot(TpuDeployment.load(os.path.join(ROOT, "examples", "mab_abtest.yaml")))
        assert dot.startswith('digraph "mab-demo"') and "ROUTER: EPSILON_GREEDY" in dot
        assert 'label="100%"' in dot and dot.count("n0_0 -> n0_0_") == 2

    def test_cli_writes_dot_file(self, tmp_path):
        from seldon_core_tpu_torch.utils.graphviz import main

        out = tmp_path / "graph.dot"
        main([os.path.join(ROOT, "examples", "mab_abtest.yaml"), "--format", "dot", "-o", str(out)])
        assert out.read_text().startswith("digraph")


class TestSeldonTop:
    def test_once_json_over_a_stub_fleet(self, capsys):
        from seldon_core_tpu_torch.tools import seldon_top
        from seldon_core_tpu_torch.utils import telemetry

        point = {"t": 1.0, "queue_depth": 3, "active_slots": 2, "active_slots_total": 4, "goodput_tok_s": 80.0,
                 "prefill_tok_s": 10.0, "prefix_hit_pct": 25.0, "pool_pages_used": 5, "pool_pages_total": 20,
                 "adapters": ["a1"], "cost_page_s_s": 1.0, "health": "healthy"}
        point["saturation"] = telemetry.saturation_score(point)
        snap = {"schema_version": telemetry.TELEMETRY_SCHEMA_VERSION, "replica_id": "r0", "t": 1.0,
                "window_s": 30.0, "capacity": 8, "points": [point], "latest": point}

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                body = json.dumps(snap).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        try:
            url = f"http://127.0.0.1:{srv.server_address[1]}"
            assert seldon_top.main(["--endpoints", f"r0={url}", "--once", "--json"]) in (0, None)
            view = json.loads(capsys.readouterr().out)
            assert view["replicas"]["r0"]["state"] == "ok" and view["rollup"]["fleet_goodput_tok_s"] == 80.0
            assert seldon_top.main(["--endpoints", f"r0={url}", "--once"]) in (0, None)
            text = capsys.readouterr().out
            assert "replicas 1/1 ok" in text and "r0" in text
        finally:
            srv.shutdown()
            srv.server_close()
