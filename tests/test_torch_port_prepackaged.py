"""The port's prepackaged servers and proxies against the JAX package's.

The mirror of ``tests/test_servers.py``'s ``TestSKLearnServer``,
``TestXGBoostServerFallback`` and ``TestMLFlowServerFallback`` and of
``tests/test_openapi_proxy.py``'s proxy classes, on the port's
components: each answer is the JAX server's for the same artifact
(sklearn through ``importorskip``).  Then what the port adds:
``TORCH_SERVER`` loads a TorchScript archive onto the component's device
(the CPU here) and answers as the module does; the TFServing gRPC proxy
speaks through ``proto/tfserving_compat_pb2.py``, a copy whose
descriptor is the JAX package's byte for byte, so both register once in
one process; and every name resolves in the port's graph registry.
"""

import asyncio
import json
import sys
from concurrent import futures

import grpc
import numpy as np
import pytest
import torch

from seldon_core_tpu.models import mlflowserver as jax_mlflow
from seldon_core_tpu.models import xgboostserver as jax_xgb
from seldon_core_tpu.proto import tfserving_compat_pb2 as jax_tfs
from seldon_core_tpu_torch.codec import tftensor as tfc
from seldon_core_tpu_torch.engine import units
from seldon_core_tpu_torch.models.mlflowserver import MLFlowServer
from seldon_core_tpu_torch.models.proxyserver import RestProxyServer, SageMakerProxy, TFServingGrpcProxy
from seldon_core_tpu_torch.models.torchserver import TorchServer
from seldon_core_tpu_torch.models.xgboostserver import XGBoostServer
from seldon_core_tpu_torch.proto import pb
from seldon_core_tpu_torch.proto import tfserving_compat_pb2 as tfs
from seldon_core_tpu_torch.runtime import MicroserviceError, dispatch
from seldon_core_tpu_torch.runtime.message import InternalMessage


def run(coro):
    return asyncio.run(coro)


# ---------------------------------------------------------------------------
# sklearn
# ---------------------------------------------------------------------------

class TestSKLearnServer:
    def test_joblib_model_roundtrip(self, tmp_path):
        pytest.importorskip("sklearn")
        import joblib
        from sklearn.linear_model import LogisticRegression

        from seldon_core_tpu.models.sklearnserver import SKLearnServer as JaxSKLearnServer
        from seldon_core_tpu_torch.models.sklearnserver import SKLearnServer

        rng = np.random.default_rng(0)
        X = rng.normal(size=(64, 4))
        y = (X[:, 0] + X[:, 1] > 0).astype(int)
        clf = LogisticRegression().fit(X, y)
        path = tmp_path / "model.joblib"
        joblib.dump(clf, path)
        server = SKLearnServer(model_uri=str(path))
        server.load()
        probs = np.asarray(server.predict(X[:8], []))
        assert probs.shape == (8, 2)
        np.testing.assert_allclose(probs, clf.predict_proba(X[:8]))
        np.testing.assert_array_equal(probs, JaxSKLearnServer(model_uri=str(path)).predict(X[:8], []))
        assert server.class_names() == ["0", "1"]

    def test_directory_uri_picks_model_file(self, tmp_path):
        pytest.importorskip("sklearn")
        import joblib
        from sklearn.dummy import DummyClassifier

        from seldon_core_tpu_torch.models.sklearnserver import SKLearnServer

        clf = DummyClassifier(strategy="most_frequent").fit([[0.0]], [1])
        joblib.dump(clf, tmp_path / "model.joblib")
        server = SKLearnServer(model_uri=str(tmp_path), method="predict")
        server.load()
        assert np.asarray(server.predict(np.zeros((3, 1)), [])).tolist() == [1, 1, 1]

    def test_registered_where_sklearn_imports(self):
        pytest.importorskip("sklearn")
        from seldon_core_tpu_torch.models.sklearnserver import SKLearnServer

        assert units._lookup_builtin("SKLEARN_SERVER") is SKLearnServer


# ---------------------------------------------------------------------------
# xgboost's JSON booster
# ---------------------------------------------------------------------------

def _booster_spec(objective="reg:squarederror", base_score="0.5"):
    def tree(feat, thr, left_leaf, right_leaf):
        return {"left_children": [1, -1, -1], "right_children": [2, -1, -1], "split_indices": [feat, 0, 0],
                "split_conditions": [thr, left_leaf, right_leaf], "default_left": [1, 0, 0]}

    return {"learner": {"learner_model_param": {"base_score": base_score}, "objective": {"name": objective},
                        "gradient_booster": {"model": {"trees": [tree(0, 0.5, -1.0, 2.0), tree(1, 1.5, 0.5, -0.5)]}}}}


def _write_booster(tmp_path, spec):
    path = tmp_path / "model.json"
    path.write_text(json.dumps(spec))
    return str(path)


class TestXGBoostServerFallback:
    @pytest.mark.parametrize("objective", ["reg:squarederror", "binary:logistic"])
    def test_rows_equal_the_jax_server(self, tmp_path, objective):
        uri = _write_booster(tmp_path, _booster_spec(objective=objective))
        X = np.random.default_rng(1).uniform(-1, 3, size=(32, 2))
        X[::7, 0] = np.nan  # missing values take default_left
        mine, theirs = XGBoostServer(model_uri=uri), jax_xgb.XGBoostServer(model_uri=uri)
        np.testing.assert_array_equal(mine.predict(X, []), theirs.predict(X, []))

    def test_load_and_predict_regression(self, tmp_path):
        server = XGBoostServer(model_uri=_write_booster(tmp_path, _booster_spec()))
        server.load()
        np.testing.assert_allclose(server.predict(np.array([[0.2, 2.0], [0.9, 1.0]]), ["a", "b"]), [-1.0, 3.0])

    def test_missing_values_follow_default_left(self, tmp_path):
        server = XGBoostServer(model_uri=_write_booster(tmp_path, _booster_spec()))
        np.testing.assert_allclose(server.predict(np.array([[np.nan, 1.0]]), []), [0.0])

    def test_binary_logistic_applies_sigmoid(self, tmp_path):
        spec = _booster_spec(objective="binary:logistic", base_score="0.5")
        server = XGBoostServer(model_uri=_write_booster(tmp_path, spec))
        np.testing.assert_allclose(server.predict(np.array([[0.9, 1.0]]), []), [1.0 / (1.0 + np.exp(-2.5))],
                                   rtol=1e-9)

    def test_binary_logistic_rejects_margin_space_base_score(self, tmp_path):
        spec = _booster_spec(objective="binary:logistic", base_score="0.0")
        with pytest.raises(MicroserviceError, match="base_score"):
            XGBoostServer(model_uri=_write_booster(tmp_path, spec)).load()

    def test_directory_uri_and_registration(self, tmp_path):
        (tmp_path / "model.json").write_text(json.dumps(_booster_spec()))
        out = XGBoostServer(model_uri=str(tmp_path)).predict(np.array([[0.9, 1.0]]), [])
        np.testing.assert_allclose(out, [3.0])
        assert units._lookup_builtin("XGBOOST_SERVER") is XGBoostServer

    def test_unsupported_objective_rejected(self, tmp_path):
        spec = _booster_spec(objective="rank:pairwise")
        with pytest.raises(MicroserviceError, match="objective"):
            XGBoostServer(model_uri=_write_booster(tmp_path, spec)).load()

    def test_cyclic_tree_raises_instead_of_wedging(self, tmp_path):
        spec = _booster_spec()
        spec["learner"]["gradient_booster"]["model"]["trees"][0] = {
            "left_children": [1, 0, -1], "right_children": [1, 0, -1], "split_indices": [0, 0, 0],
            "split_conditions": [0.5, 0.5, 1.0], "default_left": [1, 1, 0]}
        server = XGBoostServer(model_uri=_write_booster(tmp_path, spec))
        with pytest.raises(MicroserviceError, match="malformed tree"):
            server.predict(np.array([[0.2, 2.0]]), [])


# ---------------------------------------------------------------------------
# mlflow's MLmodel sklearn flavour
# ---------------------------------------------------------------------------

_FLAVORS = ("artifact_path: model\nflavors:\n  python_function:\n    loader_module: mlflow.sklearn\n"
            "    model_path: model.pkl\n  sklearn:\n    pickled_model: model.pkl\n"
            "    serialization_format: cloudpickle\n")


def _mlmodel_dir(tmp_path, flavor_yaml=_FLAVORS):
    pytest.importorskip("sklearn")
    import joblib
    from sklearn.linear_model import LinearRegression

    model = LinearRegression().fit(np.array([[0.0], [1.0], [2.0], [3.0]]), np.array([1.0, 3.0, 5.0, 7.0]))
    joblib.dump(model, tmp_path / "model.pkl")
    (tmp_path / "MLmodel").write_text(flavor_yaml)
    return model


class TestMLFlowServerFallback:
    @pytest.mark.parametrize("flavors", [_FLAVORS, "flavors:\n  python_function:\n    loader_module: mlflow.sklearn\n"
                                                   "    model_path: model.pkl\n"], ids=["sklearn", "pyfunc"])
    def test_rows_equal_the_model_and_the_jax_server(self, tmp_path, flavors):
        ref = _mlmodel_dir(tmp_path, flavors)
        server = MLFlowServer(model_uri=str(tmp_path))
        server.load()
        X = np.array([[4.0], [5.0], [10.0]])
        np.testing.assert_allclose(server.predict(X, []), ref.predict(X))
        np.testing.assert_array_equal(server.predict(X, []),
                                      jax_mlflow.MLFlowServer(model_uri=str(tmp_path)).predict(X, []))

    def test_registration_without_mlflow(self):
        assert units._lookup_builtin("MLFLOW_SERVER") is MLFlowServer

    def test_unservable_flavor_is_clear_error(self, tmp_path):
        _mlmodel_dir(tmp_path, "flavors:\n  onnx:\n    data: model.onnx\n")
        with pytest.raises(MicroserviceError, match="sklearn flavor"):
            MLFlowServer(model_uri=str(tmp_path)).load()

    @pytest.mark.parametrize("module,hint", [("yaml", "pyyaml"), ("joblib", "joblib")])
    def test_missing_dependency_is_clear_error(self, tmp_path, monkeypatch, module, hint):
        _mlmodel_dir(tmp_path)
        monkeypatch.setitem(sys.modules, module, None)  # makes `import <module>` raise ImportError
        with pytest.raises(MicroserviceError, match=hint) as e:
            MLFlowServer(model_uri=str(tmp_path)).load()
        assert e.value.reason == "MISSING_DEPENDENCY"


# ---------------------------------------------------------------------------
# TorchScript
# ---------------------------------------------------------------------------

class _Affine(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(4, 3)

    def forward(self, x):
        return self.fc(x)


class TestTorchServer:
    def test_torchscript_rows_equal_the_module(self, tmp_path):
        torch.manual_seed(0)
        module = _Affine().eval()
        path = tmp_path / "model.pt"
        torch.jit.save(torch.jit.script(module), str(path))
        server = TorchServer(model_uri=str(path), device="cpu", softmax_outputs=True)
        server.load()
        X = np.random.default_rng(2).normal(size=(5, 4)).astype(np.float32)
        with torch.no_grad():
            want = torch.softmax(module(torch.from_numpy(X)), dim=-1).numpy()
        np.testing.assert_allclose(server.predict(X, []), want, rtol=1e-6, atol=1e-7)
        assert next(server.module.parameters()).device == torch.device("cpu")
        assert units._lookup_builtin("TORCH_SERVER") is TorchServer

    def test_needs_a_model_uri_and_a_card_when_asked(self):
        with pytest.raises(MicroserviceError, match="model_uri"):
            TorchServer(device="cpu").load()
        if not torch.cuda.is_available():
            with pytest.raises(MicroserviceError) as e:
                TorchServer(model_uri="x.pt")
            assert e.value.reason == "NO_CUDA_DEVICE"


# ---------------------------------------------------------------------------
# the REST and SageMaker proxies (tests/test_openapi_proxy.py)
# ---------------------------------------------------------------------------

async def _upstream(route: str, handler):
    from aiohttp import web
    from aiohttp.test_utils import TestServer

    app = web.Application()
    app.router.add_post(route, handler)
    server = TestServer(app)
    await server.start_server()
    return server


class TestRestProxy:
    def test_proxies_to_external_server(self):
        from aiohttp import web

        async def scenario():
            async def upstream(request):
                body = await request.json()
                return web.json_response({"predictions": (np.asarray(body["instances"]) * 3).tolist()})

            server = await _upstream("/v1/models/m:predict", upstream)
            proxy = RestProxyServer(url=f"http://127.0.0.1:{server.port}/v1/models/m:predict", timeout_s=5)
            out = await asyncio.to_thread(proxy.predict, np.array([[1.0, 2.0]]), [])
            await server.close()
            return out

        np.testing.assert_array_equal(run(scenario()), [[3.0, 6.0]])

    def test_upstream_error_maps_to_microservice_error(self):
        proxy = RestProxyServer(url="http://127.0.0.1:1/none", timeout_s=0.2, retries=0)
        with pytest.raises(MicroserviceError) as e:
            proxy.predict(np.ones((1, 2)), [])
        assert e.value.status_code == 502 and e.value.reason == "UPSTREAM_UNREACHABLE"

    def test_upstream_status_maps_to_502(self):
        from aiohttp import web

        async def scenario():
            async def upstream(request):
                return web.Response(status=503, text="overloaded")

            server = await _upstream("/p", upstream)
            proxy = RestProxyServer(url=f"http://127.0.0.1:{server.port}/p", timeout_s=5, retries=1)
            try:
                with pytest.raises(MicroserviceError) as ei:
                    await asyncio.to_thread(proxy.predict, np.ones((1, 2)), [])
                return ei.value
            finally:
                await server.close()

        err = run(scenario())
        assert err.status_code == 502 and err.reason == "UPSTREAM_ERROR" and "503" in err.message

    def test_json_dialect_html_body_maps_to_502(self):
        from aiohttp import web

        async def scenario():
            async def upstream(request):
                return web.Response(text="<html>ok</html>", content_type="text/html")

            server = await _upstream("/p", upstream)
            proxy = RestProxyServer(url=f"http://127.0.0.1:{server.port}/p", timeout_s=5, retries=0)
            try:
                with pytest.raises(MicroserviceError) as ei:
                    await asyncio.to_thread(proxy.predict, np.ones((1, 2)), [])
                return ei.value.status_code
            finally:
                await server.close()

        assert run(scenario()) == 502

    def test_registered(self):
        assert units._lookup_builtin("REST_PROXY") is RestProxyServer


class TestSageMakerProxy:
    def test_csv_invocations_roundtrip(self):
        from aiohttp import web

        seen = {}

        async def scenario():
            async def invocations(request):
                seen["path"] = request.path
                seen["content_type"] = request.headers["Content-Type"]
                rows = [[float(c) for c in line.split(",")] for line in (await request.text()).splitlines()]
                return web.Response(text="\n".join(",".join(str(v * 2) for v in r) for r in rows),
                                    content_type="text/csv")

            server = await _upstream("/endpoints/my-model/invocations", invocations)
            proxy = SageMakerProxy(base_url=f"http://127.0.0.1:{server.port}", endpoint_name="my-model", timeout_s=5)
            out = await asyncio.to_thread(proxy.predict, np.array([[1.5, 2.0], [3.0, 4.5]]), [])
            await server.close()
            return out

        np.testing.assert_allclose(run(scenario()), [[3.0, 4.0], [6.0, 9.0]])
        assert seen == {"path": "/endpoints/my-model/invocations", "content_type": "text/csv"}

    def test_json_dialect(self):
        from aiohttp import web

        async def scenario():
            async def invocations(request):
                return web.json_response((np.asarray(await request.json()) + 1).tolist())

            server = await _upstream("/invoke", invocations)
            proxy = SageMakerProxy(url=f"http://127.0.0.1:{server.port}/invoke", content_type="application/json",
                                   timeout_s=5)
            out = await asyncio.to_thread(proxy.predict, np.array([[1.0, 2.0]]), [])
            await server.close()
            return out

        np.testing.assert_allclose(run(scenario()), [[2.0, 3.0]])

    def test_sagemaker_csv_garbage_maps_to_502(self):
        from aiohttp import web

        async def scenario():
            async def invocations(request):
                return web.Response(text="not,a\nnumber,row", content_type="text/csv")

            server = await _upstream("/invocations", invocations)
            proxy = SageMakerProxy(url=f"http://127.0.0.1:{server.port}/invocations", timeout_s=5, retries=0)
            try:
                with pytest.raises(MicroserviceError) as ei:
                    await asyncio.to_thread(proxy.predict, np.ones((1, 2)), [])
                return ei.value.status_code
            finally:
                await server.close()

        assert run(scenario()) == 502

    def test_config_validation_and_registration(self):
        with pytest.raises(MicroserviceError):
            SageMakerProxy()  # neither url nor base + name
        with pytest.raises(MicroserviceError):
            SageMakerProxy(url="http://x/invocations", content_type="text/plain")
        assert units._lookup_builtin("SAGEMAKER_PROXY") is SageMakerProxy


# ---------------------------------------------------------------------------
# the TFServing gRPC proxy (tests/test_tftensor.py)
# ---------------------------------------------------------------------------

def _stub_tfserving_server(response_fn):
    handler = grpc.method_handlers_generic_handler("tensorflow.serving.PredictionService", {
        "Predict": grpc.unary_unary_rpc_method_handler(
            lambda request, context: response_fn(request), request_deserializer=tfs.PredictRequest.FromString,
            response_serializer=tfs.PredictResponse.SerializeToString)})
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
    server.add_generic_rpc_handlers((handler,))
    port = server.add_insecure_port("127.0.0.1:0")
    server.start()
    return server, port


class TestTFServingGrpcProxy:
    def test_the_descriptor_is_the_jax_packages(self):
        assert tfs.DESCRIPTOR.serialized_pb == jax_tfs.DESCRIPTOR.serialized_pb
        req = tfs.PredictRequest()
        req.model_spec.name = "m"
        assert jax_tfs.PredictRequest.FromString(req.SerializeToString()).model_spec.name == "m"

    def test_tftensor_passthrough_roundtrip(self):
        seen = {}

        def respond(request):
            seen["model"] = request.model_spec.name
            seen["signature"] = request.model_spec.signature_name
            resp = tfs.PredictResponse()
            tfc.array_to_tftensor(tfc.tftensor_to_array(request.inputs["images"]).sum(axis=1),
                                  out=resp.outputs["scores"])
            return resp

        server, port = _stub_tfserving_server(respond)
        try:
            proxy = TFServingGrpcProxy(grpc_endpoint=f"127.0.0.1:{port}", model_name="resnet", model_input="images",
                                       model_output="scores")
            msg = pb.SeldonMessage()
            tfc.array_to_tftensor(np.arange(6, dtype=np.float32).reshape(2, 3), out=msg.data.tftensor)
            reply = proxy.predict_raw(msg)
            assert seen == {"model": "resnet", "signature": "serving_default"}
            assert reply.data.WhichOneof("data_oneof") == "tftensor"
            np.testing.assert_array_equal(tfc.tftensor_to_array(reply.data.tftensor), np.array([3.0, 12.0]))
        finally:
            server.stop(None)

    def test_in_a_graph_over_dispatch(self):
        def respond(request):
            resp = tfs.PredictResponse()
            tfc.array_to_tftensor(tfc.tftensor_to_array(request.inputs["inputs"]) + 1, out=resp.outputs["out"])
            return resp

        server, port = _stub_tfserving_server(respond)
        try:
            proxy = units.make_builtin("TENSORFLOW_SERVER", grpc_endpoint=f"127.0.0.1:{port}", model_name="m")
            msg = pb.SeldonMessage()
            tfc.array_to_tftensor(np.zeros((1, 2), np.float32), out=msg.data.tftensor)
            out = dispatch.predict(proxy, InternalMessage.from_proto(msg))
            np.testing.assert_array_equal(out.host_payload(), np.ones((1, 2), np.float32))
        finally:
            server.stop(None)

    def test_upstream_error_surfaces_502(self):
        proxy = TFServingGrpcProxy(grpc_endpoint="127.0.0.1:1", model_name="m", timeout_s=0.2)
        msg = pb.SeldonMessage()
        tfc.array_to_tftensor(np.ones(2, np.float32), out=msg.data.tftensor)
        with pytest.raises(MicroserviceError) as err:
            proxy.predict_raw(msg)
        assert err.value.status_code == 502
