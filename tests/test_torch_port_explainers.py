"""The port's explainers and explanation surface against the JAX package's.

* ``IntegratedGradientsExplainer`` over a ``CudaServer`` ``mlp`` loaded
  with the JAX server's variables: attributions, targets and scores equal
  the JAX explainer's over ``JaxServer`` to 1e-5 in float32 (one batched
  backward against ``jax.grad`` + ``vmap``), and they sum to f(x) - f(b).
* ``PermutationExplainer``, ``KernelShapExplainer`` and
  ``AnchorsExplainer`` over one numpy model: the same seed gives the JAX
  explainers' answers (the same host code over the same outputs).
* ``build_explainer`` names the four types, as in JAX.
* ``PredictorService(explainer=...).explain`` and the gateway's
  ``POST /api/v0.1/explanations``: the route answers what the service
  does, adopts the deadline (a spent one is 504) and, without an
  explainer, answers JAX's 404 ``NO_EXPLAINER``.
"""

import asyncio

import numpy as np
import pytest

from seldon_core_tpu.components import explainers as jax_explainers
from seldon_core_tpu.models.jaxserver import JaxServer
from seldon_core_tpu_torch.components import explainers
from seldon_core_tpu_torch.engine.graph import UnitSpec
from seldon_core_tpu_torch.engine.server import Gateway, build_gateway_app
from seldon_core_tpu_torch.engine.service import PredictorService
from seldon_core_tpu_torch.models.cudaserver import CudaServer
from seldon_core_tpu_torch.runtime import MicroserviceError
from seldon_core_tpu_torch.runtime.message import InternalMessage


@pytest.fixture(scope="module")
def servers():
    jax_server = JaxServer(model="mlp", num_classes=3, input_shape=(4,), dtype="float32", max_batch_size=4,
                           warmup=False, warmup_dtypes=("float32",))
    jax_server.load()
    variables = {k: v for k, v in jax_server.variables.items()}
    import jax

    port = CudaServer(model="mlp", num_classes=3, input_shape=(4,), dtype="float32", max_batch_size=4,
                      warmup=False, device="cpu", variables=jax.tree_util.tree_map(np.asarray, variables))
    port.load()
    yield jax_server, port
    jax_server.unload()
    port.unload()


def _x(n=3, seed=0):
    return np.random.default_rng(seed).normal(size=(n, 4)).astype(np.float32)


class TestIntegratedGradients:
    @pytest.mark.parametrize("baseline", ["zeros", "mean"])
    def test_equals_the_jax_explainer(self, servers, baseline):
        jax_server, port = servers
        X = _x()
        want = jax_explainers.IntegratedGradientsExplainer(model=jax_server, steps=16, baseline=baseline).explain(
            X, names=["a", "b", "c", "d"])
        got = explainers.IntegratedGradientsExplainer(model=port, steps=16, baseline=baseline).explain(
            X, names=["a", "b", "c", "d"])
        assert got["method"] == want["method"] == "integrated_gradients"
        assert got["targets"] == want["targets"] and got["names"] == want["names"]
        np.testing.assert_allclose(got["attributions"], want["attributions"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-5, atol=1e-6)

    def test_completeness_axiom(self, servers):
        _, port = servers
        x = np.array([[0.5, -1.0, 2.0, 0.1]], np.float32)
        out = explainers.IntegratedGradientsExplainer(model=port, steps=256).explain(x)
        logits_x = np.asarray(port.predict(x, []))[0]
        logits_b = np.asarray(port.predict(np.zeros((1, 4), np.float32), []))[0]
        t = out["targets"][0]
        assert np.sum(out["attributions"]) == pytest.approx(float(logits_x[t] - logits_b[t]), rel=0.05)

    def test_a_single_row_and_predict(self, servers):
        _, port = servers
        e = explainers.IntegratedGradientsExplainer(model=port, steps=8)
        assert np.asarray(e.explain(_x(1)[0])["attributions"]).shape == (1, 4)
        assert e.predict(_x(2), []).shape == (2, 4)

    def test_needs_a_model(self):
        with pytest.raises(MicroserviceError) as e:
            explainers.IntegratedGradientsExplainer().load()
        assert e.value.reason == "NO_MODEL"


class _Linear:
    def __init__(self, weights, intercept=0.0):
        self.weights = np.asarray(weights, np.float64)
        self.intercept = intercept
        self.calls = 0

    def predict(self, X, names, meta=None):
        self.calls += 1
        return np.asarray(X) @ self.weights + self.intercept


class _Stump:
    """Class 1 when every named feature exceeds its threshold."""

    def __init__(self, thresholds):
        self.thresholds = thresholds
        self.calls = 0

    def predict(self, X, names, meta=None):
        self.calls += 1
        X = np.atleast_2d(np.asarray(X))
        hit = np.ones(len(X), bool)
        for j, t in self.thresholds.items():
            hit &= X[:, j] > t
        return np.stack([~hit, hit], axis=1).astype(np.float64)


def _both(name, **kw):
    return getattr(explainers, name)(**kw), getattr(jax_explainers, name)(**kw)


class TestBlackBox:
    def test_permutation_equals_jax(self):
        mine, theirs = _both("PermutationExplainer", model=_Linear([[0.0], [10.0], [1.0]]), n_repeats=3, seed=4)
        X = np.random.default_rng(0).normal(size=(32, 3))
        a, b = mine.explain(X, names=["a", "b", "c"]), theirs.explain(X, names=["a", "b", "c"])
        assert a == b and int(np.argmax(a["importances"])) == 1

    @pytest.mark.parametrize("m,n_samples,seed", [(4, 64, 0), (12, 256, 1)], ids=["exact", "sampled"])
    def test_kernel_shap_equals_jax(self, m, n_samples, seed):
        rng = np.random.default_rng(seed)
        w = rng.normal(size=(m, 2))
        mine, theirs = _both("KernelShapExplainer", model=_Linear(w, 0.3), n_samples=n_samples, seed=seed)
        X = rng.normal(size=(2, m))
        a, b = mine.explain(X), theirs.explain(X)
        assert a == b
        np.testing.assert_allclose(np.sum(a["attributions"], axis=1),
                                   [(X[i] @ w)[a["targets"][i]] for i in range(2)], atol=1e-6)

    def test_kernel_shap_one_batched_predict_per_row(self):
        model = _Linear(np.ones(4))
        explainers.KernelShapExplainer(model=model).explain(np.ones((3, 4)))
        assert model.calls == 3

    @pytest.mark.parametrize("thresholds,x", [({0: 0.5}, [0.9, 0.2, 0.4, 0.6]),
                                              ({0: 0.5, 2: 0.5}, [0.9, 0.1, 0.8, 0.3])])
    def test_anchors_equal_jax(self, thresholds, x):
        bg = np.random.default_rng(3).uniform(0.0, 1.0, size=(512, 4))
        mine, theirs = _both("AnchorsExplainer", model=_Stump(thresholds), background=bg, n_bins=4, seed=0)
        a, b = mine.explain(np.array([x])), theirs.explain(np.array([x]))
        assert a == b
        assert sorted(a["anchors"][0]["features"]) == sorted(thresholds) and a["anchors"][0]["met_threshold"]
        np.testing.assert_array_equal(mine.predict(np.array([x]), []), theirs.predict(np.array([x]), []))

    def test_build_explainer_names_the_jax_types(self):
        assert set(explainers.EXPLAINER_TYPES) == set(jax_explainers.EXPLAINER_TYPES)
        assert isinstance(explainers.build_explainer({"type": "permutation", "n_repeats": 2}),
                          explainers.PermutationExplainer)
        with pytest.raises(MicroserviceError) as e:
            explainers.build_explainer({"type": "lime"})
        assert e.value.reason == "UNKNOWN_EXPLAINER"


class _Model:
    def predict(self, X, names, meta=None):
        return np.asarray(X) @ np.array([[1.0, -1.0], [2.0, 0.5], [0.0, 1.0]])


class TestExplanationSurface:
    def _service(self, explainer=True):
        model = _Model()
        e = explainers.KernelShapExplainer(model=model, n_samples=64) if explainer else None
        return PredictorService(UnitSpec(name="m", type="MODEL", component=model), name="main", explainer=e)

    def test_service_explain(self):
        svc = self._service()
        msg = InternalMessage.from_json({"data": {"ndarray": [[1.0, 2.0, 3.0]]}})
        out = asyncio.run(svc.explain(msg))
        assert out.status["code"] == 200 and out.payload["method"] == "kernel_shap"
        assert out.payload == svc.explainer.explain(np.array([[1.0, 2.0, 3.0]]))
        missing = asyncio.run(self._service(explainer=False).explain(msg))
        assert missing.status["code"] == 404 and missing.status["reason"] == "NO_EXPLAINER"

    def test_the_gateway_route(self):
        from aiohttp.test_utils import TestClient, TestServer

        body = {"data": {"ndarray": [[1.0, 2.0, 3.0]]}}

        async def go():
            results = []
            for svc in (self._service(), self._service(explainer=False)):
                client = TestClient(TestServer(build_gateway_app(Gateway([(svc, 1.0)]))))
                await client.start_server()
                try:
                    resp = await client.post("/api/v0.1/explanations", json=body)
                    results.append((resp.status, await resp.json()))
                    resp = await client.post("/api/v0.1/explanations", json=body,
                                             headers={"X-Seldon-Deadline-Ms": "0"})
                    results.append((resp.status, await resp.json()))
                finally:
                    await client.close()
            return results

        (ok, body_ok), (late, body_late), (missing, body_missing), _ = asyncio.run(go())
        assert ok == 200 and body_ok["jsonData"]["method"] == "kernel_shap"
        want = explainers.KernelShapExplainer(model=_Model(), n_samples=64).explain(np.array([[1.0, 2.0, 3.0]]))
        np.testing.assert_allclose(body_ok["jsonData"]["attributions"], want["attributions"])
        assert late == 504 and body_late["status"]["reason"] == "DEADLINE_EXCEEDED"
        assert missing == 404 and body_missing["status"]["reason"] == "NO_EXPLAINER"
