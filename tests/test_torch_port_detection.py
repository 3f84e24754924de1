"""The port's MLP and detection families against the JAX package's.

The same numpy-drawn flax variables (converted by ``models/convert.py``)
and the same inputs go through the JAX ``MLPClassifier``, ``Detector`` /
``make_detector`` and ``decode_detections`` and the port's, directly and
through ``CudaServer(device="cpu")`` beside ``JaxServer``.

Tolerances: the MLP's float32 logits within 1e-6; the detector's float32
head maps within 1e-5 (summation order differs between XLA and PyTorch
on the CPU); the bilinear x2 within 1e-6 in float32, one step of the
format in bfloat16.  ``decode_detections`` picks the same cells in the
same order, ties included: the boxes and classes are exactly equal and
the scores within one ulp, because XLA's and PyTorch's float32 sigmoids
differ in the last bit on some inputs.
"""

import asyncio
import base64
import inspect
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.models import detection as jax_detection
from seldon_core_tpu.models import resnet as jax_resnet
from seldon_core_tpu.models.jaxserver import JaxServer
from seldon_core_tpu.models.mlp import MLPClassifier as FlaxMLP
from seldon_core_tpu.runtime import rest as jax_rest
from seldon_core_tpu_torch.models import detection, resnet
from seldon_core_tpu_torch.models.convert import (detector_params_from_flax, mlp_params_from_flax,
                                                  resnet_params_from_flax)
from seldon_core_tpu_torch.models.cudaserver import CudaServer, _model_registry
from seldon_core_tpu_torch.models.mlp import MLPClassifier
from seldon_core_tpu_torch.runtime import rest

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_resnet import random_variables  # noqa: E402

SIZE = 64
TINY = dict(num_filters=8, head_dim=16, top_k=10)


def _maps(seed, b=2, h=8, w=8, c=5):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, w, c)).astype(np.float32) * 3,
            rng.normal(size=(b, h, w, 2)).astype(np.float32) * 4,
            rng.uniform(0, 1, size=(b, h, w, 2)).astype(np.float32))


def _decode_both(heat, size, offset, **kw):
    want = np.asarray(jax_detection.decode_detections(jnp.asarray(heat), jnp.asarray(size), jnp.asarray(offset),
                                                      **kw))
    got = detection.decode_detections(torch.from_numpy(heat), torch.from_numpy(size), torch.from_numpy(offset),
                                      **kw).numpy()
    return got, want


def _assert_same_rows(got, want):
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[..., [0, 1, 2, 3, 5]], want[..., [0, 1, 2, 3, 5]])
    np.testing.assert_array_max_ulp(got[..., 4], want[..., 4], maxulp=1)


class TestMLP:
    @pytest.mark.parametrize("hidden", [(64, 64), (16,), ()])
    def test_logits_match_jax(self, hidden):
        fmod = FlaxMLP(hidden_sizes=hidden, num_classes=3, dtype=jnp.float32)
        variables = random_variables(fmod, (4,), seed=2)
        x = np.random.default_rng(3).normal(size=(5, 4)).astype(np.float32)
        want = np.asarray(fmod.apply(variables, jnp.asarray(x)))
        tmod = MLPClassifier(hidden_sizes=hidden, num_classes=3)
        tmod.load_state_dict(mlp_params_from_flax(variables))
        assert [n for n, _ in tmod.named_children()] == [f"dense_{i}" for i in range(len(hidden))] + ["head"]
        with torch.no_grad():
            got = tmod(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)

    def test_converter_refuses_extra_leaves(self):
        variables = random_variables(FlaxMLP(), (4,), seed=2)
        bad = {"params": {**variables["params"], "extra": {"kernel": np.zeros((2, 2), np.float32)}}}
        with pytest.raises(ValueError, match="extra"):
            mlp_params_from_flax(bad)


class TestDecode:
    @pytest.mark.parametrize("seed,top_k,threshold", [(0, 10, 0.0), (1, 25, 0.3), (2, 64, 0.0)])
    def test_random_maps_match_jax(self, seed, top_k, threshold):
        got, want = _decode_both(*_maps(seed), top_k=top_k, stride=16, score_threshold=threshold)
        _assert_same_rows(got, want)

    @pytest.mark.parametrize("top_k", [20, 100])
    def test_suppressed_zeros_tie_order_matches_jax(self, top_k):
        # image 0: a ramp in each channel, so every cell but the corner
        # is suppressed to zero; image 1: a flat plateau (every cell an
        # equal peak) around two sharp peaks; top_k far above image 0's
        # three peaks, so rows are picked among equal values
        h, w, c = 6, 7, 3
        heat = np.full((2, h, w, c), -20.0, np.float32)
        ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        heat[0] = (0.1 * (xs + ys))[..., None] + 0.01 * np.arange(c)
        heat[1, 2, 3, 1] = 4.0
        heat[1, 2, 4, 1] = 3.0
        heat[1, 5, 0, 0] = 1.0
        _, size, offset = _maps(9, b=2, h=h, w=w)
        got, want = _decode_both(heat, size, offset, top_k=top_k, stride=8)
        _assert_same_rows(got, want)
        assert got.shape == (2, min(top_k, h * w * c), 6)
        assert (got[0, :, 4] == 0).sum() == got.shape[1] - c  # image 0's zeros were chosen, boxes kept
        assert np.any(got[0, c:, :4] != 0)

    def test_single_peak_recovers_box(self):
        heat = np.full((1, 8, 8, 3), -10.0, np.float32)
        size = np.zeros((1, 8, 8, 2), np.float32)
        offset = np.zeros((1, 8, 8, 2), np.float32)
        heat[0, 3, 5, 2] = 10.0
        size[0, 3, 5] = [4.0, 6.0]
        offset[0, 3, 5] = [0.25, 0.5]
        got, want = _decode_both(heat, size, offset, top_k=5, stride=16, score_threshold=0.5)
        _assert_same_rows(got, want)
        cx, cy = (5 + 0.25) * 16, (3 + 0.5) * 16
        np.testing.assert_array_equal(got[0, 0, [0, 1, 2, 3, 5]], [cx - 32, cy - 48, cx + 32, cy + 48, 2])
        assert np.all(got[0, 1:] == 0)


class TestNeck:
    @pytest.mark.parametrize("hw", [(5, 7), (4, 4), (1, 3)])
    def test_bilinear_x2_matches_jax_resize(self, hw):
        h, w = hw
        x = np.random.default_rng(h * 10 + w).normal(size=(2, h, w, 6)).astype(np.float32)
        want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 2 * h, 2 * w, 6), method="bilinear"))
        got = detection.upsample2x(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)  # every border row and column included

    def test_bilinear_x2_bf16_within_one_step(self):
        # JAX resizes one axis after the other and rounds between the two
        # passes; PyTorch rounds once.  Both outputs are convex
        # combinations of the inputs, so they differ by at most one bf16
        # step at the inputs' largest magnitude.
        x = np.random.default_rng(4).normal(size=(2, 5, 7, 6)).astype(np.float32)
        want = np.asarray(jax.image.resize(jnp.asarray(x, jnp.bfloat16), (2, 10, 14, 6),
                                           method="bilinear").astype(jnp.float32))
        got = detection.upsample2x(torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2))
        got = got.permute(0, 2, 3, 1).float().numpy()
        step = 2.0 ** (np.floor(np.log2(np.abs(x).max())) - 7)
        np.testing.assert_allclose(got, want, rtol=0, atol=step)


def _jax_detector(backbone, num_filters, seed):
    served, shape = jax_detection.make_detector(5, jnp.float32, backbone=backbone, num_filters=num_filters,
                                                head_dim=16, top_k=10, input_size=SIZE)
    return served, random_variables(served, shape, seed)


class TestDetector:
    @pytest.mark.parametrize("backbone,num_filters", [("resnet_tiny", 8), ("resnet50", 4)])
    def test_head_maps_and_boxes_match_jax(self, backbone, num_filters):
        served, variables = _jax_detector(backbone, num_filters, seed=6)
        x = np.random.default_rng(7).normal(size=(2, SIZE, SIZE, 3)).astype(np.float32)
        inner = {"params": variables["params"]["detector"], "batch_stats": variables["batch_stats"]["detector"]}
        jdet = jax_detection.Detector(num_classes=5, backbone=backbone, num_filters=num_filters, head_dim=16,
                                      dtype=jnp.float32)
        want = [np.asarray(m) for m in jdet.apply(inner, jnp.asarray(x))]
        module, shape = detection.make_detector(5, torch.float32, backbone=backbone, num_filters=num_filters,
                                                head_dim=16, top_k=10, input_size=SIZE)
        assert shape == (SIZE, SIZE, 3)
        module.load_state_dict(detector_params_from_flax(variables))
        with torch.no_grad():
            got = [m.numpy() for m in module.detector(torch.from_numpy(x))]
            boxes = module(torch.from_numpy(x)).numpy()
        assert [g.shape for g in got] == [(2, SIZE // 16, SIZE // 16, 5), (2, SIZE // 16, SIZE // 16, 2),
                                           (2, SIZE // 16, SIZE // 16, 2)]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
        assert boxes.shape == (2, 10, 6) and np.isfinite(boxes).all()
        np.testing.assert_allclose(boxes, np.asarray(served.apply(variables, jnp.asarray(x))), rtol=1e-5,
                                   atol=1e-4)

    def test_classifier_tree_seeds_the_backbone(self):
        classifier = jax_resnet.ResNetTiny(num_classes=1000, dtype=jnp.float32)
        cvars = random_variables(classifier, (SIZE, SIZE, 3), seed=1)
        module, _ = detection.make_detector(5, torch.float32, backbone="resnet_tiny", head_dim=16)
        assert set(module.detector.backbone.state_dict()) == set(resnet.ResNetTiny().state_dict())
        module.detector.backbone.load_state_dict(resnet_params_from_flax(cvars))
        x = np.random.default_rng(0).normal(size=(1, SIZE, SIZE, 3)).astype(np.float32)
        want_logits, want = classifier.apply(cvars, jnp.asarray(x), capture_features=True)
        with torch.no_grad():
            logits, got = module.detector.backbone(torch.from_numpy(x), capture_features=True)
            heat = module.detector(torch.from_numpy(x))[0]
        assert got.shape == want.shape == (1, SIZE // 32, SIZE // 32, 64)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
        np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), rtol=0, atol=1e-4)
        assert torch.isfinite(heat).all()

    def test_converter_refuses_a_missing_head(self):
        _, variables = _jax_detector("resnet_tiny", 8, seed=6)
        bad = {"params": {"detector": {"backbone": variables["params"]["detector"]["backbone"]}},
               "batch_stats": variables["batch_stats"]}
        with pytest.raises(ValueError, match="det_head"):
            detector_params_from_flax(bad)


def _raw_body(x):
    return {"data": {"rawTensor": {"dtype": str(x.dtype), "shape": list(x.shape),
                                   "data": base64.b64encode(np.ascontiguousarray(x).tobytes()).decode()}}}


def _decode(body):
    raw = body["data"]["rawTensor"]
    return np.frombuffer(base64.b64decode(raw["data"]), raw["dtype"]).reshape(raw["shape"])


def _post_both(js, cs, body):
    async def scenario():
        from aiohttp.test_utils import TestClient, TestServer

        out = []
        for app in (jax_rest.build_app(js), rest.build_app(cs)):
            client = TestClient(TestServer(app))
            await client.start_server()
            try:
                resp = await client.post("/predict", json=body)
                out.append((resp.status, await resp.json()))
            finally:
                await client.close()
        return out

    return asyncio.run(scenario())


class TestServing:
    def test_detector_tiny_serves_as_jaxserver(self):
        common = dict(model="detector_tiny", num_classes=5, dtype="float32", normalize=True, max_batch_size=4,
                      warmup=False, model_kwargs=TINY)
        js = JaxServer(**common)
        js.load()
        _, variables = _jax_detector("resnet_tiny", 8, seed=12)
        js.variables = jax.device_put(variables)
        cs = CudaServer(device="cpu", variables=variables, **common)
        cs.load()
        assert cs.input_shape == js.input_shape == (SIZE, SIZE, 3)
        images = np.random.default_rng(13).integers(0, 256, size=(3, SIZE, SIZE, 3), dtype=np.uint8)
        got, want = np.asarray(cs.predict(images, [])), np.asarray(js.predict(images, []))
        assert got.shape == want.shape == (3, 10, 6)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
        (js_status, js_body), (status, body) = _post_both(js, cs, _raw_body(images))
        assert js_status == status == 200
        assert body["data"]["names"] == js_body["data"]["names"]
        assert body["data"]["rawTensor"]["shape"] == js_body["data"]["rawTensor"]["shape"] == [3, 10, 6]
        np.testing.assert_allclose(_decode(body), _decode(js_body), rtol=1e-5, atol=1e-3)
        # the CPU: the plain version counts no launch since load (the counts are the process's)
        health = cs.health_status()
        assert (health["kernel_launches"].get("fused_normalize", 0)
                == health["kernel_launches_at_ready"].get("fused_normalize", 0))
        cs.unload()
        js.unload()

    def test_mlp_serves_as_jaxserver(self):
        common = dict(model="mlp", num_classes=3, dtype="float32", max_batch_size=4, warmup=False)
        js = JaxServer(**common)
        js.load()
        variables = random_variables(FlaxMLP(num_classes=3), (4,), seed=14)
        js.variables = jax.device_put(variables)
        cs = CudaServer(device="cpu", variables=variables, **common)
        cs.load()
        x = np.random.default_rng(15).normal(size=(4, 4)).astype(np.float32)
        np.testing.assert_allclose(np.asarray(cs.predict(x, [])), np.asarray(js.predict(x, [])), rtol=0, atol=1e-6)
        (js_status, js_body), (status, body) = _post_both(js, cs, {"data": {"ndarray": x.tolist()}})
        assert js_status == status == 200
        assert body["data"]["names"] == js_body["data"]["names"] == ["t:0", "t:1", "t:2"]
        np.testing.assert_allclose(np.asarray(body["data"]["ndarray"]), np.asarray(js_body["data"]["ndarray"]),
                                   rtol=0, atol=1e-6)
        cs.unload()
        js.unload()

    def test_default_model_matches_jaxserver(self):
        assert inspect.signature(CudaServer).parameters["model"].default == "mlp"
        assert CudaServer(device="cpu").model_name == JaxServer().model_name == "mlp"
        cs = CudaServer(device="cpu", warmup=False)
        cs.load()
        assert cs.input_shape == (4,)
        assert np.asarray(cs.predict(np.zeros((2, 4), np.float32), [])).shape == (2, 1000)
        cs.unload()

    def test_w8a8_detector_refused_as_jaxserver_refuses(self):
        from seldon_core_tpu.runtime.component import MicroserviceError as JaxMicroserviceError
        from seldon_core_tpu_torch.runtime.component import MicroserviceError

        common = dict(model="detector_tiny", num_classes=5, dtype="float32", precision="w8a8", warmup=False,
                      model_kwargs=TINY)
        with pytest.raises(JaxMicroserviceError) as jerr:
            JaxServer(**common).load()
        with pytest.raises(MicroserviceError) as err:
            CudaServer(device="cpu", **common).load()
        assert err.value.reason == jerr.value.reason == "BAD_PRECISION"

    def test_registry_has_every_jaxserver_model(self):
        from seldon_core_tpu.models.jaxserver import _model_registry as jax_registry

        assert set(_model_registry()) == set(jax_registry())
        assert _model_registry()["detector_resnet50"].input_shape({}) == (512, 512, 3)
        assert _model_registry()["detector_resnet50"].input_shape({"input_size": 256}) == (256, 256, 3)
