"""The serving precision lanes of the port's ``CudaServer`` against ``JaxServer``.

A CPU ``CudaServer`` and a ``JaxServer`` serve ResNetTiny in float32
from the same numpy-drawn flax variables (handed to ``JaxServer`` in
place of its random init), with ``normalize=true`` and uint8 images.

* ``int8w``: both dequantise the same int8 kernels to float32 per
  forward, so the logits agree within 1e-4 relative L2 (summation order).
* ``w8a8``: each calibrates its own activation scales from the same
  seeded batches; a float difference in the last bit can round one
  element of a dynamically scaled grid the other way during calibration
  (``tests/test_torch_port_w8a8.py``), so the logits are held within 1e-2
  relative L2, with the argmax equal on at least 90% of the rows.

Then the counterparts of ``tests/test_int8.py::TestQuantizedJaxServer``
and ``tests/test_w8a8.py::TestServingKnob`` (their ``mlp`` cases on
resnet_tiny / vit_tiny: ``mlp`` is not ported), the status, and the
errors by status and reason.
"""

import jax
import numpy as np
import pytest

from seldon_core_tpu.models.jaxserver import JaxServer
from seldon_core_tpu.models.resnet import ResNetTiny as FlaxResNetTiny
from seldon_core_tpu.runtime import MicroserviceError as JaxMicroserviceError
from seldon_core_tpu_torch.models.cudaserver import CudaServer
from seldon_core_tpu_torch.ops import kernels
from seldon_core_tpu_torch.runtime import MicroserviceError

from test_torch_port_resnet import random_variables
from test_torch_port_w8a8 import w8a8_names

NUM_CLASSES = 10
SHAPE = (32, 32, 3)
COMMON = dict(model="resnet_tiny", num_classes=NUM_CLASSES, dtype="float32", normalize=True, max_batch_size=4,
              warmup=False, seed=3)


def _images(n, seed):
    return np.random.default_rng(seed).integers(0, 256, size=(n, *SHAPE)).astype(np.uint8)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def variables():
    return random_variables(FlaxResNetTiny(num_classes=NUM_CLASSES), SHAPE, seed=31)


def _pair(variables, **kw):
    js = JaxServer(**COMMON, **kw)
    jax_vars = w8a8_names(variables) if kw.get("precision") == "w8a8" else variables
    js._init_or_load_params = lambda: jax.tree_util.tree_map(np.asarray, jax_vars)
    js.load()
    cs = CudaServer(device="cpu", variables=jax_vars, **COMMON, **kw)
    cs.load()
    return js, cs


def test_int8w_matches_jaxserver(variables):
    js, cs = _pair(variables, precision="int8w")
    try:
        assert cs.quantize == js.quantize == "int8"
        assert [(r["path"], tuple(r["shape"]), r["bytes_fp"], r["bytes_q"]) for r in cs.quantize_manifest] == [
            (r["path"], tuple(r["shape"]), r["bytes_fp"], r["bytes_q"]) for r in js.quantize_manifest]
        x = _images(6, seed=1)
        want = np.asarray(js.predict(x, names=[]))
        got = np.asarray(cs.predict(x, names=[]))
        assert got.shape == want.shape == (6, NUM_CLASSES)
        assert _rel_l2(got, want) <= 1e-4
        assert cs.act_scales_calibrated == js.act_scales_calibrated == 0
    finally:
        js.unload()
        cs.unload()


def test_w8a8_matches_jaxserver(variables):
    js, cs = _pair(variables, precision="w8a8")
    try:
        assert cs.act_scales_calibrated == js.act_scales_calibrated == 11
        assert sorted(r["path"] for r in cs.quantize_manifest) == sorted(r["path"] for r in js.quantize_manifest)
        before = kernels.launch_counts()["w8a8_int_mm"]
        cs.predict(_images(4, seed=3), names=[])
        assert kernels.launch_counts()["w8a8_int_mm"] - before == 11  # one integer GEMM per w8a8 conv
        x = _images(12, seed=2)
        want = np.asarray(js.predict(x, names=[]))
        got = np.asarray(cs.predict(x, names=[]))
        assert np.isfinite(got).all() and got.shape == want.shape
        assert _rel_l2(got, want) <= 1e-2
        assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.9
    finally:
        js.unload()
        cs.unload()


# ---------------------------------------------------------------------------
# the JAX package's serving tests, on the port
# ---------------------------------------------------------------------------

def _server(**kw):
    return CudaServer(device="cpu", **{**COMMON, "normalize": False, **kw})


def test_int8_accuracy_parity_with_fp():
    fp, q = _server(), _server(quantize="int8")
    fp.load()
    q.load()
    try:
        assert q.quantize_manifest, "surgery found no kernels to quantise"
        x = _images(16, seed=4).astype(np.float32) / 255.0
        y_fp = np.asarray(fp.predict(x, names=[]))
        y_q = np.asarray(q.predict(x, names=[]))
        np.testing.assert_allclose(y_q, y_fp, rtol=0.1, atol=0.05)
        assert (y_fp.argmax(-1) == y_q.argmax(-1)).mean() >= 0.9
    finally:
        fp.unload()
        q.unload()


def test_int8_shrinks_params_and_rests_int8():
    fp, q = _server(), _server(quantize="int8")
    fp.load()
    q.load()
    try:
        saved = sum(r["bytes_fp"] - r["bytes_q"] for r in q.quantize_manifest)
        assert saved > 0 and q.param_bytes == fp.param_bytes - saved
        for row in q.quantize_manifest:  # no float copy left in the module
            assert q.module.get_parameter(row["key"]).numel() == 0
            assert q._qparams[row["key"]].q.dtype.itemsize == 1
    finally:
        fp.unload()
        q.unload()


def test_resnet_tiny_int8_e2e_uint8():
    s = _server(quantize="int8", normalize=True, max_batch_size=4)
    s.load()
    try:
        y = np.asarray(s.predict(_images(2, seed=5), names=[]))
        assert y.shape == (2, NUM_CLASSES) and np.isfinite(y).all()
    finally:
        s.unload()


def test_w8a8_through_predict_tracks_fp():
    fp, q = _server(), _server(precision="w8a8")
    fp.load()
    q.load()
    try:
        assert q.quantize == "int8" and q.quantize_manifest and q.act_scales_calibrated > 0
        x = _images(6, seed=6).astype(np.float32)
        y_fp = np.asarray(fp.predict(x, names=[]))
        y_q = np.asarray(q.predict(x, names=[]))
        assert y_q.shape == y_fp.shape == (6, NUM_CLASSES) and np.isfinite(y_q).all()
        assert (y_fp.argmax(-1) == y_q.argmax(-1)).mean() >= 0.8
    finally:
        fp.unload()
        q.unload()


def test_int8w_is_weight_only_and_warms_every_bucket():
    s = _server(precision="int8w", warmup=True)
    s.load()
    try:
        assert s.quantize == "int8" and s.quantize_manifest and s.act_scales_calibrated == 0
        health = s.health_status()
        assert (health["precision"], health["quantize"], health["act_scales_calibrated"]) == ("int8w", "int8", 0)
        assert health["quantized_kernels"] == len(s.quantize_manifest) and health["param_bytes"] == s.param_bytes
    finally:
        s.unload()


def test_health_of_the_default_lane():
    s = _server()
    s.load()
    try:
        health = s.health_status()
        assert (health["precision"], health["quantize"], health["quantized_kernels"]) == ("bf16", "", 0)
    finally:
        s.unload()


def test_health_reports_each_calibrated_act_scale():
    """/health/status carries every w8a8 layer's calibrated scale by module
    name (the same numbers as the layers' buffers), and none for int8w."""
    q, w = _server(precision="w8a8"), _server(precision="int8w")
    q.load()
    w.load()
    try:
        scales = q.health_status()["act_scales"]
        layers = {name: float(m.act_scale) for name, m in q.module.named_modules() if hasattr(m, "act_scale")}
        assert len(scales) == q.act_scales_calibrated == 11
        assert scales == layers and all(v > 0 for v in scales.values())
        assert w.health_status()["act_scales"] == {}
    finally:
        q.unload()
        w.unload()


def test_w8a8_calibrates_with_the_cudnn_autotuner_off(monkeypatch):
    """The calibration runs with cuDNN's autotuner off and its
    deterministic algorithms on, so two processes fix the same scales;
    the serving settings come back after it."""
    import torch

    from seldon_core_tpu_torch.ops import w8a8

    seen = []
    calibrate = w8a8.calibrate_act_scales

    def spy(module, batches, *a, **kw):
        seen.append((torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic))
        return calibrate(module, batches, *a, **kw)

    monkeypatch.setattr(w8a8, "calibrate_act_scales", spy)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", True)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    q = _server(precision="w8a8")
    q.load()
    try:
        assert seen == [(False, True)] and q.act_scales_calibrated == 11
        assert (torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic) == (True, False)
    finally:
        q.unload()


def test_resnet50_w8a8_calibrates_52_layers_and_quantises_54_kernels():
    # constructed and loaded at a small input, not served
    s = _server(model="resnet50", num_classes=16, input_shape=(32, 32, 3), max_batch_size=1,
                calibration_batches=1, precision="w8a8")
    s.load()
    try:
        assert s.act_scales_calibrated == 52
        assert len(s.quantize_manifest) == 54
        assert s.health_status()["act_scales_calibrated"] == 52
    finally:
        s.unload()


@pytest.mark.parametrize("kw,reason", [
    (dict(quantize="fp4"), "BAD_QUANTIZE"),
    (dict(precision="int4"), "BAD_QUANTIZE"),
])
def test_bad_mode_or_precision_rejected_at_construction(kw, reason):
    with pytest.raises(JaxMicroserviceError) as want:
        JaxServer(**COMMON, **kw)
    with pytest.raises(MicroserviceError) as got:
        _server(**kw)
    assert (got.value.status_code, got.value.reason) == (want.value.status_code, want.value.reason) == (400, reason)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [
    dict(model="vit_tiny", precision="w8a8"),
    dict(model="transformer_lm", input_shape=(8,), warmup_dtypes=("int32",), precision="w8a8"),
    dict(precision="w8a8", model_kwargs={"precision": "bf16"}),
])
def test_w8a8_where_it_cannot_run_is_bad_precision(kw):
    s = _server(**kw)
    with pytest.raises(MicroserviceError, match="precision") as err:
        s.load()
    assert (err.value.status_code, err.value.reason) == (400, "BAD_PRECISION")


def test_cuda_without_a_card_raises():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(MicroserviceError) as err:
        CudaServer(**{**COMMON, "precision": "w8a8"})
    assert err.value.reason == "NO_CUDA_DEVICE"
