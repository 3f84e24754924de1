"""The port's w8a8 lane (``ops/w8a8.py``) against the JAX package's.

The same numpy activations and kernels go through the JAX primitives
(``lax.dot_general`` / ``conv_general_dilated`` with int32 accumulation)
and the port's (``torch._int_mm`` on an im2col matrix).  Tolerances: the
int8 values, the steps and the int32 accumulators exactly; the rescaled
outputs within 1 ulp (the same float32 operations); ResNetTiny w8a8
logits from the same calibrated scales within 1e-4 relative L2 (float32).
Calibration runs the int8 layers with dynamic per-sample scales, where a
last-bit difference in a float conv upstream (XLA and PyTorch sum in
other orders) moves a sample's abs-max and so its whole grid, and an
element near a rounding boundary can land one step apart: the first w8a8
layer, whose input has passed through no int8 rounding, is held to 1e-5
relative, every layer to 1e-2 (one step is 1/127 of the range).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.models import resnet as flax_resnet
from seldon_core_tpu.ops import surgery as jax_surgery
from seldon_core_tpu.ops import w8a8 as JW
from seldon_core_tpu_torch.models import convert, resnet
from seldon_core_tpu_torch.ops import kernels, surgery
from seldon_core_tpu_torch.ops import w8a8 as W

from test_torch_port_resnet import random_variables


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_int_conv(xq, wq, strides, padding):
    dn = jax.lax.conv_dimension_numbers(xq.shape, wq.shape, ("NHWC", "HWIO", "NHWC"))
    return np.asarray(jax.lax.conv_general_dilated(jnp.asarray(xq), jnp.asarray(wq), strides, padding,
                                                   dimension_numbers=dn, preferred_element_type=jnp.int32))


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,axes,scale", [((5, 32), None, None), ((3, 7, 40), None, None),
                                              ((2, 6, 6, 8), (1, 2, 3), None), ((4, 16), None, 3.5),
                                              ((2, 6, 6, 8), (1, 2, 3), 0.0)])
def test_quantize_activation_equal(shape, axes, scale):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32) * 3
    s = None if scale is None else np.float32(scale)
    want_q, want_s = JW.quantize_activation(jnp.asarray(x), None if s is None else jnp.asarray(s), axes)
    got_q, got_s = W.quantize_activation(_t(x), None if s is None else torch.tensor(s), axes)
    assert got_q.dtype == torch.int8
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    assert got_s.numpy().tobytes() == np.asarray(want_s).tobytes()


@pytest.mark.parametrize("m,k,n,act_scale", [(5, 32, 16, None), (4, 16, 8, 3.5), (33, 72, 24, None),
                                             (1, 20, 6, None)])
def test_matmul_accumulators_and_outputs(m, k, n, act_scale):
    rng = np.random.default_rng(m * k)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    s = None if act_scale is None else np.float32(act_scale)
    jxq, _ = JW.quantize_activation(jnp.asarray(x), None if s is None else jnp.asarray(s))
    jwq, _ = JW._quantize_weight_last_axis(jnp.asarray(w))
    want_acc = np.asarray(jax.lax.dot_general(jxq, jwq, (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32))
    xq, _ = W.quantize_activation(_t(x), None if s is None else torch.tensor(s))
    wq, _ = W._quantize_weight_last_axis(_t(w))
    acc = W._int_matmul(xq, wq)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), want_acc)
    want = np.asarray(JW.w8a8_matmul(jnp.asarray(x), jnp.asarray(w), None if s is None else jnp.asarray(s),
                                     out_dtype=jnp.float32))
    got = W.w8a8_matmul(_t(x), _t(w), None if s is None else torch.tensor(s), out_dtype=torch.float32)
    np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=1)


@pytest.mark.parametrize("hw,kernel,stride", [(8, 3, 1), (8, 3, 2), (8, 1, 2), (7, 3, 2), (1, 1, 1)])
def test_conv_accumulators_and_outputs(hw, kernel, stride):
    rng = np.random.default_rng(hw * 10 + kernel + stride)
    x = rng.standard_normal((2, hw, hw, 8)).astype(np.float32)
    w = rng.standard_normal((kernel, kernel, 8, 16)).astype(np.float32)
    jxq, _ = JW.quantize_activation(jnp.asarray(x), None, (1, 2, 3))
    jwq, _ = JW._quantize_weight_last_axis(jnp.asarray(w))
    want_acc = _jax_int_conv(jxq, jwq, (stride, stride), "SAME")
    xq, _ = W.quantize_activation(_t(x), None, (1, 2, 3))
    wq, _ = W._quantize_weight_last_axis(_t(w))
    acc = W._int_conv(xq, wq, (stride, stride), "SAME")
    assert acc.dtype == torch.int32 and tuple(acc.shape) == want_acc.shape
    np.testing.assert_array_equal(acc.numpy(), want_acc)
    want = np.asarray(JW.w8a8_conv(jnp.asarray(x), jnp.asarray(w), (stride, stride), "SAME", out_dtype=jnp.float32))
    got = W.w8a8_conv(_t(x), _t(w), (stride, stride), "SAME", out_dtype=torch.float32)
    np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=1)


def test_conv_explicit_pads_match_jax():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((1, 9, 9, 3)).astype(np.float32)
    w = rng.standard_normal((7, 7, 3, 8)).astype(np.float32)
    pads = [(3, 3), (3, 3)]
    want = np.asarray(JW.w8a8_conv(jnp.asarray(x), jnp.asarray(w), (2, 2), pads, out_dtype=jnp.float32))
    got = W.w8a8_conv(_t(x), _t(w), (2, 2), pads, out_dtype=torch.float32)
    np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=1)


def test_atrest_roundtrip_requantises_exactly():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((3, 3, 16, 32)).astype(np.float32)
    torch_w = _t(w.transpose(3, 2, 0, 1))  # OIHW
    qk = surgery.quantize_kernel(torch_w)
    deq = qk.dequantize(torch.float32)
    wq, step = W._quantize_weight_last_axis(deq.permute(2, 3, 1, 0))
    np.testing.assert_array_equal(wq.permute(3, 2, 0, 1).numpy(), qk.q.numpy())
    jqk = jax_surgery.quantize_kernel(w)
    _, jstep = JW._quantize_weight_last_axis(jax_surgery.dequantize_params({"k": jqk}, jnp.float32)["k"])
    assert step.numpy().tobytes() == np.asarray(jstep).tobytes()


def test_per_sample_scales_decouple_rows():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 6, 6, 4)).astype(np.float32)
    x[1] *= 50.0  # a hot batch-mate
    w = rng.standard_normal((3, 3, 4, 8)).astype(np.float32)
    batch = W.w8a8_conv(_t(x), _t(w), (1, 1), "SAME", out_dtype=torch.float32)
    for i in range(3):
        alone = W.w8a8_conv(_t(x[i:i + 1]), _t(w), (1, 1), "SAME", out_dtype=torch.float32)
        assert torch.equal(batch[i:i + 1], alone)
    xm = rng.standard_normal((4, 16)).astype(np.float32)
    xm[2] *= 100.0
    wm = rng.standard_normal((16, 8)).astype(np.float32)
    rows = W.w8a8_matmul(_t(xm), _t(wm), out_dtype=torch.float32)
    assert torch.equal(rows[0:1], W.w8a8_matmul(_t(xm[0:1]), _t(wm), out_dtype=torch.float32))


def test_zero_activation_is_finite():
    y = W.w8a8_conv(torch.zeros(1, 4, 4, 3), torch.randn(3, 3, 3, 5), (1, 1), "SAME")
    assert torch.isfinite(y).all() and not y.any()
    assert torch.isfinite(W.w8a8_matmul(torch.zeros(2, 8), torch.randn(8, 8))).all()


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def test_layers_keep_the_plain_state_dict():
    dense, plain = W.W8A8Dense(16, 8, dtype=torch.float32), torch.nn.Linear(16, 8)
    assert {k: v.shape for k, v in dense.state_dict().items()} == {k: v.shape for k, v in plain.state_dict().items()}
    conv, plain_conv = W.W8A8Conv(4, 8, 3, 2, dtype=torch.float32), resnet.ConvSame(4, 8, 3, 2, dtype=torch.float32)
    assert {k: v.shape for k, v in conv.state_dict().items()} == {
        k: v.shape for k, v in plain_conv.state_dict().items()}
    assert "act_scale" in dict(conv.named_buffers()) and float(conv.act_scale) == 0.0


def test_disabled_layers_equal_the_plain_layers():
    rng = np.random.default_rng(6)
    dense = W.W8A8Dense(16, 8, dtype=torch.float32, enable=False)
    dense.weight.copy_(_t(rng.standard_normal((8, 16)).astype(np.float32)))
    dense.bias.copy_(_t(rng.standard_normal(8).astype(np.float32)))
    plain = torch.nn.Linear(16, 8)
    plain.load_state_dict(dense.state_dict())
    x = _t(rng.standard_normal((3, 16)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(dense(x), plain(x))
    conv = W.W8A8Conv(4, 8, 3, 2, dtype=torch.float32, enable=False)
    conv.weight.copy_(_t(rng.standard_normal((8, 4, 3, 3)).astype(np.float32)))
    plain_conv = resnet.ConvSame(4, 8, 3, 2, dtype=torch.float32)
    plain_conv.load_state_dict(conv.state_dict())
    xc = _t(rng.standard_normal((2, 4, 8, 8)).astype(np.float32))
    assert torch.equal(conv(xc), plain_conv(xc))


def test_dense_matches_jax_layer():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 16)).astype(np.float32)
    layer = JW.W8A8Dense(features=8, dtype=jnp.float32)
    variables = layer.init(jax.random.key(0), jnp.asarray(x))
    params = {"kernel": rng.standard_normal((16, 8)).astype(np.float32),
              "bias": rng.standard_normal(8).astype(np.float32)}
    want = np.asarray(layer.apply({"params": params}, jnp.asarray(x)))
    port = W.W8A8Dense(16, 8, dtype=torch.float32)
    port.weight.copy_(_t(params["kernel"].T))
    port.bias.copy_(_t(params["bias"]))
    np.testing.assert_array_max_ulp(port(_t(x)).numpy(), want, maxulp=1)
    assert set(variables) == {"params", JW.ACT_SCALES}


def w8a8_names(variables):
    """A ResNet's flax variables as the w8a8 flax model names them: flax
    auto-names the block convs after their class, ``W8A8Conv_K``."""
    params = {block: ({(f"W8A8{k}" if k.startswith("Conv_") else k): v for k, v in tree.items()}
                      if "Block_" in block else tree)
              for block, tree in variables["params"].items()}
    return {**variables, "params": params}


def _tiny_pair():
    fmod = flax_resnet.ResNetTiny(num_classes=10, dtype=jnp.float32, precision="w8a8")
    variables = random_variables(flax_resnet.ResNetTiny(num_classes=10, dtype=jnp.float32), (32, 32, 3), seed=8)
    variables = w8a8_names(variables)
    port = resnet.ResNetTiny(num_classes=10, dtype=torch.float32, precision="w8a8")
    port.load_state_dict(convert.resnet_params_from_flax(variables))
    return fmod, variables, port.eval()


def _batches(n, seed):
    rng = np.random.default_rng(seed)
    scale, shift = kernels.imagenet_affine()
    return [rng.integers(0, 256, size=(4, 32, 32, 3)).astype(np.float32) * scale + shift for _ in range(n)]


def test_resnet_w8a8_layers_and_state_dict():
    port = resnet.ResNetTiny(num_classes=10, dtype=torch.float32, precision="w8a8")
    plain = resnet.ResNetTiny(num_classes=10, dtype=torch.float32)
    w8 = [n for n, m in port.named_modules() if isinstance(m, W.W8A8Conv)]
    assert len(w8) == 11 and "conv_init" not in w8  # 4 blocks x 2 + 3 shortcuts; the stem stays
    assert {k: v.shape for k, v in port.state_dict().items()} == {k: v.shape for k, v in plain.state_dict().items()}
    assert sum(isinstance(m, W.W8A8Conv) for m in resnet.ResNet50(precision="w8a8", dtype=torch.float32).modules()) == 52
    with pytest.raises(ValueError, match="precision must be 'bf16' or 'w8a8'"):
        resnet.ResNetTiny(precision="int8w")


def test_calibration_matches_jax_and_scales_carry_across():
    fmod, variables, port = _tiny_pair()
    batches = _batches(3, seed=9)
    calibrated, n_jax = JW.calibrate_act_scales(fmod, variables, [jnp.asarray(b) for b in batches])
    n = W.calibrate_act_scales(port, [_t(b) for b in batches])
    assert n == n_jax == 11
    buffers = dict(port.named_buffers())
    leaves = jax.tree_util.tree_leaves_with_path(calibrated[JW.ACT_SCALES])
    assert len(leaves) == 11
    for path, v in leaves:
        key = convert.state_key_for_flax_path("/".join([JW.ACT_SCALES] + [p.key for p in path]))
        rtol = 1e-5 if key == "blocks.0.conv0.act_scale" else 1e-2
        np.testing.assert_allclose(float(buffers[key]), float(v), rtol=rtol)

    # JAX's scales in the port's buffers: the same static grids, logits within 1e-4
    assert convert.load_act_scales(port, calibrated) == 11
    x = _batches(1, seed=10)[0]
    want = np.asarray(fmod.apply(calibrated, jnp.asarray(x)))
    kernels.reset_launch_counts()
    with torch.inference_mode():
        got = port(_t(x)).numpy()
    assert kernels.launch_counts()["w8a8_int_mm"] == 11  # one integer GEMM per w8a8 conv
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= 1e-4, rel


def test_load_act_scales_refuses_a_missing_layer():
    _, variables, port = _tiny_pair()
    bad = dict(variables, act_scales={"BasicBlock_0": {"Conv_9": {"scale": np.float32(1.0)}}})
    with pytest.raises(ValueError, match="no w8a8 layer"):
        convert.load_act_scales(port, bad)
    assert convert.load_act_scales(port, variables) == 0
