"""The PyTorch port's ResNet and flax->torch converter against the flax ResNet.

Same parameters into both packages: the flax model's variables are
re-drawn from numpy with a seed (every BatchNorm scale non-zero, so each
residual branch counts), converted by ``resnet_params_from_flax`` and
loaded into the port's model.  Tolerances are stated per test.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.models import resnet as flax_resnet
from seldon_core_tpu_torch.models import resnet
from seldon_core_tpu_torch.models.convert import resnet_params_from_flax


def random_variables(module, input_shape, seed):
    """flax init for the tree's structure, then every leaf re-drawn from
    numpy: LeCun-normal kernels, BatchNorm scale in [0.5, 1], small bias
    and mean, variance in [0.5, 1.5]."""
    shapes = jax.eval_shape(module.init, jax.random.key(0), jnp.zeros((1, *input_shape), jnp.float32))
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        shape, name = tuple(x.shape), path[-1].key
        if name == "kernel":
            return (rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.0, shape).astype(np.float32)
        if name in ("bias", "mean"):
            return (0.1 * rng.standard_normal(shape)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        raise KeyError(name)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def both_models(name, num_classes, input_shape, seed, flax_dtype=jnp.float32, torch_dtype=torch.float32):
    fmod = getattr(flax_resnet, name)(num_classes=num_classes, dtype=flax_dtype)
    variables = random_variables(fmod, input_shape, seed)
    tmod = getattr(resnet, name)(num_classes=num_classes, dtype=torch_dtype)
    tmod.load_state_dict(resnet_params_from_flax(variables))
    return fmod, variables, tmod.eval()


def run_both(fmod, variables, tmod, x):
    ref = np.asarray(jax.jit(fmod.apply)(variables, jnp.asarray(x)))
    with torch.inference_mode():
        got = tmod(torch.from_numpy(x)).numpy()
    return got, ref


class TestF32Parity:
    @pytest.mark.parametrize("hw", [32, 33])
    def test_resnet_tiny(self, hw):
        # tolerance rtol = atol = 1e-4: same f32 math, different summation order
        fmod, variables, tmod = both_models("ResNetTiny", 10, (hw, hw, 3), seed=1)
        x = np.random.default_rng(2).standard_normal((3, hw, hw, 3)).astype(np.float32)
        got, ref = run_both(fmod, variables, tmod, x)
        assert got.dtype == np.float32 and got.shape == (3, 10)
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)

    def test_resnet50_bottleneck_and_shortcut_names(self):
        # 64x64, batch 2: every bottleneck block, the four shortcut convs
        # and the stride-2 3x3 convs; tolerance rtol = atol = 1e-4
        fmod, variables, tmod = both_models("ResNet50", 16, (64, 64, 3), seed=3)
        x = np.random.default_rng(4).standard_normal((2, 64, 64, 3)).astype(np.float32)
        got, ref = run_both(fmod, variables, tmod, x)
        assert got.shape == (2, 16)
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


class TestBf16Parity:
    def test_resnet_tiny_bf16(self):
        # bf16 convs round differently in XLA and PyTorch (bf16 keeps ~3
        # significant digits): relative L2 error <= 3e-2 of the logits
        fmod, variables, tmod = both_models(
            "ResNetTiny", 10, (32, 32, 3), seed=5, flax_dtype=jnp.bfloat16, torch_dtype=torch.bfloat16)
        x = np.random.default_rng(6).standard_normal((2, 32, 32, 3)).astype(np.float32)
        got, ref = run_both(fmod, variables, tmod, x)
        assert got.dtype == np.float32 and ref.dtype == np.float32
        assert np.linalg.norm(got - ref) / np.linalg.norm(ref) <= 3e-2
        assert tmod.conv_init.weight.dtype == torch.bfloat16
        assert tmod.bn_init.weight.dtype == torch.float32


class TestSamePadding:
    """flax ``SAME`` is asymmetric (0, 1) where torch's ``padding=1`` is
    symmetric: on an even size, a 3x3 stride-2 conv or max-pool with
    torch's padding differs by whole pixels."""

    @pytest.mark.parametrize("size", [8, 9])
    def test_stride2_conv_matches_flax_same(self, size):
        rng = np.random.default_rng(size)
        x = rng.standard_normal((2, size, size, 4)).astype(np.float32)
        conv = fnn.Conv(5, (3, 3), (2, 2), use_bias=False, dtype=jnp.float32)
        params = conv.init(jax.random.key(0), jnp.asarray(x))
        ref = np.asarray(conv.apply(params, jnp.asarray(x)))
        port = resnet.ConvSame(4, 5, 3, 2, dtype=torch.float32)
        kernel = np.array(params["params"]["kernel"])  # HWIO -> OIHW
        port.weight.copy_(torch.from_numpy(np.transpose(kernel, (3, 2, 0, 1))))
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        got = port(xt).permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
        symmetric = torch.nn.functional.conv2d(xt, port.weight, stride=2, padding=1).permute(0, 2, 3, 1).numpy()
        assert symmetric.shape == ref.shape
        if size % 2 == 0:  # the hazard: symmetric padding is wrong on even sizes
            assert np.abs(symmetric - ref).max() > 1e-2
        assert resnet.same_pads(size, 3, 2) == ((0, 1) if size % 2 == 0 else (1, 1))

    @pytest.mark.parametrize("size", [8, 9])
    def test_max_pool_matches_flax_same(self, size):
        x = np.random.default_rng(10 + size).standard_normal((2, size, size, 3)).astype(np.float32)
        ref = np.asarray(fnn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2), padding="SAME"))
        got = resnet.max_pool_same(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
        np.testing.assert_array_equal(got, ref)

    def test_same_pads_rule(self):
        assert resnet.same_pads(224, 7, 2) == (2, 3)  # the stem uses explicit (3, 3) instead
        assert resnet.same_pads(56, 1, 2) == (0, 0)
        assert resnet.same_pads(56, 3, 1) == (1, 1)


class TestConverter:
    def _tiny_variables(self):
        fmod = flax_resnet.ResNetTiny(num_classes=4, dtype=jnp.float32)
        return random_variables(fmod, (32, 32, 3), seed=11)

    def test_layouts_and_names(self):
        variables = self._tiny_variables()
        sd = resnet_params_from_flax(variables)
        port = resnet.ResNetTiny(num_classes=4, dtype=torch.float32)
        assert set(sd) == set(port.state_dict())
        kernel = np.asarray(variables["params"]["BasicBlock_1"]["Conv_0"]["kernel"])  # HWIO
        np.testing.assert_array_equal(sd["blocks.1.conv0.weight"].numpy(), np.transpose(kernel, (3, 2, 0, 1)))
        head = np.asarray(variables["params"]["head"]["kernel"])  # (in, out)
        np.testing.assert_array_equal(sd["head.weight"].numpy(), head.T)
        np.testing.assert_array_equal(sd["blocks.1.shortcut_bn.running_var"].numpy(),
                                      np.asarray(variables["batch_stats"]["BasicBlock_1"]["shortcut_bn"]["var"]))
        assert all(v.dtype == torch.float32 for v in sd.values())

    def test_missing_key_is_an_error(self):
        variables = self._tiny_variables()
        del variables["batch_stats"]["BasicBlock_2"]["BatchNorm_1"]["mean"]
        with pytest.raises(ValueError, match="missing batch_stats/BasicBlock_2/BatchNorm_1/mean"):
            resnet_params_from_flax(variables)

    def test_extra_key_is_an_error(self):
        variables = self._tiny_variables()
        variables["params"]["head"]["extra"] = np.zeros(3, np.float32)
        with pytest.raises(ValueError, match="unconverted flax entries: \\['params/head/extra'\\]"):
            resnet_params_from_flax(variables)

    def test_extra_collection_is_an_error(self):
        # act_scales is a known collection (load_act_scales carries it)
        variables = dict(self._tiny_variables())
        variables["intermediates"] = {}
        with pytest.raises(ValueError, match="extra flax collections"):
            resnet_params_from_flax(variables)

    def test_state_dict_mismatch_with_the_model_is_an_error(self):
        sd = resnet_params_from_flax(self._tiny_variables())
        with pytest.raises(RuntimeError, match="size mismatch|Missing key|Unexpected key"):
            resnet.ResNet18(num_classes=4, dtype=torch.float32).load_state_dict(sd)


class TestModule:
    def test_seeded_init_is_deterministic_and_zero_inits_residual_scale(self):
        a = resnet.ResNetTiny(num_classes=3, dtype=torch.float32).reset_parameters(torch.Generator().manual_seed(0))
        b = resnet.ResNetTiny(num_classes=3, dtype=torch.float32).reset_parameters(torch.Generator().manual_seed(0))
        for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(va, vb), k
        assert torch.count_nonzero(a.blocks[0].bn1.weight) == 0
        assert torch.all(a.blocks[0].bn0.weight == 1)

    def test_w8a8_precision_is_not_ported(self):
        # the JAX model's precision option is ported: "w8a8" builds the
        # int8 convs (tests/test_torch_port_w8a8.py), any other value
        # than "bf16" / "w8a8" is refused as the JAX model refuses it
        assert resnet.ResNetTiny(num_classes=3, precision="w8a8").precision == "w8a8"
        with pytest.raises(ValueError, match="precision"):
            resnet.ResNetTiny(num_classes=3, precision="int8w")
