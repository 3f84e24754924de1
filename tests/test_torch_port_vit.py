"""The port's ViT and TransformerEncoder against the JAX package's flax modules.

The flax init is carried across by ``vit_params_from_flax`` /
``encoder_params_from_flax``; the same numpy images or tokens go through
the flax module's ``apply`` and the port's ``forward``, both in float32,
with plain attention and with flash attention (on the JAX side the Pallas
kernel in interpret mode, on the port's side the plain version of K3).

Tolerance: float32 logits within 1e-4 absolute (rtol 1e-4): the order of
sums differs between XLA and PyTorch on the CPU, through up to twelve
layers of float32 arithmetic.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.models import transformer as flax_transformer
from seldon_core_tpu.models import vit as flax_vit
from seldon_core_tpu.ops.kernels import flash_attn_fn as jax_flash_attn_fn
from seldon_core_tpu_torch.models import vit
from seldon_core_tpu_torch.models.convert import encoder_params_from_flax, vit_params_from_flax
from seldon_core_tpu_torch.models.transformer import TransformerEncoder, TransformerLM, plain_attention
from seldon_core_tpu_torch.ops import kernels

TOL = dict(rtol=1e-4, atol=1e-4)


def _images(n, shape, seed):
    return np.random.default_rng(seed).standard_normal((n, *shape)).astype(np.float32)


def _port_vit(factory, params, flash, **kw):
    module = factory(dtype=torch.float32, attn_fn=kernels.flash_attn_fn() if flash else plain_attention, **kw)
    module.load_state_dict(vit_params_from_flax(params))
    return module.eval()


@pytest.fixture(scope="module")
def tiny_params():
    module = flax_vit.ViTTiny(num_classes=10, dtype=jnp.float32)
    return module.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3), jnp.float32))["params"]


class TestViTTiny:
    @pytest.mark.parametrize("flash", [False, True], ids=["plain", "flash"])
    def test_matches_flax(self, tiny_params, flash):
        x = _images(3, (32, 32, 3), seed=1)
        attn = {"attn_fn": jax_flash_attn_fn()} if flash else {}
        ref = flax_vit.ViTTiny(num_classes=10, dtype=jnp.float32, **attn).apply({"params": tiny_params},
                                                                                  jnp.asarray(x))
        model = _port_vit(vit.ViTTiny, tiny_params, flash, num_classes=10)
        with torch.inference_mode():
            got = model(torch.from_numpy(x))
        assert got.dtype == torch.float32 and tuple(got.shape) == (3, 10)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)

    def test_flash_launches_nothing_on_the_cpu(self, tiny_params):
        model = _port_vit(vit.ViTTiny, tiny_params, True, num_classes=10)
        before = kernels.launch_counts()
        with torch.inference_mode():
            model(torch.from_numpy(_images(1, (32, 32, 3), seed=2)))
        assert kernels.launch_counts() == before

    def test_converter_refuses_missing_and_extra_leaves(self, tiny_params):
        extra = dict(tiny_params)
        extra["head"] = dict(extra["head"], extra=np.zeros(3, np.float32))
        with pytest.raises(ValueError, match="unconverted flax entries: \\['params/head/extra'\\]"):
            vit_params_from_flax(extra)
        missing = dict(tiny_params)
        missing.pop("cls_token")
        with pytest.raises(ValueError, match="missing cls_token"):
            vit_params_from_flax(missing)
        missing = dict(tiny_params)
        missing["block_1"] = {k: v for k, v in tiny_params["block_1"].items() if k != "mlp_out"}
        with pytest.raises(ValueError, match="missing block_1/mlp_out/kernel"):
            vit_params_from_flax({"params": missing})

    def test_state_dict_covers_the_module(self, tiny_params):
        sd = vit_params_from_flax(tiny_params)
        module = vit.ViTTiny(num_classes=10, dtype=torch.float32)
        assert set(sd) == set(module.state_dict())
        assert tuple(sd["patch_embed.weight"].shape) == (64, 3, 8, 8)  # HWIO -> OIHW
        assert tuple(sd["pos_embed"].shape) == (1, 17, 64)

    def test_non_native_resolution_names_the_roadmap_item(self, tiny_params):
        """Another resolution divisible by the patch is served through the
        bicubic pos_embed resize, as flax serves it; one that is not
        divisible is refused, as flax refuses it."""
        model = _port_vit(vit.ViTTiny, tiny_params, False, num_classes=10)
        x = _images(2, (48, 48, 3), seed=7)
        ref = flax_vit.ViTTiny(num_classes=10, dtype=jnp.float32).apply({"params": tiny_params}, jnp.asarray(x))
        with torch.inference_mode():
            got = model(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
        with pytest.raises(ValueError, match="not divisible by patch_size"):
            model(torch.zeros(1, 36, 32, 3))

    @pytest.mark.parametrize("size", [48, 24], ids=["up-6x6", "down-3x3"])
    @pytest.mark.parametrize("flash", [False, True], ids=["plain", "flash"])
    def test_other_resolutions_match_flax(self, tiny_params, size, flash):
        x = _images(2, (size, size, 3), seed=size)
        attn = {"attn_fn": jax_flash_attn_fn()} if flash else {}
        ref = flax_vit.ViTTiny(num_classes=10, dtype=jnp.float32, **attn).apply({"params": tiny_params},
                                                                                  jnp.asarray(x))
        model = _port_vit(vit.ViTTiny, tiny_params, flash, num_classes=10)
        with torch.inference_mode():
            got = model(torch.from_numpy(x))
        assert tuple(got.shape) == (2, 10)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)

    def test_legacy_pos_grid_sizes_pos_embed_from_the_image(self):
        module = vit.VisionTransformer(num_classes=5, patch_size=8, d_model=32, num_layers=1, num_heads=2,
                                       dtype=torch.float32, image_size=(16, 24))
        assert tuple(module.pos_embed.shape) == (1, 2 * 3 + 1, 32)
        with torch.inference_mode():
            assert tuple(module(torch.zeros(2, 16, 24, 3)).shape) == (2, 5)
        with pytest.raises(ValueError, match="pos_grid or image_size"):
            vit.VisionTransformer(pos_grid=0)

    def test_seeded_init_follows_flax_scheme(self):
        a = vit.ViTTiny(num_classes=10, dtype=torch.float32).reset_parameters(torch.Generator().manual_seed(4))
        b = vit.ViTTiny(num_classes=10, dtype=torch.float32).reset_parameters(torch.Generator().manual_seed(4))
        for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(pa, pb), name
        assert (a.cls_token == 0).all() and (a.patch_embed.bias == 0).all() and (a.head.bias == 0).all()
        assert 0.015 < float(a.pos_embed.detach().std()) < 0.025
        fan_in = 3 * 8 * 8
        assert abs(float(a.patch_embed.weight.detach().std()) * np.sqrt(fan_in) - 1.0) < 0.15


# (native grid, output rows, output columns): up, down, non-square, and
# ViT-B/16's 14x14 grid at 384x384 (24x24) and at 112x160
@pytest.mark.parametrize("grid,h,w", [(4, 6, 6), (4, 3, 3), (4, 2, 2), (4, 3, 6), (4, 4, 7), (14, 24, 24),
                                      (14, 7, 10)])
def test_pos_embed_resize_matches_jax_image_resize(grid, h, w):
    """float32 within 1e-6 absolute: the same weights, contracted in
    another order (two einsums against one)."""
    d = 768 if grid == 14 else 64
    pos = (np.random.default_rng(grid * h + w).standard_normal((1, grid * grid + 1, d)) * 0.02).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(pos[:, 1:]).reshape(1, grid, grid, d), (1, h, w, d), method="bicubic")
    ref = np.concatenate([pos[:, :1], np.asarray(ref).reshape(1, h * w, d)], axis=1)
    got = vit.resize_pos_embed(torch.from_numpy(pos), grid, h, w)
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, h * w + 1, d)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


def test_bicubic_weights_are_not_interpolates():
    """Keys' a = -0.5 and the antialiased downsample: each output's taps
    sum to 1, and the weights differ from F.interpolate's a = -0.75."""
    for n_in, n_out in ((4, 6), (14, 24), (4, 3), (14, 7)):
        w = vit.bicubic_weights(n_in, n_out)
        assert tuple(w.shape) == (n_out, n_in)
        np.testing.assert_allclose(w.sum(dim=1).numpy(), 1.0, rtol=0, atol=1e-6)
    eye = torch.eye(4)[None, None]  # interpolate each basis vector: its weights
    interp = torch.nn.functional.interpolate(eye, size=(4, 6), mode="bicubic", align_corners=False)[0, 0]
    assert (interp.T - vit.bicubic_weights(4, 6)).abs().max() > 1e-2


def test_vit_base16_geometry_cut_to_two_layers_matches_flax():
    """ViT-B/16 widths (d 768, 12 heads of 64, patch 16, 224x224 -> 197
    tokens), 2 of its 12 layers, plain attention."""
    fmod = flax_vit.ViTBase16(num_classes=1000, num_layers=2, dtype=jnp.float32)
    params = fmod.init(jax.random.key(1), jnp.zeros((1, 224, 224, 3), jnp.float32))["params"]
    x = _images(2, (224, 224, 3), seed=3)
    ref = np.asarray(fmod.apply({"params": params}, jnp.asarray(x)))
    model = _port_vit(vit.ViTBase16, params, False, num_classes=1000, num_layers=2)
    assert model.pos_embed.shape[1] == 197 and model.blocks[0].num_heads == 12
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 1000)
    np.testing.assert_allclose(got, ref, **TOL)


class TestTransformerEncoder:
    KW = dict(num_classes=3, vocab_size=50, d_model=32, num_layers=2, num_heads=2, max_len=64)

    @pytest.fixture(scope="class")
    def params(self):
        module = flax_transformer.TransformerEncoder(dtype=jnp.float32, **self.KW)
        return module.init(jax.random.key(2), jnp.zeros((1, 40), jnp.int32))["params"]

    @pytest.mark.parametrize("pool", ["mean", "none"])
    def test_flash_matches_flax(self, params, pool):
        tokens = np.random.default_rng(4).integers(0, 50, (2, 40)).astype(np.int32)
        ref = flax_transformer.TransformerEncoder(dtype=jnp.float32, attn_fn=jax_flash_attn_fn(), pool=pool,
                                                  **self.KW).apply({"params": params}, jnp.asarray(tokens))
        model = TransformerEncoder(dtype=torch.float32, attn_fn=kernels.flash_attn_fn(), pool=pool, **self.KW)
        model.load_state_dict(encoder_params_from_flax(params))
        with torch.inference_mode():
            got = model(torch.from_numpy(tokens))
        assert got.dtype == torch.float32 and got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)

    def test_blocks_are_not_causal_and_lm_blocks_are(self):
        enc = TransformerEncoder(dtype=torch.float32, **self.KW)
        lm = TransformerLM(vocab_size=50, d_model=32, num_layers=2, num_heads=2, max_len=64, dtype=torch.float32,
                           attn_fn=kernels.flash_attn_fn())
        assert not any(b.causal for b in enc.blocks) and all(b.causal for b in lm.blocks)
        with pytest.raises(ValueError, match="pool"):
            TransformerEncoder(pool="max")
