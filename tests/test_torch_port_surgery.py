"""The port's checkpoint surgery (``ops/surgery.py``) against the JAX package's.

One set of flax variables per model (numpy-drawn for the ResNets, flax's
init for ViTTiny and a TransformerLM of width 64) goes through the JAX
``quantize_params`` and, converted, through the port's.  The set of
quantised kernels must be the same through the path map (54 on
ResNet-50, the 7x7 stem among them; embeddings never), the int8 values
and scales equal to the bit once the kernel is transposed, the manifest
bytes equal, and the dequantised kernels bit-equal in float32 and
bfloat16.  Everything here is exact: no tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.models import resnet as flax_resnet
from seldon_core_tpu.models import transformer as flax_transformer
from seldon_core_tpu.models import vit as flax_vit
from seldon_core_tpu.ops import surgery as jax_surgery
from seldon_core_tpu_torch.models import convert, resnet, transformer, vit
from seldon_core_tpu_torch.ops import surgery

from test_torch_port_resnet import random_variables

LM = dict(vocab_size=128, d_model=64, num_layers=2, num_heads=4, max_len=32)


def _resnet(name, shape):
    fmod = getattr(flax_resnet, name)(num_classes=10, dtype=jnp.float32)
    variables = random_variables(fmod, shape, seed=5)
    port = getattr(resnet, name)(num_classes=10, dtype=torch.float32)
    port.load_state_dict(convert.resnet_params_from_flax(variables))
    return variables, port


def _vit_tiny():
    params = flax_vit.ViTTiny(num_classes=10, dtype=jnp.float32).init(
        jax.random.key(1), jnp.zeros((1, 32, 32, 3), jnp.float32))["params"]
    port = vit.ViTTiny(num_classes=10, dtype=torch.float32)
    port.load_state_dict(convert.vit_params_from_flax(params))
    return {"params": params}, port


def _lm():
    params = flax_transformer.TransformerLM(dtype=jnp.float32, **LM).init(
        jax.random.key(2), jnp.zeros((1, 8), jnp.int32))["params"]
    port = transformer.TransformerLM(dtype=torch.float32, **LM)
    port.load_state_dict(convert.lm_params_from_flax(params))
    return {"params": params}, port


MODELS = {
    "resnet_tiny": lambda: _resnet("ResNetTiny", (32, 32, 3)),
    "resnet50": lambda: _resnet("ResNet50", (64, 64, 3)),
    "vit_tiny": _vit_tiny,
    "transformer_lm": _lm,
}
EXPECTED_KERNELS = {"resnet50": 54}


def _leaf(tree, path):
    node = tree
    for k in path.split("/"):
        node = node[k]
    return node


def _to_flax_layout(t):
    return t.permute(*range(2, t.dim()), 1, 0).numpy()


@pytest.fixture(scope="module", params=sorted(MODELS))
def quantized(request):
    variables, port = MODELS[request.param]()
    jax_tree, jax_manifest = jax_surgery.quantize_params(variables)
    state, manifest = surgery.quantize_params(port)
    return request.param, variables, jax_tree, jax_manifest, port, state, manifest


def test_same_kernels_same_bytes(quantized):
    name, _, _, jax_manifest, port, _, manifest = quantized
    want = {r["path"]: (tuple(r["shape"]), r["bytes_fp"], r["bytes_q"]) for r in jax_manifest}
    got = {r["path"]: (tuple(r["shape"]), r["bytes_fp"], r["bytes_q"]) for r in manifest}
    assert got == want
    assert len(manifest) == EXPECTED_KERNELS.get(name, len(jax_manifest)) > 0
    for row in manifest:
        assert convert.state_key_for_flax_path(row["path"]) == row["key"]
        assert convert.flax_kernel_path(port, row["key"]) == row["path"]
    keys = {r["key"] for r in manifest}
    if name == "resnet50":
        assert "conv_init.weight" in keys and "head.weight" in keys  # the stem is quantised, as in JAX
    if name == "transformer_lm":
        assert not {"tok_embed.weight", "pos_embed.weight"} & keys


def test_int8_values_and_scales_bit_equal(quantized):
    _, _, jax_tree, _, _, state, manifest = quantized
    for row in manifest:
        want = _leaf(jax_tree, row["path"])
        got = state[row["key"]]
        assert isinstance(got, surgery.QuantizedKernel) and got.q.dtype == torch.int8
        np.testing.assert_array_equal(_to_flax_layout(got.q), np.asarray(want.q))
        assert got.scale.numpy().tobytes() == np.asarray(want.scale).tobytes()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantised_kernels_bit_equal(quantized, dtype):
    _, _, jax_tree, _, _, state, manifest = quantized
    want_tree = jax_surgery.dequantize_params(jax_tree, getattr(jnp, dtype))
    got = surgery.dequantize_params(state, getattr(torch, dtype))
    for row in manifest:
        want = np.asarray(_leaf(want_tree, row["path"])).astype(np.float32)
        t = got[row["key"]]
        assert t.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(_to_flax_layout(t.float()), want)
    untouched = [k for k, v in state.items() if not isinstance(v, surgery.QuantizedKernel)]
    assert all(got[k] is state[k] for k in untouched)


def test_resident_bytes_equal(quantized):
    _, variables, jax_tree, _, port, state, _ = quantized
    assert surgery.tree_hbm_bytes(state) == jax_surgery.tree_hbm_bytes(jax_tree)
    assert surgery.tree_hbm_bytes(port.state_dict()) == jax_surgery.tree_hbm_bytes(variables)
    assert surgery.tree_hbm_bytes(state) < surgery.tree_hbm_bytes(port.state_dict())


def test_materialize_passes_through_unless_int8(quantized):
    _, _, _, _, _, state, manifest = quantized
    assert surgery.materialize(state, "") is state
    out = surgery.materialize(state, "int8", torch.float32)
    assert all(out[r["key"]].dtype == torch.float32 for r in manifest)


def test_min_elems_and_predicate():
    _, port = _resnet("ResNetTiny", (32, 32, 3))
    _, all_kernels = surgery.quantize_params(port, min_elems=1)
    assert {r["key"] for r in all_kernels} == set(surgery.kernel_keys(port))
    _, only_head = surgery.quantize_params(port, predicate=lambda key, t: key == "head.weight")
    assert [r["key"] for r in only_head] == ["head.weight"]


def test_quantize_kernel_keeps_channels_last():
    w = torch.randn(8, 4, 3, 3).contiguous(memory_format=torch.channels_last)
    qk = surgery.quantize_kernel(w)
    assert qk.q.is_contiguous(memory_format=torch.channels_last)
    want = jax_surgery.quantize_kernel(w.permute(2, 3, 1, 0).numpy())
    np.testing.assert_array_equal(_to_flax_layout(qk.q), want.q)


@pytest.mark.parametrize("call,arg", [("validate_quantize_mode", "fp4"), ("validate_precision", "int4"),
                                      ("validate_quantize_mode", "int8"), ("validate_precision", "w8a8")])
def test_validators_match_jax(call, arg):
    try:
        want = getattr(jax_surgery, call)(arg)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            getattr(surgery, call)(arg)
        assert str(got.value) == str(e)
    else:
        assert getattr(surgery, call)(arg) == want


def test_precision_vocabulary_matches_jax():
    assert surgery.PRECISIONS == jax_surgery.PRECISIONS
    for p in surgery.PRECISIONS:
        assert surgery.quantize_mode_for(p) == jax_surgery.quantize_mode_for(p)
