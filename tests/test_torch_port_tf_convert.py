"""The port's Keras -> flax-layout ResNet conversion against the JAX
package's (``seldon_core_tpu_torch/utils/tf_convert.py``).

A keras-applications-named weight dict is made from a flax ResNet's
variable shapes with numpy leaves and non-zero conv biases folded out of
the BatchNorm means; both converters must return the same tree bit for
bit, and the round trip recovers the flax tree (means to float rounding).
Loading real Keras files needs TensorFlow, which neither test machine
has: those two tests skip without it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.models.resnet import ResNet50 as FlaxResNet50
from seldon_core_tpu.utils import tf_convert as jax_tf_convert
from seldon_core_tpu_torch.models.convert import resnet_params_from_flax
from seldon_core_tpu_torch.models.resnet import ResNet50
from seldon_core_tpu_torch.utils import serialization, tf_convert
from seldon_core_tpu_torch.utils.tf_convert import KERAS_STAGES, convert_tf_resnet


def _flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _numpy_variables(num_classes=16, seed=0):
    shapes = jax.eval_shape(FlaxResNet50(num_classes=num_classes, dtype=jnp.float32).init, jax.random.key(0),
                            jnp.zeros((1, 64, 64, 3)))
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return (0.1 * rng.standard_normal(x.shape)).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(leaf, shapes)
    return {"params": tree["params"], "batch_stats": tree["batch_stats"]}


def _to_keras_names(variables, arch, rng):
    """flax tree -> keras-applications names, non-zero conv biases folded
    out of the BN means (the converters must fold them back in)."""
    sd = {}
    params, stats = variables["params"], variables["batch_stats"]

    def put(conv_layer, bn_layer, conv_node, bn_node, bn_stats):
        bias = rng.normal(size=conv_node["kernel"].shape[-1]).astype(np.float32)
        sd[f"{conv_layer}/kernel"] = np.asarray(conv_node["kernel"])
        sd[f"{conv_layer}/bias"] = bias
        sd[f"{bn_layer}/gamma"] = np.asarray(bn_node["scale"])
        sd[f"{bn_layer}/beta"] = np.asarray(bn_node["bias"])
        sd[f"{bn_layer}/moving_mean"] = np.asarray(bn_stats["mean"]) + bias
        sd[f"{bn_layer}/moving_variance"] = np.asarray(bn_stats["var"])

    put("conv1_conv", "conv1_bn", params["conv_init"], params["bn_init"], stats["bn_init"])
    b = 0
    for stage, size in enumerate(KERAS_STAGES[arch], start=2):
        for j in range(1, size + 1):
            kp, fb = f"conv{stage}_block{j}", f"BottleneckBlock_{b}"
            for c in (1, 2, 3):
                put(f"{kp}_{c}_conv", f"{kp}_{c}_bn", params[fb][f"Conv_{c - 1}"], params[fb][f"BatchNorm_{c - 1}"],
                    stats[fb][f"BatchNorm_{c - 1}"])
            if "shortcut_conv" in params[fb]:
                put(f"{kp}_0_conv", f"{kp}_0_bn", params[fb]["shortcut_conv"], params[fb]["shortcut_bn"],
                    stats[fb]["shortcut_bn"])
            b += 1
    sd["predictions/kernel"] = np.asarray(params["head"]["kernel"])
    sd["predictions/bias"] = np.asarray(params["head"]["bias"])
    return sd


@pytest.fixture(scope="module")
def keras_dict():
    variables = _numpy_variables()
    return variables, _to_keras_names(variables, "resnet50", np.random.default_rng(7))


def test_round_trip_exact_with_bias_folding_and_bit_equal_to_jax_s(keras_dict):
    variables, sd = keras_dict
    mine = convert_tf_resnet(sd, arch="resnet50")
    theirs = jax_tf_convert.convert_tf_resnet(sd, arch="resnet50")
    got, want_jax, want = _flatten(mine), _flatten(theirs), _flatten(variables)
    assert set(got) == set(want_jax) == set(want)
    for key in want:
        assert got[key].dtype == want_jax[key].dtype
        np.testing.assert_array_equal(got[key], want_jax[key], err_msg=str(key))
        if key[-1] == "mean":  # (mean + b) - b: float-rounded, not bitwise
            np.testing.assert_allclose(got[key], want[key], atol=1e-6, err_msg=str(key))
        else:
            np.testing.assert_array_equal(got[key], want[key], err_msg=str(key))
    # the converted variables load into the port's ResNet50 and serve
    model = ResNet50(num_classes=16, dtype=torch.float32)
    model.load_state_dict(resnet_params_from_flax(mine))
    with torch.no_grad():
        logits = model.eval()(torch.ones(2, 64, 64, 3))
    assert logits.shape == (2, 16) and torch.isfinite(logits).all()


def test_convert_checkpoint_writes_the_msgpack_the_port_reads(keras_dict, tmp_path, monkeypatch):
    from flax import serialization as flax_serialization

    _variables, sd = keras_dict
    monkeypatch.setattr(tf_convert, "load_tf_weights", lambda path: sd)
    out = tmp_path / "resnet50.msgpack"
    converted = tf_convert.convert_checkpoint("model.keras", str(out), arch="resnet50")
    data = out.read_bytes()
    assert data == flax_serialization.to_bytes(jax_tf_convert.convert_tf_resnet(sd, arch="resnet50"))
    back = _flatten(serialization.msgpack_restore(data))
    for key, value in _flatten(converted).items():
        np.testing.assert_array_equal(back[key], value, err_msg=str(key))


def test_missing_key_reports_name():
    with pytest.raises(KeyError, match="conv1_bn/gamma"):
        convert_tf_resnet({"conv1_conv/kernel": np.zeros((7, 7, 3, 64))}, arch="resnet50")


def test_leftover_keys_rejected(keras_dict):
    _variables, sd = keras_dict
    with pytest.raises(ValueError, match="unconverted checkpoint entries: \\['stray_layer/kernel'\\]"):
        convert_tf_resnet({**sd, "stray_layer/kernel": np.zeros(3)}, arch="resnet50")


def test_unknown_arch_rejected():
    with pytest.raises(ValueError, match="unknown arch 'resnet18'; one of"):
        convert_tf_resnet({}, arch="resnet18")


def test_keras_names_flatten_from_layer_weights():
    """``flatten_keras_weights`` keys on the layer name and the weight's
    last path part (Keras 2 ``name`` and Keras 3 ``path`` spellings)."""

    class W:
        def __init__(self, **kw):
            self.__dict__.update(kw)

    class Layer:
        def __init__(self, name, weights):
            self.name, self.weights = name, [W(**w) for w, _ in weights]
            self._values = [v for _, v in weights]

        def get_weights(self):
            return self._values

    model = W(layers=[Layer("c0", [({"name": "c0/kernel:0"}, np.ones(2)), ({"path": "c0/bias", "name": "b"},
                                                                           np.zeros(1))])])
    assert set(tf_convert.flatten_keras_weights(model)) == {"c0/kernel", "c0/bias"}


def test_loading_keras_files_needs_tensorflow():
    try:
        import tensorflow  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="needs tensorflow"):
            tf_convert.load_tf_weights("model.keras")
        return
    pytest.skip("tensorflow is installed: the loader's refusal does not apply")


def test_real_keras_resnet50_converts_and_serves():
    tf = pytest.importorskip("tensorflow")
    weights = tf_convert.flatten_keras_weights(tf.keras.applications.ResNet50(weights=None))
    model = ResNet50(num_classes=1000, dtype=torch.float32)
    model.load_state_dict(resnet_params_from_flax(convert_tf_resnet(weights, arch="resnet50")))
    with torch.no_grad():
        assert torch.isfinite(model.eval()(torch.ones(1, 64, 64, 3))).all()


def test_loader_flattens_saved_keras_file(tmp_path):
    tf = pytest.importorskip("tensorflow")
    inputs = tf.keras.Input((8, 8, 3))
    x = tf.keras.layers.Conv2D(4, 3, name="c0")(inputs)
    x = tf.keras.layers.BatchNormalization(name="b0")(x)
    out = tf.keras.layers.Dense(2, name="d0")(tf.keras.layers.Flatten()(x))
    path = tmp_path / "tiny.keras"
    tf.keras.Model(inputs, out).save(path)
    assert set(tf_convert.load_tf_weights(str(path))) == {
        "c0/kernel", "c0/bias", "b0/gamma", "b0/beta", "b0/moving_mean", "b0/moving_variance", "d0/kernel",
        "d0/bias"}
