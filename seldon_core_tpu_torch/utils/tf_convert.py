"""TF/Keras checkpoint -> flax-layout variables for the ResNets.

The port's counterpart of ``seldon_core_tpu/utils/tf_convert.py``, the
second lane of the migration funnel (users arriving from the TFServing
ecosystem hold Keras / TF weights).  Converts a ``keras.applications``
ResNet checkpoint into the flax-layout ``{"params", "batch_stats"}`` tree
the JAX package's converter returns, so the port's ``CudaServer`` loads
it as a ``model_uri`` (``models/convert.resnet_params_from_flax``):

* conv kernels are already HWIO (TF's layout), dense kernels (in, out);
* BN gamma / beta -> scale / bias params, moving_mean / moving_variance
  -> the ``batch_stats`` collection;
* keras-applications convs carry biases (the flax convs do not): each
  folds exactly into the following BatchNorm's running mean,
  ``BN(conv(x) + b) == BN'(conv(x))`` with ``mean' = mean - b``;
* keras names (``conv3_block2_1_conv``, ``conv3_block2_0_conv`` shortcut,
  ``predictions``) -> flax paths (``BottleneckBlock_4/Conv_0``,
  ``shortcut_conv``, ``head``).

The conversion is pure numpy; TensorFlow is only needed to *load*
``.keras`` / ``.h5`` / SavedModel files (:func:`load_tf_weights`), and
the import is gated there.  Deviations of the topology, as in the JAX
package: the ResNets are v1.5 (stride on the 3x3 conv; keras is v1.0),
and BN epsilon is 1e-5 (keras 1.001e-5).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence

import numpy as np


def _set(tree: Dict, path: Sequence[str], value: np.ndarray) -> None:
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = np.asarray(value)


# keras.applications only ships the bottleneck family
KERAS_STAGES = {
    "resnet50": [3, 4, 6, 3],
    "resnet101": [3, 4, 23, 3],
    "resnet152": [3, 8, 36, 3],
}


def convert_tf_resnet(
    weights: Mapping[str, np.ndarray], arch: str = "resnet50"
) -> Dict[str, Dict]:
    """keras-applications ResNet weights (flat ``layer/weight`` dict)
    -> flax ``variables`` ({"params": ..., "batch_stats": ...})."""
    try:
        stage_sizes = KERAS_STAGES[arch]
    except KeyError:
        raise ValueError(
            f"unknown arch {arch!r}; one of {sorted(KERAS_STAGES)}"
        ) from None

    params: Dict = {}
    stats: Dict = {}
    consumed = set()

    def take(name: str, optional: bool = False):
        if name not in weights:
            if optional:
                return None
            raise KeyError(f"checkpoint missing {name!r} (arch {arch})")
        consumed.add(name)
        return np.asarray(weights[name])

    def copy_conv_bn(conv_layer: str, bn_layer: str, conv_path, bn_path) -> None:
        _set(params, [*conv_path, "kernel"], take(f"{conv_layer}/kernel"))
        _set(params, [*bn_path, "scale"], take(f"{bn_layer}/gamma"))
        _set(params, [*bn_path, "bias"], take(f"{bn_layer}/beta"))
        mean = take(f"{bn_layer}/moving_mean")
        bias = take(f"{conv_layer}/bias", optional=True)
        if bias is not None:  # fold the conv bias into the BN mean
            mean = mean - bias
        _set(stats, [*bn_path, "mean"], mean)
        _set(stats, [*bn_path, "var"], take(f"{bn_layer}/moving_variance"))

    copy_conv_bn("conv1_conv", "conv1_bn", ["conv_init"], ["bn_init"])

    # keras conv{s}_block{j} (1-based, s from 2) -> flax BottleneckBlock_{global}
    block_index = 0
    for stage, size in enumerate(stage_sizes, start=2):
        for j in range(1, size + 1):
            kp = f"conv{stage}_block{j}"
            fb = f"BottleneckBlock_{block_index}"
            for c in (1, 2, 3):
                copy_conv_bn(
                    f"{kp}_{c}_conv", f"{kp}_{c}_bn",
                    [fb, f"Conv_{c - 1}"], [fb, f"BatchNorm_{c - 1}"],
                )
            if f"{kp}_0_conv/kernel" in weights:  # projection shortcut
                copy_conv_bn(
                    f"{kp}_0_conv", f"{kp}_0_bn",
                    [fb, "shortcut_conv"], [fb, "shortcut_bn"],
                )
            block_index += 1

    _set(params, ["head", "kernel"], take("predictions/kernel"))
    _set(params, ["head", "bias"], take("predictions/bias"))

    leftover = sorted(k for k in weights if k not in consumed)
    if leftover:
        raise ValueError(f"unconverted checkpoint entries: {leftover[:8]}")
    return {"params": params, "batch_stats": stats}


def flatten_keras_weights(model) -> Dict[str, np.ndarray]:
    """Keras model -> flat ``layer_name/weight_short_name`` dict.

    Works under both Keras 2 (``w.name == 'conv1_conv/kernel:0'``) and
    Keras 3 (``w.path == 'conv1_conv/kernel'``) by keying on the
    enclosing layer's name + the weight's final path component.
    """
    out: Dict[str, np.ndarray] = {}
    for layer in model.layers:
        names: List[str] = [
            (getattr(w, "path", None) or w.name) for w in layer.weights
        ]
        for name, value in zip(names, layer.get_weights()):
            short = name.split("/")[-1].split(":")[0]
            key = f"{layer.name}/{short}"
            if key in out:
                raise ValueError(f"duplicate weight key {key!r}")
            out[key] = np.asarray(value)
    return out


def load_tf_weights(path: str) -> Dict[str, np.ndarray]:
    """Load a ``.keras``/``.h5``/SavedModel checkpoint to a flat numpy
    dict (the TensorFlow import is gated here)."""
    try:
        import tensorflow as tf  # noqa: PLC0415
    except ImportError as e:
        raise ImportError(
            "converting TF checkpoints needs tensorflow installed"
        ) from e
    model = tf.keras.models.load_model(path, compile=False)
    return flatten_keras_weights(model)


def convert_checkpoint(in_path: str, out_path: str, arch: str = "resnet50") -> Dict[str, Dict]:
    """CLI core: keras file in, flax msgpack out (a ``CudaServer``
    ``model_uri``), written by the port's ``utils/serialization.py``."""
    from seldon_core_tpu_torch.utils import serialization

    variables = convert_tf_resnet(load_tf_weights(in_path), arch=arch)
    with open(out_path, "wb") as f:
        f.write(serialization.to_bytes(variables))
    return variables
