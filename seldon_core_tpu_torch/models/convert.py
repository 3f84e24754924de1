"""Flax variables -> the port's ``state_dict``: ResNet
(``resnet_params_from_flax``), TransformerLM (``lm_params_from_flax``),
TransformerEncoder (``encoder_params_from_flax``), VisionTransformer
(``vit_params_from_flax``), MLPClassifier (``mlp_params_from_flax``),
the served detector (``detector_params_from_flax``) and the learned
outlier detectors' networks (``vae_params_from_flax``,
``seq2seq_params_from_flax``).

The inverse of the JAX package's torch->flax converter.  For ResNet it
takes the ``{"params": ..., "batch_stats": ...}`` tree that
``seldon_core_tpu.models.resnet.ResNet*`` initialises or loads (leaves as
numpy arrays) and returns the ``state_dict`` of
``seldon_core_tpu_torch.models.resnet.ResNet*``:

* conv kernels  HWIO (flax/XLA) -> OIHW,
* dense kernel  (in, out) -> (out, in),
* BatchNorm ``scale``/``bias`` params and ``mean``/``var`` stats ->
  ``weight``/``bias``/``running_mean``/``running_var``,
* flax's auto-generated module names -> the port's attributes:
  ``conv_init``/``bn_init`` -> themselves, ``{Basic,Bottleneck}Block_N``
  -> ``blocks.N``, ``Conv_K``/``BatchNorm_K`` -> ``convK``/``bnK`` (a
  w8a8 flax ResNet auto-names its block convs ``W8A8Conv_K``: taken too),
  ``shortcut_conv``/``shortcut_bn`` -> themselves, ``head`` -> ``head``.

The transformer family maps the same way (dense kernels transposed,
``Embed.embedding`` as is, LayerNorm ``scale`` -> ``weight``, the
TransformerBlock parts of ``_LM_BLOCK_PARTS`` shared by all three);
:func:`lm_flax_params` maps an LM ``state_dict`` back to flax's tree.
Every leaf of the tree must be consumed and every leaf a module needs
must be present: a missing or an extra key is a ``ValueError`` naming
it.

The w8a8 lane's calibrated ``act_scales`` collection (one ``scale`` per
w8a8 layer, at the layer's module path) goes into the layers'
``act_scale`` buffers with :func:`load_act_scales`.
:func:`state_key_for_flax_path` maps any flax path (a ``quantize_params``
manifest row's, an ``act_scales`` leaf's) to the port's key, and
:func:`flax_kernel_path` maps a kernel's key back.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

_BLOCK = re.compile(r"^(BasicBlock|BottleneckBlock)_(\d+)$")
_BLOCK_CONVS = {"BasicBlock": 2, "BottleneckBlock": 3}


def _conv(arr: Any) -> np.ndarray:
    """HWIO (flax/XLA) -> OIHW (torch)."""
    return np.transpose(np.asarray(arr), (3, 2, 0, 1))


def _linear(arr: Any) -> np.ndarray:
    """(in, out) -> (out, in)."""
    return np.transpose(np.asarray(arr), (1, 0))


def resnet_params_from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ResNet ``variables`` -> the port's ResNet ``state_dict``
    (float32 CPU tensors; ``load_state_dict`` casts to the model's dtype)."""
    extra_top = sorted(set(variables) - {"params", "batch_stats", "act_scales"})
    if extra_top:
        raise ValueError(f"extra flax collections {extra_top} (expected params and batch_stats; act_scales "
                         "goes to load_act_scales)")
    params = dict(variables.get("params", {}))
    stats = dict(variables.get("batch_stats", {}))
    out: Dict[str, np.ndarray] = {}
    consumed = set()

    def take(tree: Dict, collection: str, path: Tuple[str, ...]) -> np.ndarray:
        node: Any = tree
        for key in path:
            if not isinstance(node, Mapping) or key not in node:
                raise ValueError(f"flax variables missing {collection}/{'/'.join(path)}")
            node = node[key]
        consumed.add((collection, *path))
        return np.asarray(node)

    def conv(flax_path: Tuple[str, ...], torch_key: str) -> None:
        out[f"{torch_key}.weight"] = _conv(take(params, "params", (*flax_path, "kernel")))

    def bn(flax_path: Tuple[str, ...], torch_key: str) -> None:
        out[f"{torch_key}.weight"] = take(params, "params", (*flax_path, "scale"))
        out[f"{torch_key}.bias"] = take(params, "params", (*flax_path, "bias"))
        out[f"{torch_key}.running_mean"] = take(stats, "batch_stats", (*flax_path, "mean"))
        out[f"{torch_key}.running_var"] = take(stats, "batch_stats", (*flax_path, "var"))

    conv(("conv_init",), "conv_init")
    bn(("bn_init",), "bn_init")
    blocks = sorted(
        ((m.group(1), int(m.group(2))) for m in map(_BLOCK.match, params) if m),
        key=lambda kv: kv[1],
    )
    if [i for _, i in blocks] != list(range(len(blocks))):
        raise ValueError(f"flax block names are not numbered 0..N-1: {[f'{k}_{i}' for k, i in blocks]}")
    if len({kind for kind, _ in blocks}) > 1:
        raise ValueError("flax variables mix BasicBlock and BottleneckBlock")
    for kind, i in blocks:
        name = f"{kind}_{i}"
        for k in range(_BLOCK_CONVS[kind]):
            conv_name = f"W8A8Conv_{k}" if f"W8A8Conv_{k}" in params[name] else f"Conv_{k}"
            conv((name, conv_name), f"blocks.{i}.conv{k}")
            bn((name, f"BatchNorm_{k}"), f"blocks.{i}.bn{k}")
        if "shortcut_conv" in params[name] or "shortcut_bn" in params[name]:
            conv((name, "shortcut_conv"), f"blocks.{i}.shortcut_conv")
            bn((name, "shortcut_bn"), f"blocks.{i}.shortcut_bn")
    out["head.weight"] = _linear(take(params, "params", ("head", "kernel")))
    out["head.bias"] = take(params, "params", ("head", "bias"))

    leftover = sorted(
        "/".join(p) for p in _leaf_paths(params, ("params",)) + _leaf_paths(stats, ("batch_stats",))
        if p not in consumed
    )
    if leftover:
        raise ValueError(f"unconverted flax entries: {leftover[:8]}")
    return {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32)) for k, v in out.items()}


def _leaf_paths(tree: Any, prefix: Tuple[str, ...]):
    if isinstance(tree, Mapping):
        paths = []
        for k, v in tree.items():
            paths.extend(_leaf_paths(v, (*prefix, k)))
        return paths
    return [prefix]


_LM_BLOCK = re.compile(r"^block_(\d+)$")
# flax submodule of a TransformerBlock -> the port's attribute
_LM_BLOCK_PARTS = {"LayerNorm_0": "ln0", "qkv": "qkv", "attn_proj": "attn_proj", "LayerNorm_1": "ln1",
                   "mlp_in": "mlp_in", "mlp_out": "mlp_out"}


class _FlaxParams:
    """One flax params tree being converted: each ``take`` consumes a
    leaf, and ``state_dict`` refuses a tree with leaves left over."""

    def __init__(self, params: Mapping[str, Any]):
        if set(params) == {"params"}:
            params = params["params"]
        self.params = dict(params)
        self.out: Dict[str, np.ndarray] = {}
        self.consumed = set()

    def take(self, path: Tuple[str, ...]) -> np.ndarray:
        node: Any = self.params
        for key in path:
            if not isinstance(node, Mapping) or key not in node:
                raise ValueError(f"flax params missing {'/'.join(path)}")
            node = node[key]
        self.consumed.add(("params", *path))
        return np.asarray(node)

    def leaf(self, flax_path: Tuple[str, ...], torch_key: str) -> None:
        self.out[torch_key] = self.take(flax_path)

    def dense(self, flax_path: Tuple[str, ...], torch_key: str) -> None:
        self.out[f"{torch_key}.weight"] = _linear(self.take((*flax_path, "kernel")))
        self.out[f"{torch_key}.bias"] = self.take((*flax_path, "bias"))

    def norm(self, flax_path: Tuple[str, ...], torch_key: str) -> None:
        self.out[f"{torch_key}.weight"] = self.take((*flax_path, "scale"))
        self.out[f"{torch_key}.bias"] = self.take((*flax_path, "bias"))

    def conv(self, flax_path: Tuple[str, ...], torch_key: str) -> None:
        self.out[f"{torch_key}.weight"] = _conv(self.take((*flax_path, "kernel")))
        self.out[f"{torch_key}.bias"] = self.take((*flax_path, "bias"))

    def blocks(self) -> None:
        """``block_N`` TransformerBlocks -> ``blocks.N``."""
        blocks = sorted(int(m.group(1)) for m in map(_LM_BLOCK.match, self.params) if m)
        if blocks != list(range(len(blocks))):
            raise ValueError(f"flax block names are not numbered 0..N-1: {blocks}")
        for i in blocks:
            for flax_name, port_name in _LM_BLOCK_PARTS.items():
                convert = self.norm if flax_name.startswith("LayerNorm") else self.dense
                convert((f"block_{i}", flax_name), f"blocks.{i}.{port_name}")

    def state_dict(self) -> Dict[str, torch.Tensor]:
        leftover = sorted("/".join(p) for p in _leaf_paths(self.params, ("params",)) if p not in self.consumed)
        if leftover:
            raise ValueError(f"unconverted flax entries: {leftover[:8]}")
        return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in self.out.items()}


def lm_params_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ``TransformerLM`` params -> the port's ``TransformerLM`` /
    ``PagedTransformerLM`` ``state_dict`` (float32 CPU tensors).

    Accepts the bare params tree or ``{"params": tree}``.  Dense
    ``kernel`` (in, out) becomes ``weight`` (out, in); ``Embed.embedding``
    keeps its (num, features) layout; LayerNorm ``scale``/``bias`` become
    ``weight``/``bias``; ``block_N`` -> ``blocks.N``, the top-level
    ``LayerNorm_0`` -> ``ln_f``.  Every leaf must be consumed."""
    tree = _FlaxParams(params)
    tree.leaf(("tok_embed", "embedding"), "tok_embed.weight")
    tree.leaf(("pos_embed", "embedding"), "pos_embed.weight")
    tree.blocks()
    tree.norm(("LayerNorm_0",), "ln_f")
    tree.dense(("head",), "head")
    return tree.state_dict()


def lm_flax_params(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of :func:`lm_params_from_flax`: a ``TransformerLM`` (or
    ``TransformerEncoder``) ``state_dict`` -> flax's bare params tree, CPU
    tensors in their own dtype, dense weights back to (in, out).  The
    template a checkpoint is restored onto, and what a checkpoint of the
    port's weights is written from."""
    sd = {k: v.detach().to("cpu") for k, v in state_dict.items()}

    def dense(key: str) -> Dict[str, torch.Tensor]:
        return {"kernel": sd[f"{key}.weight"].t().contiguous(), "bias": sd[f"{key}.bias"]}

    def norm(key: str) -> Dict[str, torch.Tensor]:
        return {"scale": sd[f"{key}.weight"], "bias": sd[f"{key}.bias"]}

    tree: Dict[str, Any] = {"tok_embed": {"embedding": sd["tok_embed.weight"]},
                            "pos_embed": {"embedding": sd["pos_embed.weight"]}}
    blocks = sorted({int(k.split(".")[1]) for k in sd if k.startswith("blocks.")})
    for i in blocks:
        tree[f"block_{i}"] = {flax_name: (norm if flax_name.startswith("LayerNorm") else dense)(f"blocks.{i}.{port}")
                              for flax_name, port in _LM_BLOCK_PARTS.items()}
    tree["LayerNorm_0"] = norm("ln_f")
    tree["head"] = dense("head")
    return tree


def encoder_params_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ``TransformerEncoder`` params -> the port's
    ``TransformerEncoder`` ``state_dict``: the LM's tree and mapping
    (``tok_embed``, ``pos_embed``, ``block_N``, ``LayerNorm_0``, ``head``
    whose width is the class count)."""
    return lm_params_from_flax(params)


def vit_params_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ``VisionTransformer`` params -> the port's
    ``VisionTransformer`` ``state_dict``: ``patch_embed`` (kernel HWIO ->
    OIHW, bias), ``cls_token``, ``pos_embed``, ``block_N`` ->
    ``blocks.N``, the top-level ``LayerNorm_0`` -> ``ln_f``, ``head``.
    Every leaf must be consumed."""
    tree = _FlaxParams(params)
    tree.conv(("patch_embed",), "patch_embed")
    tree.leaf(("cls_token",), "cls_token")
    tree.leaf(("pos_embed",), "pos_embed")
    tree.blocks()
    tree.norm(("LayerNorm_0",), "ln_f")
    tree.dense(("head",), "head")
    return tree.state_dict()


_MLP_DENSE = re.compile(r"^dense_(\d+)$")


def mlp_params_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ``MLPClassifier`` params (bare, or ``{"params": tree}``) -> the
    port's ``MLPClassifier`` ``state_dict``: ``dense_{i}`` and ``head``
    keep their names, kernels (in, out) become weights (out, in).  Every
    leaf must be consumed."""
    tree = _FlaxParams(params)
    dense = sorted(int(m.group(1)) for m in map(_MLP_DENSE.match, tree.params) if m)
    if dense != list(range(len(dense))):
        raise ValueError(f"flax dense names are not numbered 0..N-1: {dense}")
    for i in dense:
        tree.dense((f"dense_{i}",), f"dense_{i}")
    tree.dense(("head",), "head")
    return tree.state_dict()


_VAE_DENSE = ("enc1", "mu", "logvar", "dec1", "out")


def vae_params_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX ``VAEOutlierDetector``'s variables (``{"params": tree}`` or
    bare) -> the port's ``VAE`` ``state_dict``: the five ``Dense`` layers
    keep their names, kernels (in, out) become weights (out, in)."""
    tree = _FlaxParams(params)
    for name in _VAE_DENSE:
        tree.dense((name,), name)
    return tree.state_dict()


_LSTM_GATES = ("i", "f", "g", "o")  # torch's order of the four gate blocks


def seq2seq_params_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX ``Seq2SeqOutlierDetector``'s variables -> the port's
    ``Seq2Seq`` ``state_dict``.  The encoder's and the decoder's flax
    ``OptimizedLSTMCell`` (``OptimizedLSTMCell_0`` / ``_1``) become
    ``nn.LSTM``s: the input kernels ``i{i,f,g,o}`` (in, H) stack into
    ``weight_ih_l0`` (4H, in) and the hidden kernels ``h{i,f,g,o}`` into
    ``weight_hh_l0``, in torch's i, f, g, o order; the hidden biases are
    ``bias_hh_l0``, and ``bias_ih_l0`` is zero (flax's input kernels have
    no bias).  ``out`` is a dense layer."""
    tree = _FlaxParams(params)
    for cell, key in (("OptimizedLSTMCell_0", "encoder"), ("OptimizedLSTMCell_1", "decoder")):
        w_ih = [_linear(tree.take((cell, f"i{g}", "kernel"))) for g in _LSTM_GATES]
        w_hh = [_linear(tree.take((cell, f"h{g}", "kernel"))) for g in _LSTM_GATES]
        b_hh = [tree.take((cell, f"h{g}", "bias")) for g in _LSTM_GATES]
        tree.out[f"{key}.weight_ih_l0"] = np.concatenate(w_ih, axis=0)
        tree.out[f"{key}.weight_hh_l0"] = np.concatenate(w_hh, axis=0)
        tree.out[f"{key}.bias_hh_l0"] = np.concatenate(b_hh, axis=0)
        tree.out[f"{key}.bias_ih_l0"] = np.zeros_like(tree.out[f"{key}.bias_hh_l0"])
    tree.dense(("out",), "out")
    return tree.state_dict()


_DET_HEAD_CONVS = ("neck_conv", "refine_conv", "heatmap", "size", "offset")


def detector_params_from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The variables of the JAX package's served detector
    (``make_detector``: ``params/detector/{backbone,det_head}`` and
    ``batch_stats/detector/backbone``) -> the port's ``ServedDetector``
    ``state_dict``.  The backbone converts as a ResNet classifier does
    (:func:`resnet_params_from_flax`), so a classifier's tree seeds it
    unchanged; the head's convs keep their names (kernel HWIO -> OIHW,
    bias).  Every leaf must be consumed."""
    extra_top = sorted(set(variables) - {"params", "batch_stats"})
    if extra_top:
        raise ValueError(f"extra flax collections {extra_top} (expected params and batch_stats)")
    params, stats = dict(variables.get("params", {})), dict(variables.get("batch_stats", {}))
    if set(params) != {"detector"} or set(stats) - {"detector"}:
        raise ValueError(f"expected one 'detector' module, got params {sorted(params)} and batch_stats "
                         f"{sorted(stats)}")
    det, det_stats = dict(params["detector"]), dict(stats.get("detector", {}))
    if set(det) != {"backbone", "det_head"} or set(det_stats) - {"backbone"}:
        raise ValueError(f"expected detector/backbone and detector/det_head, got {sorted(det)} and batch_stats "
                         f"{sorted(det_stats)}")
    out = {f"detector.backbone.{k}": v for k, v in resnet_params_from_flax(
        {"params": det["backbone"], "batch_stats": det_stats.get("backbone", {})}).items()}
    head = _FlaxParams({"det_head": det["det_head"]})
    for name in _DET_HEAD_CONVS:
        head.conv(("det_head", name), f"detector.det_head.{name}")
    out.update(head.state_dict())
    return out


# ---------------------------------------------------------------------------
# flax paths <-> the port's keys; the w8a8 act_scales collection
# ---------------------------------------------------------------------------

_FLAX_BLOCK = re.compile(r"^(BasicBlock|BottleneckBlock|block)_(\d+)$")
_FLAX_LAYER = re.compile(r"^(Conv|W8A8Conv|BatchNorm)_(\d+)$")
_PORT_LAYER = re.compile(r"^(conv|bn)(\d+)$")
# (collection, flax leaf) -> the port's attribute
_LEAVES = {("params", "kernel"): "weight", ("params", "bias"): "bias", ("params", "scale"): "weight",
           ("params", "embedding"): "weight", ("batch_stats", "mean"): "running_mean",
           ("batch_stats", "var"): "running_var", ("act_scales", "scale"): "act_scale"}


def state_key_for_flax_path(path: str) -> str:
    """A flax variables path, ``collection/module/.../leaf`` (e.g. the
    ``path`` of a JAX ``quantize_params`` manifest row,
    ``params/BottleneckBlock_3/Conv_1/kernel``), -> the port's key
    (``blocks.3.conv1.weight``); ``act_scales/.../scale`` -> the w8a8
    layer's ``...act_scale`` buffer."""
    collection, *mods, leaf = path.split("/")
    out, block = [], None
    for name in mods:
        m = _FLAX_BLOCK.match(name)
        if m and not out:
            out += ["blocks", m.group(2)]
            block = m.group(1)
            continue
        m = _FLAX_LAYER.match(name)
        if m and block != "block":
            out.append(("bn" if m.group(1) == "BatchNorm" else "conv") + m.group(2))
        elif block == "block" and name in _LM_BLOCK_PARTS:
            out.append(_LM_BLOCK_PARTS[name])
        elif name == "LayerNorm_0" and not out:
            out.append("ln_f")
        else:
            out.append(name)
    out.append(_LEAVES.get((collection, leaf), leaf))
    return ".".join(out)


_PORT_BLOCK_PARTS = {v: k for k, v in _LM_BLOCK_PARTS.items()}


def flax_kernel_path(module: torch.nn.Module, key: str) -> str:
    """A kernel's ``state_dict`` key (``blocks.3.conv1.weight``) -> its flax
    path (``params/BottleneckBlock_3/Conv_1/kernel``); flax's auto-names
    come from the port modules' classes (``BasicBlock``,
    ``BottleneckBlock``, else a transformer ``block``; ``W8A8Conv_K`` for
    a w8a8 conv, as flax names it)."""
    *mods, leaf = key.split(".")
    if leaf != "weight":
        raise ValueError(f"{key!r} is not a kernel key")
    out, block, i = [], None, 0
    while i < len(mods):
        name = mods[i]
        if name == "blocks" and not out and i + 1 < len(mods):
            kind = type(module.blocks[int(mods[i + 1])]).__name__
            block = kind if kind in _BLOCK_CONVS else "block"
            out.append(f"{block}_{mods[i + 1]}")
            i += 2
            continue
        m = _PORT_LAYER.match(name)
        if m and block in _BLOCK_CONVS:
            layer = type(module.get_submodule(".".join(mods[: i + 1]))).__name__
            kind = "BatchNorm_" if m.group(1) == "bn" else ("W8A8Conv_" if layer == "W8A8Conv" else "Conv_")
            out.append(kind + m.group(2))
        elif block == "block" and name in _PORT_BLOCK_PARTS:
            out.append(_PORT_BLOCK_PARTS[name])
        elif name == "ln_f" and not out:
            out.append("LayerNorm_0")
        else:
            out.append(name)
        i += 1
    return "/".join(["params", *out, "kernel"])


def load_act_scales(module: torch.nn.Module, variables: Mapping[str, Any]) -> int:
    """Copy a flax ``act_scales`` collection (``variables["act_scales"]``,
    as ``seldon_core_tpu.ops.w8a8.calibrate_act_scales`` leaves it) into
    the module's w8a8 layers' ``act_scale`` buffers.  Returns the number
    of scales loaded (0 without the collection); a scale whose layer is
    missing or is not a w8a8 layer is a ``ValueError``."""
    tree = variables.get("act_scales")
    if not tree:
        return 0
    buffers = dict(module.named_buffers())
    n = 0
    for path in _leaf_paths(tree, ("act_scales",)):
        key = state_key_for_flax_path("/".join(path))
        if key not in buffers:
            raise ValueError(f"flax {'/'.join(path)}: the port module has no w8a8 layer at {key!r}")
        node: Any = tree
        for k in path[1:]:
            node = node[k]
        buffers[key].copy_(torch.from_numpy(np.array(node, np.float32)))
        n += 1
    return n
