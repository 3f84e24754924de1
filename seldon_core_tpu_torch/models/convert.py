"""Flax variables -> the port's ``state_dict``: ResNet
(``resnet_params_from_flax``), TransformerLM (``lm_params_from_flax``),
TransformerEncoder (``encoder_params_from_flax``) and VisionTransformer
(``vit_params_from_flax``).

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
  -> ``blocks.N``, ``Conv_K``/``BatchNorm_K`` -> ``convK``/``bnK``,
  ``shortcut_conv``/``shortcut_bn`` -> themselves, ``head`` -> ``head``.

The transformer family maps the same way (dense kernels transposed,
``Embed.embedding`` as is, LayerNorm ``scale`` -> ``weight``, the
TransformerBlock parts of ``_LM_BLOCK_PARTS`` shared by all three).
Every leaf of the tree must be consumed and every leaf a module needs
must be present: a missing or an extra key is a ``ValueError`` naming
it.
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
    extra_top = sorted(set(variables) - {"params", "batch_stats"})
    if extra_top:
        raise ValueError(f"extra flax collections {extra_top} (expected params and batch_stats)")
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
            conv((name, f"Conv_{k}"), f"blocks.{i}.conv{k}")
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
