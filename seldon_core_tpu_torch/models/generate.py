"""Generation helpers shared by the port's generation components.

The counterpart of part of ``seldon_core_tpu/models/generate.py``: the
prompt bucket ladder and the LM parameter loader.  ``Generator`` and
``GenerativeLM`` (rectangular, non-paged generation) come with a later
slice.
"""

from __future__ import annotations

from typing import Dict, List

import torch


def _buckets_for(max_len: int) -> List[int]:
    """Prompt length buckets: 16, 32, ... doubling below ``max_len``, then
    ``max_len`` itself (one prefill shape per bucket)."""
    out, b = [], 16
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return out


def load_lm_params(model_uri: str, config: Dict[str, int], seed: int,
                   device: torch.device = torch.device("cpu")) -> Dict[str, torch.Tensor]:
    """A ``TransformerLM`` state_dict (float32, on ``device``): flax's
    default init drawn from a ``torch.Generator`` seeded with ``seed``;
    with ``model_uri``, the flax msgpack checkpoint there (fetched by
    ``utils/storage.py``) restored onto that seeded tree as a template,
    as the JAX package's loader does, then converted by
    ``lm_params_from_flax``.

    ``config`` holds vocab_size, d_model, num_layers, num_heads and
    max_len."""
    from seldon_core_tpu_torch.models.transformer import TransformerLM

    lm = TransformerLM(dtype=torch.float32, **config)
    lm.reset_parameters(torch.Generator().manual_seed(int(seed)))
    state = lm.state_dict()
    if model_uri:
        from seldon_core_tpu_torch.models import convert
        from seldon_core_tpu_torch.utils import serialization, storage

        with open(storage.download(model_uri), "rb") as f:
            params = serialization.from_bytes(convert.lm_flax_params(state), f.read())
        state = convert.lm_params_from_flax(serialization.to_numpy_tree(params))
    return {k: v.to(device) for k, v in state.items()}
