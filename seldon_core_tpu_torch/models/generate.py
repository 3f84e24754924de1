"""Generation helpers shared by the port's generation components.

The counterpart of part of ``seldon_core_tpu/models/generate.py``: the
prompt bucket ladder and the LM parameter loader.  ``Generator`` and
``GenerativeLM`` (rectangular, non-paged generation) come with a later
slice.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from seldon_core_tpu_torch.runtime.component import MicroserviceError


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
    default init drawn from a ``torch.Generator`` seeded with ``seed``.

    ``config`` holds vocab_size, d_model, num_layers, num_heads and
    max_len.  Checkpoints (``model_uri``) are not read yet."""
    if model_uri:
        raise MicroserviceError(
            f"model_uri={model_uri!r}: checkpoint loading is not ported yet "
            "(ROADMAP.md §A item 5, model_uri loading without flax); serve seeded weights "
            "or pass a state_dict to PagedEngine",
            status_code=400,
            reason="BAD_PARAMETER",
        )
    from seldon_core_tpu_torch.models.transformer import TransformerLM

    lm = TransformerLM(dtype=torch.float32, **config)
    lm.reset_parameters(torch.Generator().manual_seed(int(seed)))
    return {k: v.to(device) for k, v in lm.state_dict().items()}
