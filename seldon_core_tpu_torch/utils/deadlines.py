"""Per-request carriers read at ingress: the LoRA adapter selection.

The port's counterpart of the adapter part of
``seldon_core_tpu/utils/deadlines.py``: the ``X-Seldon-Adapter`` header
and the ``meta.tags.adapter`` body tag name the weight set a generation
request decodes with, and both normalise through one rule, so the two
carriers always resolve one adapter to one table key.  End-to-end
deadlines and priorities come with the SLO slice (``ROADMAP.md`` §A
item 8.5).
"""

from __future__ import annotations

from typing import Any, Optional

ADAPTER_HEADER = "x-seldon-adapter"


def _carrier_get(carrier: Any, key: str) -> Optional[str]:
    """Case-insensitive lookup over dicts, header multidicts and (key,
    value) tuple lists."""
    if carrier is None:
        return None
    getter = getattr(carrier, "get", None)
    if getter is not None:
        val = getter(key)
        if val is None:
            val = getter(key.title())  # plain dicts keyed X-Seldon-Adapter
        if val is not None:
            return str(val)
    try:
        items = carrier.items() if hasattr(carrier, "items") else carrier
        for k, v in items:
            if str(k).lower() == key:
                return str(v)
    except (TypeError, ValueError):
        return None
    return None


def normalize_adapter(raw: Any) -> Optional[str]:
    """The one normalisation rule for adapter names from any carrier:
    strip, empty -> None, clamp to 256 characters (the name keys the
    registry and engine tables, and an unauthenticated wire must not
    grow them with megabyte keys)."""
    if raw is None:
        return None
    raw = str(raw).strip()
    return raw[:256] if raw else None


def extract_adapter(carrier: Any) -> Optional[str]:
    """The adapter name a carrier declares (the ``X-Seldon-Adapter``
    header), or None."""
    return normalize_adapter(_carrier_get(carrier, ADAPTER_HEADER))
