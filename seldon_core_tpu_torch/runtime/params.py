"""Typed per-node parameter parsing.

The control plane passes each graph node a list of typed parameters
(name/value/type) which become constructor kwargs for the user class —
the same contract as the reference's ``PREDICTIVE_UNIT_PARAMETERS`` env
var (reference: python/seldon_core/microservice.py:50-96) and the
engine-side mirror (reference: PredictiveUnitState.java:100-113).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List

PARAMETERS_ENV_NAME = "PREDICTIVE_UNIT_PARAMETERS"
SERVICE_PORT_ENV_NAME = "PREDICTIVE_UNIT_SERVICE_PORT"
UNIT_ID_ENV_NAME = "PREDICTIVE_UNIT_ID"

_TYPE_PARSERS = {
    "STRING": str,
    "INT": int,
    "FLOAT": float,
    "DOUBLE": float,
    "BOOL": lambda v: str(v).lower() in ("1", "true", "yes"),
    "JSON": lambda v: json.loads(v) if isinstance(v, str) else v,
}


class ParameterError(ValueError):
    pass


def parse_parameters(parameters: List[Dict[str, Any]]) -> Dict[str, Any]:
    """[{"name": n, "value": v, "type": t}, ...] -> constructor kwargs."""
    kwargs: Dict[str, Any] = {}
    for p in parameters or []:
        if "name" not in p:
            raise ParameterError(f"parameter missing 'name': {p!r}")
        ptype = str(p.get("type", "STRING")).upper()
        parser = _TYPE_PARSERS.get(ptype)
        if parser is None:
            raise ParameterError(f"unknown parameter type {ptype!r} for {p['name']!r}")
        try:
            kwargs[p["name"]] = parser(p.get("value"))
        except (TypeError, ValueError, json.JSONDecodeError) as e:
            raise ParameterError(f"cannot parse parameter {p['name']!r}: {e}") from e
    return kwargs


def parameters_from_env(environ: Dict[str, str] = None) -> Dict[str, Any]:
    environ = environ if environ is not None else os.environ
    raw = environ.get(PARAMETERS_ENV_NAME, "[]")
    try:
        parsed = json.loads(raw)
    except json.JSONDecodeError as e:
        raise ParameterError(f"{PARAMETERS_ENV_NAME} is not valid JSON: {e}") from e
    return parse_parameters(parsed)
