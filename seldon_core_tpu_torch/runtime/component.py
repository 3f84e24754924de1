"""User-facing component API.

``TPUComponent`` is the duck-typed contract a user model implements —
the same surface as the reference's ``SeldonComponent``
(reference: python/seldon_core/user_model.py:20-104): ``predict``,
``transform_input``, ``transform_output``, ``route``, ``aggregate``,
``send_feedback``, plus ``tags``/``metrics``/``class_names`` metadata
hooks and proto-level ``*_raw`` overrides, and the pickle-free state
hooks ``checkpoint_state()`` / ``restore_state(state)`` the persistence
subsystem calls (``utils/persistence.py``; the reference pickles the
whole object to Redis, reference: persistence.py:21-84).
Subclassing is optional; any object with the right methods works (duck
typing, like the reference).  The class keeps the JAX package's name so
that the two packages' components read alike; nothing in it is
TPU-specific.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Union

import numpy as np


class MicroserviceError(Exception):
    """Error carried back to the client as a FAILURE Status.

    Equivalent of the reference's SeldonMicroserviceException
    (reference: python/seldon_core/flask_utils.py).
    """

    status_code = 500

    def __init__(self, message: str, status_code: Optional[int] = None, reason: str = "MICROSERVICE_ERROR"):
        super().__init__(message)
        self.message = message
        if status_code is not None:
            self.status_code = status_code
        self.reason = reason

    def to_status(self) -> Dict[str, Any]:
        return {
            "status": "FAILURE",
            "code": self.status_code,
            "info": self.message,
            "reason": self.reason,
        }


class NotImplementedByUser(MicroserviceError):
    """Raised by default method bodies; dispatch treats it as 'fall through'."""

    status_code = 400


class TPUComponent:
    """Base class for models / routers / transformers / combiners."""

    # True for components whose caches are sized to the whole card, so a
    # second process on the card would run out of memory: the control
    # plane's hpa guard refuses subprocess replicas of them
    # (controlplane/deployer.py, C27)
    device_exclusive: bool = False

    def __init__(self, **kwargs: Any):
        pass

    # ---- lifecycle --------------------------------------------------------

    def load(self) -> None:
        """Heavy initialisation: download weights, compile, warm up."""

    # ---- metadata hooks ---------------------------------------------------

    def tags(self) -> Dict:
        raise NotImplementedByUser("tags not implemented")

    def metrics(self) -> List[Dict]:
        raise NotImplementedByUser("metrics not implemented")

    def class_names(self) -> Iterable[str]:
        raise NotImplementedByUser("class_names not implemented")

    def feature_names(self) -> Iterable[str]:
        raise NotImplementedByUser("feature_names not implemented")

    # ---- node-role methods ------------------------------------------------

    def predict(self, X: np.ndarray, names: Iterable[str], meta: Optional[Dict] = None):
        raise NotImplementedByUser("predict not implemented")

    def transform_input(self, X: np.ndarray, names: Iterable[str], meta: Optional[Dict] = None):
        raise NotImplementedByUser("transform_input not implemented")

    def transform_output(self, X: np.ndarray, names: Iterable[str], meta: Optional[Dict] = None):
        raise NotImplementedByUser("transform_output not implemented")

    def route(self, features: Union[np.ndarray, str, bytes], feature_names: Iterable[str]) -> int:
        raise NotImplementedByUser("route not implemented")

    def aggregate(self, features_list: List, feature_names_list: List):
        raise NotImplementedByUser("aggregate not implemented")

    def send_feedback(
        self,
        features: Union[np.ndarray, str, bytes],
        feature_names: Iterable[str],
        reward: float,
        truth,
        routing: Optional[int],
    ):
        raise NotImplementedByUser("send_feedback not implemented")

    # ---- state hooks (persistence subsystem) ------------------------------

    def checkpoint_state(self) -> Optional[Dict[str, Any]]:
        """Return a JSON/array tree snapshot of mutable state, or None."""
        return None

    def restore_state(self, state: Dict[str, Any]) -> None:
        pass

    # ---- custom serving surface (optional) --------------------------------

    def custom_routes(self) -> Dict[str, Any]:
        """Extra REST endpoints merged into the microservice app:
        ``{path: handler}`` where a handler is either an aiohttp
        handler (async, returns a Response) or a plain callable whose
        JSON-serialisable return value becomes the response body
        (reference: examples/models/mean_classifier_with_custom_endpoints)."""
        return {}


# ---------------------------------------------------------------------------
# duck-typed accessors (reference: user_model.py client_* helpers)
# ---------------------------------------------------------------------------

def _call_optional(user_model: Any, name: str, *args, **kwargs):
    fn = getattr(user_model, name, None)
    if fn is None:
        return None
    try:
        return fn(*args, **kwargs)
    except NotImplementedByUser:
        return None


def get_custom_tags(user_model: Any) -> Dict:
    return _call_optional(user_model, "tags") or {}


def get_custom_metrics(user_model: Any) -> Optional[List[Dict]]:
    metrics = _call_optional(user_model, "metrics")
    if metrics is None:
        return None
    if not validate_metrics(metrics):
        raise MicroserviceError(
            f"invalid metrics returned by component: {metrics!r}", status_code=500, reason="INVALID_METRICS"
        )
    return metrics


def get_class_names(user_model: Any) -> List[str]:
    names = _call_optional(user_model, "class_names")
    if names is not None:
        return list(names)
    return []


def get_feature_names(user_model: Any) -> List[str]:
    names = _call_optional(user_model, "feature_names")
    return list(names) if names is not None else []


# ---------------------------------------------------------------------------
# custom-metric helpers (reference: python/seldon_core/metrics.py:1-93)
# ---------------------------------------------------------------------------

COUNTER = "COUNTER"
GAUGE = "GAUGE"
TIMER = "TIMER"
_METRIC_TYPES = (COUNTER, GAUGE, TIMER)


def counter_metric(key: str, value: float = 1.0, tags: Optional[Dict[str, str]] = None) -> Dict:
    m = {"key": key, "type": COUNTER, "value": float(value)}
    if tags:
        m["tags"] = tags
    return m


def gauge_metric(key: str, value: float, tags: Optional[Dict[str, str]] = None) -> Dict:
    m = {"key": key, "type": GAUGE, "value": float(value)}
    if tags:
        m["tags"] = tags
    return m


def timer_metric(key: str, value_ms: float, tags: Optional[Dict[str, str]] = None) -> Dict:
    m = {"key": key, "type": TIMER, "value": float(value_ms)}
    if tags:
        m["tags"] = tags
    return m


def validate_metrics(metrics: Any) -> bool:
    if not isinstance(metrics, list):
        return False
    for m in metrics:
        if not isinstance(m, dict):
            return False
        if not {"key", "type", "value"} <= m.keys():
            return False
        if m["type"] not in _METRIC_TYPES:
            return False
        if not isinstance(m["value"], (int, float)) or isinstance(m["value"], bool):
            return False
    return True
