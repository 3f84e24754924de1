"""SKLearnServer — serve scikit-learn models (gated on sklearn).

Parity component for the reference's sklearnserver
(reference: servers/sklearnserver/sklearnserver/SKLearnServer.py:15-44):
download a joblib artifact from ``model_uri``, serve predict_proba
(falling back to predict).  Registered as SKLEARN_SERVER when sklearn
is importable (``engine/units.py``); the model runs on the host, as the
reference's does.
"""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np

import sklearn  # noqa: F401 — gate: ImportError skips registration
import joblib

from seldon_core_tpu_torch.runtime.component import MicroserviceError, TPUComponent


class SKLearnServer(TPUComponent):
    def __init__(self, model_uri: str = "", method: str = "predict_proba", **kwargs: Any):
        super().__init__(**kwargs)
        self.model_uri = model_uri
        self.method = method
        self.model = None

    def load(self) -> None:
        if self.model is not None:
            return
        if not self.model_uri:
            raise MicroserviceError("SKLearnServer needs a model_uri", status_code=400, reason="MISSING_MODEL_URI")
        from seldon_core_tpu_torch.utils import storage

        path = storage.download(self.model_uri)
        import os

        if os.path.isdir(path):
            candidates = [f for f in os.listdir(path) if f.endswith((".joblib", ".pkl"))]
            if not candidates:
                raise MicroserviceError(f"no joblib model under {path}", status_code=500, reason="BAD_MODEL")
            path = os.path.join(path, sorted(candidates)[0])
        self.model = joblib.load(path)

    def predict(self, X, names, meta=None):
        if self.model is None:
            self.load()
        X = np.asarray(X)
        if self.method == "predict_proba" and hasattr(self.model, "predict_proba"):
            return self.model.predict_proba(X)
        if self.method == "decision_function" and hasattr(self.model, "decision_function"):
            return self.model.decision_function(X)
        return self.model.predict(X)

    def class_names(self):
        classes = getattr(self.model, "classes_", None)
        return [str(c) for c in classes] if classes is not None else []
