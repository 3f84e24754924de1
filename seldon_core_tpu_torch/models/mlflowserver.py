"""MLFlowServer — serve MLflow model directories.

Parity component for the reference's mlflowserver
(reference: servers/mlflowserver/mlflowserver/MLFlowServer.py):
download an MLflow model directory from ``model_uri`` and serve its
pyfunc predict.

Two lanes, so the component runs where the mlflow package is absent
(the port's copy of the JAX package's server):

* **mlflow lane** — ``mlflow.pyfunc.load_model`` when the package
  imports, exactly the reference's path;
* **fallback lane** — parse the ``MLmodel`` YAML ourselves and serve
  the flavors whose runtimes need no mlflow: ``sklearn`` (the
  reference's canonical mlflowserver demo is an sklearn elasticnet —
  servers/mlflowserver/; joblib/pickle formats both load via joblib)
  and ``python_function`` with ``loader_module: mlflow.sklearn``.
  Other flavors raise with a clear message.

The same class registers as MLFLOW_SERVER either way.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np

try:  # the real package wins when present
    import mlflow.pyfunc as _pyfunc
except ImportError:  # fallback lane parses MLmodel directly
    _pyfunc = None

from seldon_core_tpu_torch.runtime.component import MicroserviceError, TPUComponent


class _MiniPyfunc:
    """Load an MLmodel directory's sklearn flavor without mlflow."""

    def __init__(self, path: str):
        try:
            # not declared dependencies of this package: a clean install
            # without them must fail with an actionable serving error,
            # not a raw ImportError from the data plane
            import yaml
        except ImportError as e:
            raise MicroserviceError(
                "the mlflow fallback lane needs pyyaml to parse the MLmodel "
                "file — pip install pyyaml (or install mlflow itself for "
                f"the full lane): {e}",
                status_code=500,
                reason="MISSING_DEPENDENCY",
            ) from None

        mlmodel = os.path.join(path, "MLmodel")
        if not os.path.exists(mlmodel):
            raise MicroserviceError(
                f"{path} is not an MLflow model directory (no MLmodel file)",
                status_code=400,
                reason="BAD_MODEL_DIR",
            )
        with open(mlmodel) as f:
            spec = yaml.safe_load(f) or {}
        flavors = spec.get("flavors") or {}
        rel = None
        if "sklearn" in flavors:
            rel = flavors["sklearn"].get("pickled_model", "model.pkl")
        elif flavors.get("python_function", {}).get("loader_module") == "mlflow.sklearn":
            rel = flavors["python_function"].get("model_path", "model.pkl")
        if rel is None:
            raise MicroserviceError(
                "without the mlflow package only the sklearn flavor is "
                f"servable; MLmodel declares {sorted(flavors)}",
                status_code=400,
                reason="NEEDS_MLFLOW",
            )
        try:
            import joblib
        except ImportError as e:
            raise MicroserviceError(
                "the mlflow fallback lane needs joblib to load the sklearn "
                "flavor — pip install joblib (or install mlflow itself for "
                f"the full lane): {e}",
                status_code=500,
                reason="MISSING_DEPENDENCY",
            ) from None

        self.model = joblib.load(os.path.join(path, rel))

    def predict(self, X: np.ndarray) -> np.ndarray:
        return np.asarray(self.model.predict(np.asarray(X)))


class MLFlowServer(TPUComponent):
    def __init__(self, model_uri: str = "", **kwargs: Any):
        super().__init__(**kwargs)
        self.model_uri = model_uri
        self.model: Optional[Any] = None

    def load(self) -> None:
        if self.model is not None:
            return
        if not self.model_uri:
            raise MicroserviceError(
                "MLFlowServer needs a model_uri", status_code=400,
                reason="MISSING_MODEL_URI",
            )
        from seldon_core_tpu_torch.utils import storage

        path = storage.download(self.model_uri)
        if _pyfunc is not None:
            self.model = _pyfunc.load_model(path)
        else:
            self.model = _MiniPyfunc(path)

    def predict(self, X, names, meta=None):
        if self.model is None:
            self.load()
        return np.asarray(self.model.predict(np.asarray(X)))
