"""XGBoostServer — serve xgboost models.

Parity component for the reference's xgboostserver
(reference: servers/xgboostserver/xgboostserver/XGBoostServer.py:10-26):
load a saved Booster from ``model_uri`` and serve predictions.

Two lanes, so the component runs where the xgboost package is absent
(the port's copy of the JAX package's server):

* **xgboost lane** — when the package imports, ``Booster.load_model``
  + ``DMatrix`` predict, exactly the reference's path;
* **fallback lane** — a pure-numpy evaluator of xgboost's documented
  JSON model format (``save_model("model.json")``: trees under
  ``learner.gradient_booster.model.trees`` with ``split_indices`` /
  ``split_conditions`` / ``left_children`` / ``right_children`` /
  ``default_left``; leaf values live in ``split_conditions`` at leaf
  nodes, ``left_children[nid] == -1`` marks a leaf).  Supports the
  two objectives the reference server configs use
  (``reg:squarederror``, ``binary:logistic``); anything else raises
  with a clear message rather than mis-predicting.

The same class registers as XGBOOST_SERVER either way.
"""

from __future__ import annotations

import json
import os
from typing import Any, List, Optional

import numpy as np

try:  # the real package wins when present
    import xgboost as _xgb
except ImportError:  # fallback lane serves JSON boosters
    _xgb = None

from seldon_core_tpu_torch.runtime.component import MicroserviceError, TPUComponent

# file names probed when model_uri is a directory (the reference mounts
# a directory and looks for a conventional booster file)
_BOOSTER_FILES = ("model.json", "model.bst", "model.bin", "model.ubj")


class _MiniBooster:
    """Evaluate an xgboost JSON model with numpy only.

    Traversal: start at node 0; at internal node ``n`` route left when
    ``x[split_indices[n]] < split_conditions[n]`` (missing values follow
    ``default_left``), until ``left_children[n] == -1``; the leaf's
    ``split_conditions`` entry is its value.  Prediction = base_score
    margin + sum of leaf values over trees, then the objective's
    activation.
    """

    def __init__(self, spec: dict):
        learner = spec["learner"]
        base_score = float(learner["learner_model_param"]["base_score"])
        self.objective = learner["objective"]["name"]
        if self.objective not in ("reg:squarederror", "binary:logistic"):
            raise MicroserviceError(
                f"fallback booster evaluator supports reg:squarederror and "
                f"binary:logistic, model declares {self.objective!r} — "
                "install xgboost for other objectives",
                status_code=400,
                reason="UNSUPPORTED_OBJECTIVE",
            )
        if self.objective == "binary:logistic":
            # xgboost stores base_score in PROBABILITY space for
            # logistic objectives and applies logit(base_score) to the
            # margin (prediction = sigmoid(logit(bs) + sum(leaves)));
            # adding the raw probability would silently shift every
            # prediction (default bs=0.5 -> logit 0, not +0.5)
            if not 0.0 < base_score < 1.0:
                raise MicroserviceError(
                    f"binary:logistic base_score must lie in (0, 1), "
                    f"got {base_score}",
                    status_code=400,
                    reason="BAD_MODEL",
                )
            self.base_margin = float(np.log(base_score / (1.0 - base_score)))
        else:
            self.base_margin = base_score
        self.trees: List[dict] = []
        for tree in learner["gradient_booster"]["model"]["trees"]:
            self.trees.append({
                "left": np.asarray(tree["left_children"], np.int64),
                "right": np.asarray(tree["right_children"], np.int64),
                "feat": np.asarray(tree["split_indices"], np.int64),
                "cond": np.asarray(tree["split_conditions"], np.float64),
                "default_left": np.asarray(tree["default_left"], bool),
            })

    def predict(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, np.float64)
        margin = np.full(len(X), self.base_margin)
        for t in self.trees:
            node = np.zeros(len(X), np.int64)
            # vectorised level stepping, bounded: any FINITE tree routes
            # every row to a leaf within node-count levels, so a longer
            # walk means cyclic/malformed children — raise instead of
            # wedging the serving thread in an unbounded loop
            for _ in range(len(t["left"])):
                internal = t["left"][node] != -1
                if not internal.any():
                    break
                feat = t["feat"][node]
                x = X[np.arange(len(X)), feat]
                missing = np.isnan(x)
                go_left = np.where(
                    missing, t["default_left"][node], x < t["cond"][node]
                )
                nxt = np.where(go_left, t["left"][node], t["right"][node])
                node = np.where(internal, nxt, node)
            else:
                raise MicroserviceError(
                    "malformed tree: traversal did not reach a leaf within "
                    "node-count levels (cyclic children?)",
                    status_code=400,
                    reason="BAD_MODEL",
                )
            margin += t["cond"][node]
        if self.objective == "binary:logistic":
            return 1.0 / (1.0 + np.exp(-margin))
        return margin


class XGBoostServer(TPUComponent):
    def __init__(self, model_uri: str = "", **kwargs: Any):
        super().__init__(**kwargs)
        self.model_uri = model_uri
        self.booster: Optional[Any] = None
        self._mini: Optional[_MiniBooster] = None

    @staticmethod
    def _resolve_file(path: str) -> str:
        if os.path.isdir(path):
            for name in _BOOSTER_FILES:
                cand = os.path.join(path, name)
                if os.path.exists(cand):
                    return cand
            raise MicroserviceError(
                f"no booster file ({'/'.join(_BOOSTER_FILES)}) in {path}",
                status_code=400,
                reason="MISSING_MODEL_FILE",
            )
        return path

    def load(self) -> None:
        if self.booster is not None or self._mini is not None:
            return
        if not self.model_uri:
            raise MicroserviceError(
                "XGBoostServer needs a model_uri", status_code=400,
                reason="MISSING_MODEL_URI",
            )
        from seldon_core_tpu_torch.utils import storage

        path = self._resolve_file(storage.download(self.model_uri))
        if _xgb is not None:
            self.booster = _xgb.Booster()
            self.booster.load_model(path)
            return
        if not path.endswith(".json"):
            raise MicroserviceError(
                "without the xgboost package only JSON boosters "
                f"(save_model('model.json')) are servable, got {path}",
                status_code=400,
                reason="NEEDS_XGBOOST",
            )
        with open(path) as f:
            self._mini = _MiniBooster(json.load(f))

    def predict(self, X, names, meta=None):
        if self.booster is None and self._mini is None:
            self.load()
        if self.booster is not None:
            dmat = _xgb.DMatrix(
                np.asarray(X, dtype=np.float32), feature_names=list(names) or None
            )
            return self.booster.predict(dmat)
        return self._mini.predict(X)
