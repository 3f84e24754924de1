"""Model explainers.

The reference deploys a *separate* alibi explainer container per
predictor, reached via an ``:explain`` URL
(reference: operator/controllers/seldondeployment_explainers.go:33-196,
client explain_predict_gateway seldon_client.py:1542).  Here, as in the
JAX package, the explainer shares the predictor's process and its
device-resident weights: ``PredictorService(explainer=...)`` answers the
gateway's ``POST /api/v0.1/explanations``.

* ``IntegratedGradientsExplainer`` — path-integrated gradients for a
  ``CudaServer``'s module (white-box, exact, on the card).
* ``PermutationExplainer`` — model-agnostic per-feature importance by
  column permutation (works for any component).
* ``KernelShapExplainer`` — model-agnostic Shapley values via the
  KernelSHAP weighted regression (the estimator behind the reference's
  alibi KernelShap explainer option): every sampled coalition is one row
  of ONE batched predict; the weighted least squares is a tiny
  (M−1)² host-side float64 solve, factored once per call.  With few
  features all coalitions are enumerated, making the values exact.
* ``AnchorsExplainer`` — alibi's AnchorTabular, the reference's default
  explainer container (operator/controllers/seldondeployment_explainers.go:57-59):
  an *anchor* is a minimal rule of feature predicates under which the
  model's prediction (almost) never changes.  Every candidate rule of a
  beam round is estimated from perturbation rows stacked into ONE
  batched predict.

The three black-box explainers are the JAX package's numpy code over
``model.predict``, seeded alike, so a seed gives the JAX package's
answers for the same model outputs.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from seldon_core_tpu_torch.runtime.component import MicroserviceError, TPUComponent


# held while an explanation runs with cuDNN's algorithms pinned (process-wide flags)
_PINNED_ALGORITHMS = threading.Lock()


class IntegratedGradientsExplainer(TPUComponent):
    """Integrated gradients along the straight path from a baseline.

    attribution_j = (x_j - b_j) * mean_k d f_target / d x_j evaluated at
    b + (k/m)(x - b), with the target the row's argmax logit.  ``model``
    is a ``CudaServer`` (anything with ``.module`` and ``.input_shape``);
    its module runs in eval mode, so the rows of a batch are independent
    and one backward of the summed target logits over a row's ``steps``
    path points gives every point's gradient.  Each row is one forward
    and one backward of ``steps`` points on the model's device.

    The convolutions run cuDNN's deterministic algorithms with its
    autotuner off for the call (``deterministic_cudnn``; the flags are the
    process's, so explanations hold one lock and a predict beside one runs
    so too): in bfloat16 the algorithm the autotuner picks moves ResNet-50's
    attributions by ~5% relative L2 (``python -m
    seldon_core_tpu_torch.tools.probe_ig``), so an explanation repeats only
    with the algorithms pinned.
    """

    def __init__(
        self,
        model: Any = None,  # a CudaServer (or anything with .module/.input_shape)
        steps: int = 16,
        baseline: str = "zeros",  # zeros | mean
        **kwargs: Any,
    ):
        super().__init__(**kwargs)
        self.model = model
        self.steps = int(steps)
        self.baseline = baseline

    def attach(self, model: Any) -> None:
        self.model = model

    def load(self) -> None:
        if self.model is None:
            raise MicroserviceError("IntegratedGradientsExplainer needs a model to attach to", status_code=400,
                                    reason="NO_MODEL")
        if getattr(self.model, "module", None) is None and hasattr(self.model, "load"):
            self.model.load()
        if getattr(self.model, "_qparams", None):
            raise MicroserviceError("integrated gradients needs a float model; this one rests its kernels int8",
                                    status_code=400, reason="BAD_MODEL")

    def _explain_row(self, module: torch.nn.Module, x: torch.Tensor, baseline: torch.Tensor):
        with torch.no_grad():
            logits = module(x[None]).float()[0]
        target = int(torch.argmax(logits))
        alphas = torch.linspace(1.0 / self.steps, 1.0, self.steps, device=x.device)
        alphas = alphas.reshape(-1, *([1] * x.dim()))
        points = (baseline + alphas * (x - baseline)).detach().requires_grad_(True)
        with torch.enable_grad():
            out = module(points)
            (grads,) = torch.autograd.grad(out[:, target].float().sum(), points)
        attribution = (x - baseline) * grads.float().mean(dim=0)
        return attribution, target, float(logits[target])

    def explain(self, X, names=None) -> Dict[str, Any]:
        if getattr(self.model, "module", None) is None:
            self.load()
        module = self.model.module
        device = next(module.parameters()).device
        X = np.asarray(X, dtype=np.float32)
        if X.ndim == len(self.model.input_shape):
            X = X[None]
        x = torch.from_numpy(X).to(device)
        baseline = torch.zeros(X.shape[1:], dtype=torch.float32, device=device)
        if self.baseline == "mean":
            baseline = x.mean(dim=0)
        from seldon_core_tpu_torch.models.cudaserver import deterministic_cudnn

        with _PINNED_ALGORITHMS, deterministic_cudnn():
            rows = [self._explain_row(module, x[i], baseline) for i in range(x.shape[0])]
        return {
            "method": "integrated_gradients",
            "attributions": torch.stack([r[0] for r in rows]).double().cpu().numpy().tolist(),
            "targets": [r[1] for r in rows],
            "scores": [r[2] for r in rows],
            "names": list(names or []),
        }

    # deployable as a MODEL node: predict returns attributions
    def predict(self, X, names, meta=None):
        return np.asarray(self.explain(X, names)["attributions"])


class PermutationExplainer(TPUComponent):
    """Per-feature importance by column permutation (black-box).

    importance_j = mean |f(X) - f(X with column j shuffled)| — model
    agnostic, needs only the component's predict.
    """

    def __init__(self, model: Any = None, n_repeats: int = 4, seed: int = 0, **kwargs: Any):
        super().__init__(**kwargs)
        self.model = model
        self.n_repeats = int(n_repeats)
        self._rng = np.random.default_rng(seed)

    def attach(self, model: Any) -> None:
        self.model = model

    def explain(self, X, names=None) -> Dict[str, Any]:
        if self.model is None:
            raise MicroserviceError("PermutationExplainer needs a model", status_code=400, reason="NO_MODEL")
        X = np.atleast_2d(np.asarray(X, dtype=np.float64))
        base = np.asarray(self.model.predict(X, list(names or [])))
        n_features = X.shape[1]
        importances = np.zeros(n_features)
        for j in range(n_features):
            deltas = []
            for _ in range(self.n_repeats):
                Xp = X.copy()
                self._rng.shuffle(Xp[:, j])
                out = np.asarray(self.model.predict(Xp, list(names or [])))
                deltas.append(np.abs(base - out).mean())
            importances[j] = float(np.mean(deltas))
        return {
            "method": "permutation_importance",
            "importances": importances.tolist(),
            "names": list(names or []),
        }

    def predict(self, X, names, meta=None):
        return np.asarray(self.explain(X, names)["importances"])[None, :]


class KernelShapExplainer(TPUComponent):
    """Shapley values by KernelSHAP weighted regression (black-box).

    For instance ``x`` with baseline ``b``, coalition ``z ∈ {0,1}^M``
    maps to the masked input ``z·x + (1−z)·b``; the model is evaluated
    on ALL coalitions in one batched predict, then attributions solve
    the Shapley-kernel-weighted least squares (host-side float64,
    factored once per call) with the efficiency constraint
    ``Σφ = f(x) − f(b)`` enforced by substitution.

    When ``2^M − 2 <= n_samples`` every coalition is enumerated and the
    result is the exact Shapley value; otherwise coalitions are sampled
    in complement pairs, sizes drawn ∝ (M−1)/(s(M−s)) (the kernel's
    size profile, so the regression weights stay uniform).

    ``baseline``: "zeros", "mean" (column means of the explained batch),
    or pass ``background`` — rows of reference data whose column means
    become the baseline (what "mean" should be for single-instance
    explain calls).
    """

    def __init__(
        self,
        model: Any = None,
        n_samples: int = 256,
        baseline: str = "zeros",  # zeros | mean
        background: Optional[Any] = None,  # reference rows (list or array)
        seed: int = 0,
        ridge: float = 1e-6,
        **kwargs: Any,
    ):
        super().__init__(**kwargs)
        self.model = model
        self.n_samples = int(n_samples)
        if self.n_samples < 4:
            raise MicroserviceError(
                "kernel SHAP needs n_samples >= 4 (got "
                f"{self.n_samples}) — fewer coalitions cannot support the regression",
                status_code=400,
                reason="BAD_REQUEST",
            )
        self.baseline = baseline
        self.background = None if background is None else np.atleast_2d(np.asarray(background, np.float64))
        self.seed = int(seed)
        self.ridge = float(ridge)

    def attach(self, model: Any) -> None:
        self.model = model

    # ---- coalition design -------------------------------------------------

    def _coalitions(self, m: int, rng: np.random.Generator) -> tuple:
        """(Z, w): coalition matrix (S, m) with 0 < |z| < m, and WLS
        weights.  Exact enumeration when it fits the sample budget."""
        total = 2**m - 2
        if total <= self.n_samples:
            Z = np.array(
                [[(i >> j) & 1 for j in range(m)] for i in range(1, 2**m - 1)],
                dtype=np.float64,
            )
            sizes = Z.sum(axis=1)
            # Shapley kernel: (m-1) / (C(m,s) * s * (m-s))
            from math import comb

            w = (m - 1) / (np.array([comb(m, int(s)) for s in sizes]) * sizes * (m - sizes))
            return Z, w
        # paired sampling; drawing sizes from the kernel's size profile
        # leaves uniform regression weights (importance sampling)
        sizes = np.arange(1, m)
        p = (m - 1) / (sizes * (m - sizes))
        p = p / p.sum()
        n_pairs = self.n_samples // 2
        draw = rng.choice(sizes, size=n_pairs, p=p)
        Z = np.zeros((2 * n_pairs, m))
        for i, s in enumerate(draw):
            idx = rng.choice(m, size=int(s), replace=False)
            Z[2 * i, idx] = 1.0
            Z[2 * i + 1] = 1.0 - Z[2 * i]  # complement pair
        return Z, np.ones(len(Z))

    # ---- the solve --------------------------------------------------------

    def _baseline(self, X: np.ndarray) -> np.ndarray:
        m = X.shape[1]
        if self.background is not None:
            if self.background.shape[1] != m:
                raise MicroserviceError(
                    f"background has {self.background.shape[1]} features, request has {m}",
                    status_code=400,
                    reason="BAD_REQUEST",
                )
            return self.background.mean(axis=0)
        if self.baseline == "mean":
            if len(X) < 2:
                raise MicroserviceError(
                    "baseline='mean' over a single instance collapses to the "
                    "instance itself (all-zero attributions); pass reference "
                    "rows via 'background' or explain a batch",
                    status_code=400,
                    reason="BAD_REQUEST",
                )
            return X.mean(axis=0)
        return np.zeros(m)

    def explain(self, X, names=None) -> Dict[str, Any]:
        if self.model is None:
            raise MicroserviceError("KernelShapExplainer needs a model", status_code=400, reason="NO_MODEL")
        X = np.atleast_2d(np.asarray(X, dtype=np.float64))
        n_rows, m = X.shape
        if m < 2:
            raise MicroserviceError(
                "kernel SHAP needs at least 2 features", status_code=400, reason="BAD_REQUEST"
            )
        rng = np.random.default_rng(self.seed)
        b = self._baseline(X)
        Z, w = self._coalitions(m, rng)

        # the weighted normal equations share Z/w across every row:
        # factor once (float64 on host — the system is (m-1)^2 tiny;
        # the device's job is the batched coalition forwards, not this)
        A = Z[:, :-1] - Z[:, -1:]  # (S, m-1)
        AtW = A.T * w[None, :]
        lhs = AtW @ A + self.ridge * np.eye(m - 1)

        names = list(names or [])
        targets: List[int] = []
        base_values: List[float] = []
        rhs_cols: List[np.ndarray] = []
        fx_fb: List[tuple] = []
        for x in X:
            # ONE batched predict: [x, b, every masked coalition]
            masked = Z * x[None, :] + (1.0 - Z) * b[None, :]
            batch = np.concatenate([x[None], b[None], masked], axis=0)
            out = np.asarray(self.model.predict(batch, names))
            if out.ndim == 1:
                out = out[:, None]
            target = int(np.argmax(out[0]))
            fx, fb = float(out[0, target]), float(out[1, target])
            y = out[2:, target].astype(np.float64)
            rhs_cols.append(AtW @ (y - fb - Z[:, -1] * (fx - fb)))
            fx_fb.append((fx, fb))
            targets.append(target)
            base_values.append(fb)
        # one multi-RHS solve for the whole batch; efficiency constraint
        # Σφ = fx − fb substituted out (phi_last = (fx−fb) − Σ others)
        phi_head = np.linalg.solve(lhs, np.stack(rhs_cols, axis=1))  # (m-1, n)
        attributions = [
            np.append(phi_head[:, i], (fx - fb) - phi_head[:, i].sum()).tolist()
            for i, (fx, fb) in enumerate(fx_fb)
        ]
        return {
            "method": "kernel_shap",
            "attributions": attributions,
            "targets": targets,
            "base_values": base_values,
            "names": names,
        }

    def predict(self, X, names, meta=None):
        return np.asarray(self.explain(X, names)["attributions"])


class AnchorsExplainer(TPUComponent):
    """Tabular anchors: minimal high-precision rules (black-box).

    For instance ``x`` with model decision ``t = argmax f(x)``, find
    the smallest predicate set ``A`` (each predicate: "feature j falls
    in x's quantile bin") whose precision
    ``P(argmax f(z) = t | z ⊨ A) ≥ precision_threshold``, where ``z``
    is a background row with the anchored features resampled from the
    bin x occupies.  Greedy beam search over anchor size; every
    candidate of a round is estimated from ``n_samples`` perturbation
    rows, all candidates stacked into ONE batched predict (the same
    device-friendly evaluation shape as KernelShapExplainer — the
    model call count is the round count, not the candidate count).

    ``background`` rows are required (they define both the quantile
    grid and the perturbation distribution — alibi's AnchorTabular
    requires training data for the same reason).  Coverage is the
    fraction of background rows satisfying the rule.

    Result per row: the predicate list (feature index, human-readable
    predicate string, bin bounds), measured precision, coverage, and
    whether the threshold was reached (``raw_precision`` of the best
    effort is reported either way — a model with no compact anchor is
    an honest outcome, not an error).
    """

    def __init__(
        self,
        model: Any = None,
        background: Optional[Any] = None,  # reference rows (list or array)
        n_bins: int = 4,
        precision_threshold: float = 0.95,
        n_samples: int = 128,
        beam_size: int = 2,
        max_anchor_size: Optional[int] = None,
        seed: int = 0,
        **kwargs: Any,
    ):
        super().__init__(**kwargs)
        self.model = model
        self.background = (
            None if background is None
            else np.atleast_2d(np.asarray(background, np.float64))
        )
        self.n_bins = int(n_bins)
        if self.n_bins < 2:
            raise MicroserviceError(
                "anchors needs n_bins >= 2", status_code=400, reason="BAD_REQUEST"
            )
        self.precision_threshold = float(precision_threshold)
        self.n_samples = int(n_samples)
        self.beam_size = int(beam_size)
        self.max_anchor_size = max_anchor_size
        self.seed = int(seed)
        self._edges: Optional[np.ndarray] = None  # (m, n_bins-1) quantile edges

    def attach(self, model: Any) -> None:
        self.model = model

    # ---- discretisation ---------------------------------------------------

    def _fit_edges(self, m: int) -> np.ndarray:
        if self.background is None:
            raise MicroserviceError(
                "AnchorsExplainer needs 'background' rows (they define the "
                "quantile grid and the perturbation distribution)",
                status_code=400,
                reason="BAD_REQUEST",
            )
        if self.background.shape[1] != m:
            raise MicroserviceError(
                f"background has {self.background.shape[1]} features, request has {m}",
                status_code=400,
                reason="BAD_REQUEST",
            )
        qs = np.linspace(0, 1, self.n_bins + 1)[1:-1]
        return np.quantile(self.background, qs, axis=0).T  # (m, n_bins-1)

    def _bins_of(self, rows: np.ndarray) -> np.ndarray:
        """Bin index per (row, feature) against the fitted edges."""
        out = np.zeros(rows.shape, np.int64)
        for j in range(rows.shape[1]):
            out[:, j] = np.searchsorted(self._edges[j], rows[:, j], side="right")
        return out

    def _predicate_str(self, j: int, b: int, names: List[str]) -> str:
        name = names[j] if j < len(names) else f"f{j}"
        edges = self._edges[j]
        lo = None if b == 0 else edges[b - 1]
        hi = None if b >= len(edges) else edges[b]
        if lo is None:
            return f"{name} <= {hi:.6g}"
        if hi is None:
            return f"{name} > {lo:.6g}"
        return f"{lo:.6g} < {name} <= {hi:.6g}"

    # ---- search -----------------------------------------------------------

    @staticmethod
    def _labels(preds: np.ndarray) -> np.ndarray:
        """Model outputs -> decision labels.  Multi-column outputs are
        argmax'd; a SINGLE column is treated as a binary PROBABILITY in
        [0, 1] and thresholded at 0.5 (e.g. the xgboost
        binary:logistic fallback returns (N,) probabilities).  Without
        this, a 1-wide output argmaxes to class 0 for every row and
        EVERY rule reads precision 1.0 — an arbitrary anchor reported
        as a perfect explanation.  NOTE: a raw-MARGIN single column
        (decision boundary 0, not 0.5) must be wrapped to probabilities
        (or two columns) before anchoring — the explainer cannot guess
        an arbitrary score's boundary."""
        p = np.asarray(preds)
        if p.ndim == 1:
            p = p[:, None]
        if p.shape[1] == 1:
            return (p[:, 0] > 0.5).astype(np.int64)
        return np.argmax(p, axis=1)

    def _perturb(
        self, x: np.ndarray, anchor: tuple, x_bins: np.ndarray,
        bg_bins: np.ndarray, rng: np.random.Generator,
    ) -> np.ndarray:
        """``n_samples`` background rows with anchored features redrawn
        from x's bin (falling back to x's own value when the background
        has no row in that bin — the predicate still holds)."""
        bg = self.background
        idx = rng.integers(0, len(bg), size=self.n_samples)
        Z = bg[idx].copy()
        for j in anchor:
            pool = bg[bg_bins[:, j] == x_bins[j], j]
            if len(pool):
                Z[:, j] = rng.choice(pool, size=self.n_samples, replace=True)
            else:
                Z[:, j] = x[j]
        return Z

    def _explain_row(
        self, x: np.ndarray, names: List[str], bg_bins: np.ndarray,
        rng: np.random.Generator,
    ) -> Dict[str, Any]:
        m = len(x)
        x_bins = self._bins_of(x[None])[0]
        target = int(self._labels(
            np.asarray(self.model.predict(x[None], names)).reshape(1, -1)
        )[0])
        max_size = min(self.max_anchor_size or m, m)

        def coverage(anchor: tuple) -> float:
            sat = np.ones(len(bg_bins), bool)
            for j in anchor:
                sat &= bg_bins[:, j] == x_bins[j]
            return float(sat.mean())

        beam: List[tuple] = [()]
        best: Dict[str, Any] = {"anchor": (), "precision": 0.0, "coverage": 1.0}
        seen: set = set()
        for _size in range(1, max_size + 1):
            # candidates: every beam rule extended by one unused feature
            cands = []
            for a in beam:
                for j in range(m):
                    if j in a:
                        continue
                    c = tuple(sorted(a + (j,)))
                    if c not in seen:
                        seen.add(c)
                        cands.append(c)
            if not cands:
                break
            # ONE batched predict for the whole round: every candidate's
            # n_samples perturbation rows, stacked
            Zs = [
                self._perturb(x, c, x_bins, bg_bins, rng) for c in cands
            ]
            batch = np.concatenate(Zs, axis=0)
            labels = self._labels(np.asarray(self.model.predict(batch, names)))
            precisions = [
                float((labels[i * self.n_samples:(i + 1) * self.n_samples] == target).mean())
                for i in range(len(cands))
            ]
            # rank by precision, ties by coverage (broader rules win)
            order = sorted(
                range(len(cands)),
                key=lambda i: (-precisions[i], -coverage(cands[i])),
            )
            top = order[0]
            if precisions[top] > best["precision"] or (
                precisions[top] == best["precision"] and not best["anchor"]
            ):
                best = {
                    "anchor": cands[top],
                    "precision": precisions[top],
                    "coverage": coverage(cands[top]),
                }
            if precisions[top] >= self.precision_threshold:
                break
            beam = [cands[i] for i in order[: self.beam_size]]
        anchor = best["anchor"]
        return {
            "features": list(anchor),
            "predicates": [
                self._predicate_str(j, int(x_bins[j]), names) for j in anchor
            ],
            "precision": best["precision"],
            "coverage": best["coverage"],
            "met_threshold": best["precision"] >= self.precision_threshold,
            "target": target,
        }

    def explain(self, X, names=None) -> Dict[str, Any]:
        if self.model is None:
            raise MicroserviceError(
                "AnchorsExplainer needs a model", status_code=400, reason="NO_MODEL"
            )
        X = np.atleast_2d(np.asarray(X, dtype=np.float64))
        names = list(names or [])
        if self._edges is None:
            self._edges = self._fit_edges(X.shape[1])
        elif X.shape[1] != self._edges.shape[0]:
            # the grid is fitted to the background's width; a
            # later request with a different width is the client's
            # error (400), not an IndexError deep in _bins_of
            raise MicroserviceError(
                f"request has {X.shape[1]} features, explainer is fitted "
                f"for {self._edges.shape[0]}",
                status_code=400,
                reason="BAD_REQUEST",
            )
        bg_bins = self._bins_of(self.background)
        rng = np.random.default_rng(self.seed)
        rows = [self._explain_row(x, names, bg_bins, rng) for x in X]
        return {
            "method": "anchors",
            "anchors": rows,
            "targets": [r["target"] for r in rows],
            "precision_threshold": self.precision_threshold,
            "names": names,
        }

    # deployable as a MODEL node: rows of 0/1 anchor membership
    def predict(self, X, names, meta=None):
        X = np.atleast_2d(np.asarray(X, dtype=np.float64))
        result = self.explain(X, names)
        out = np.zeros((len(X), X.shape[1]))
        for i, a in enumerate(result["anchors"]):
            out[i, a["features"]] = 1.0
        return out


EXPLAINER_TYPES: Dict[str, Callable[..., Any]] = {
    "integrated_gradients": IntegratedGradientsExplainer,
    "permutation": PermutationExplainer,
    "kernel_shap": KernelShapExplainer,
    "anchors": AnchorsExplainer,
}


def build_explainer(config: Dict[str, Any]) -> Any:
    etype = config.get("type", "integrated_gradients")
    factory = EXPLAINER_TYPES.get(etype)
    if factory is None:
        raise MicroserviceError(f"unknown explainer type {etype!r}", status_code=400, reason="UNKNOWN_EXPLAINER")
    params = {k: v for k, v in config.items() if k != "type"}
    return factory(**params)
