"""Online outlier detection components.

Dual-use components like the reference's detectors
(reference: components/outlier-detection/mahalanobis/
CoreMahalanobis.py:7-50): deployable as a MODEL (returns outlier
scores) or as an input TRANSFORMER (passes data through unchanged while
tagging outliers in ``meta.tags`` and counting them in custom metrics).
The port's counterparts of the JAX package's four detectors, registered
under the same names (``engine/units.py``):

* ``MahalanobisDetector`` — numpy, a copy;
* ``VAEOutlierDetector`` — an ``nn.Module`` on the component's device,
  trained with ``torch.optim.Adam`` at optax's defaults;
* ``IsolationForestDetector`` — the host-side ``fit`` is the JAX
  package's, so a seed builds the same packed forest; scoring is a
  level-synchronous gather loop on the device;
* ``Seq2SeqOutlierDetector`` — ``nn.LSTM`` encoder and decoder.

The learned detectors read and write flax msgpack checkpoints through
``utils/serialization.py`` and ``models/convert.py``.  Every detector
runs on ``cuda`` unless ``device="cpu"``.

The VAE scores with noise: JAX draws it from ``jax.random.key(0)``,
which PyTorch cannot draw, so the port draws its score noise from a
``torch.Generator`` seeded 0 on the host (the same noise on every
device); :meth:`VAEOutlierDetector.score` takes ``eps`` to score with
JAX's noise instead (``ROADMAP.md`` C23).
"""

from __future__ import annotations

import math
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from seldon_core_tpu_torch.models.cudaserver import resolve_device
from seldon_core_tpu_torch.runtime.component import TPUComponent, counter_metric, gauge_metric


class _OutlierSurface:
    """The node-role surface the four detectors share: scores as a
    MODEL, pass-through as a TRANSFORMER, outlier tags and metrics."""

    _last_scores: np.ndarray
    _last_flags: np.ndarray

    def predict(self, X, names, meta=None):
        return self.score(X).reshape(-1, 1)

    def transform_input(self, X, names, meta=None):
        self.score(X)
        return X

    def tags(self) -> Dict:
        return {"outlier": bool(self._last_flags.any()), "outlier_count": int(self._last_flags.sum())}

    def metrics(self) -> List[Dict]:
        out = [gauge_metric("outlier_score_max", float(self._last_scores.max(initial=0.0)))]
        flagged = int(self._last_flags.sum())
        if flagged:
            out.append(counter_metric("outliers_total", float(flagged)))
        return out


def _init_dense(layer: nn.Linear, gen: torch.Generator) -> None:
    """flax ``Dense``'s default init: lecun-normal kernel (a normal of
    variance 1 / fan_in truncated at two deviations), zero bias."""
    fan_in = layer.weight.shape[1]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        w = torch.empty(layer.weight.shape).normal_(0.0, 1.0, generator=gen).clamp_(-2.0, 2.0) * std
        layer.weight.copy_(w)
        layer.bias.zero_()


def _flax_dense(layer: nn.Linear) -> Dict[str, np.ndarray]:
    return {"kernel": layer.weight.detach().cpu().numpy().T.copy(), "bias": layer.bias.detach().cpu().numpy()}


def _read_flax(model_uri: str) -> Any:
    from seldon_core_tpu_torch.utils import serialization, storage

    with open(storage.download(model_uri), "rb") as f:
        return serialization.to_numpy_tree(serialization.msgpack_restore(f.read()))


def _write_flax(path: str, tree: Dict[str, Any]) -> None:
    from seldon_core_tpu_torch.utils import serialization

    with open(path, "wb") as f:
        f.write(serialization.to_bytes(tree))


class VAE(nn.Module):
    """The JAX detector's network: ``enc1`` (ReLU) -> ``mu`` / ``logvar``
    -> ``z = mu + exp(logvar / 2) * eps`` -> ``dec1`` (ReLU) -> ``out``."""

    def __init__(self, n_features: int, hidden: int, latent: int):
        super().__init__()
        self.enc1 = nn.Linear(n_features, hidden)
        self.mu = nn.Linear(hidden, latent)
        self.logvar = nn.Linear(hidden, latent)
        self.dec1 = nn.Linear(latent, hidden)
        self.out = nn.Linear(hidden, n_features)

    def forward(self, x: torch.Tensor, eps: torch.Tensor):
        h = torch.relu(self.enc1(x))
        mu, logvar = self.mu(h), self.logvar(h)
        z = mu + torch.exp(0.5 * logvar) * eps
        return self.out(torch.relu(self.dec1(z))), mu, logvar


class VAEOutlierDetector(_OutlierSurface, TPUComponent):
    """Variational-autoencoder outlier detection (reference analogue:
    components/outlier-detection/vae/CoreVAE.py:11-170).

    Scoring: reconstruction error (MSE) of the encoded/decoded input;
    rows above ``threshold`` flag as outliers.  Train with ``fit`` on
    normal data before deploying, or load trained params via
    ``model_uri`` (the JAX detector's flax msgpack).
    """

    def __init__(self, n_features: int = 0, latent_dim: int = 2, hidden_dim: int = 32, threshold: float = 0.5,
                 model_uri: str = "", seed: int = 0, device: str = "cuda", **kwargs: Any):
        super().__init__(**kwargs)
        self.n_features = int(n_features)
        self.latent_dim = int(latent_dim)
        self.hidden_dim = int(hidden_dim)
        self.threshold = float(threshold)
        self.model_uri = model_uri
        self.seed = int(seed)
        self.device = resolve_device(device)
        self.module: Optional[VAE] = None
        self._last_scores = np.array([])
        self._last_flags = np.array([], dtype=bool)

    def _build(self, n_features: int) -> None:
        self.n_features = n_features
        module = VAE(n_features, self.hidden_dim, self.latent_dim)
        gen = torch.Generator().manual_seed(self.seed)
        for layer in (module.enc1, module.mu, module.logvar, module.dec1, module.out):
            _init_dense(layer, gen)
        self.module = module.to(self.device)

    def load_flax(self, variables: Any) -> None:
        """Load the JAX detector's variables (numpy leaves)."""
        from seldon_core_tpu_torch.models.convert import vae_params_from_flax

        state = vae_params_from_flax(variables)
        n_features = state["enc1.weight"].shape[1]
        if self.module is None or self.n_features != n_features:
            self._build(n_features)
        self.module.load_state_dict(state)

    def load(self) -> None:
        if self.model_uri:
            if self.module is None and not self.n_features:
                raise ValueError("VAEOutlierDetector needs n_features with model_uri")
            self.load_flax(_read_flax(self.model_uri))

    def score_noise(self, rows: int) -> torch.Tensor:
        """The scoring noise for ``rows`` rows: a ``torch.Generator``
        seeded 0, drawn on the host, so a batch of a size scores alike on
        every call and every device (JAX draws ``jax.random.key(0)``)."""
        gen = torch.Generator().manual_seed(0)
        return torch.randn((rows, self.latent_dim), generator=gen).to(self.device)

    def train_step(self, optimizer: torch.optim.Optimizer, batch: torch.Tensor, eps: torch.Tensor,
                   kl_weight: float) -> float:
        """One Adam step on ``batch`` with the latent noise ``eps``;
        returns the loss before the step."""
        recon, mu, logvar = self.module(batch, eps)
        mse = torch.mean((batch - recon) ** 2)
        kl = -0.5 * torch.mean(1 + logvar - mu ** 2 - torch.exp(logvar))
        loss = mse + kl_weight * kl
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return float(loss.detach())

    def make_optimizer(self, learning_rate: float) -> torch.optim.Optimizer:
        """``optax.adam(learning_rate)``: b1 0.9, b2 0.999, eps 1e-8."""
        return torch.optim.Adam(self.module.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)

    def fit(self, X: np.ndarray, epochs: int = 50, learning_rate: float = 1e-2, kl_weight: float = 1e-3,
            batch_size: int = 128) -> List[float]:
        """Train on normal data in full minibatches (the order from
        ``np.random.default_rng(seed)``, the JAX detector's; the latent
        noise from a ``torch.Generator`` seeded ``seed`` on the device);
        returns per-epoch losses."""
        X = np.asarray(X, dtype=np.float32)
        if self.module is None:
            self._build(X.shape[1])
        optimizer = self.make_optimizer(learning_rate)
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        perm_rng = np.random.default_rng(self.seed)
        data = torch.from_numpy(X).to(self.device)
        losses = []
        for _ in range(epochs):
            order = perm_rng.permutation(len(X))
            bs = min(batch_size, len(X))
            epoch_loss, n_batches = 0.0, 0
            for start in range(0, len(X) - bs + 1, bs):
                idx = torch.from_numpy(order[start:start + bs]).to(self.device)
                eps = torch.randn((bs, self.latent_dim), generator=gen, device=self.device)
                epoch_loss += self.train_step(optimizer, data[idx], eps, kl_weight)
                n_batches += 1
            losses.append(epoch_loss / max(n_batches, 1))
        return losses

    def score(self, X, eps: Optional[Any] = None) -> np.ndarray:
        """Per-row reconstruction MSE; ``eps`` (rows, latent) replaces the
        scoring noise (JAX's, to score as the JAX detector does)."""
        X = np.atleast_2d(np.asarray(X, dtype=np.float32))
        if self.module is None:
            self._build(X.shape[1])
        eps = self.score_noise(X.shape[0]) if eps is None else torch.from_numpy(
            np.array(eps, np.float32)).to(self.device)
        with torch.inference_mode():
            x = torch.from_numpy(X).to(self.device)
            recon, _, _ = self.module(x, eps)
            scores = torch.mean((x - recon) ** 2, dim=-1).cpu().numpy()
        self._last_scores = scores
        self._last_flags = scores > self.threshold
        return scores

    def class_names(self):
        return ["reconstruction_error"]

    def save(self, path: str) -> None:
        """The trained network as the JAX detector's flax msgpack."""
        m = self.module
        _write_flax(path, {"params": {name: _flax_dense(getattr(m, name)) for name in (
            "enc1", "mu", "logvar", "dec1", "out")}})


class MahalanobisDetector(_OutlierSurface, TPUComponent):
    """Online Mahalanobis-distance outlier scoring.

    Maintains a running mean and covariance of the feature stream
    (Welford-style updates) and scores each row by its Mahalanobis
    distance to the current estimate.  Rows beyond ``threshold`` are
    flagged.  Host numpy, as in the JAX package.
    """

    def __init__(self, n_features: Optional[int] = None, threshold: float = 25.0, min_samples: int = 10,
                 regularisation: float = 1e-3, **kwargs: Any):
        super().__init__(**kwargs)
        self.threshold = float(threshold)
        self.min_samples = int(min_samples)
        self.reg = float(regularisation)
        self._lock = threading.Lock()
        self.n = 0
        self.mean: Optional[np.ndarray] = None
        self.m2: Optional[np.ndarray] = None  # sum of outer-product deviations
        self._last_scores: np.ndarray = np.array([])
        self._last_flags: np.ndarray = np.array([], dtype=bool)
        self.total_outliers = 0
        if n_features:
            self._init_stats(int(n_features))

    def _init_stats(self, d: int) -> None:
        self.mean = np.zeros(d)
        self.m2 = np.zeros((d, d))

    def _update(self, X: np.ndarray) -> None:
        for row in X:
            self.n += 1
            delta = row - self.mean
            self.mean += delta / self.n
            self.m2 += np.outer(delta, row - self.mean)

    def score(self, X: np.ndarray) -> np.ndarray:
        """Mahalanobis distance (squared) per row against current stats."""
        X = np.atleast_2d(np.asarray(X, dtype=np.float64))
        with self._lock:
            if self.mean is None:
                self._init_stats(X.shape[1])
            if self.n < max(self.min_samples, 2):
                scores = np.zeros(X.shape[0])
            else:
                cov = self.m2 / (self.n - 1) + self.reg * np.eye(X.shape[1])
                inv = np.linalg.inv(cov)
                diff = X - self.mean
                scores = np.einsum("ij,jk,ik->i", diff, inv, diff)
            self._update(X)
            self._last_scores = scores
            self._last_flags = scores > self.threshold
            self.total_outliers += int(self._last_flags.sum())
        return scores

    def class_names(self):
        return ["outlier_score"]

    def checkpoint_state(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            if self.mean is None:
                return None
            return {"n": self.n, "mean": self.mean.copy(), "m2": self.m2.copy(),
                    "total_outliers": self.total_outliers}

    def restore_state(self, state: Dict[str, Any]) -> None:
        with self._lock:
            self.n = int(state["n"])
            self.mean = np.asarray(state["mean"], dtype=np.float64)
            self.m2 = np.asarray(state["m2"], dtype=np.float64)
            self.total_outliers = int(state.get("total_outliers", 0))


def _avg_path(n: torch.Tensor) -> torch.Tensor:
    """c(n): the average unsuccessful-search path length in a BST."""
    n = torch.clamp(n, min=2.0)
    harmonic = torch.log(n - 1.0) + 0.5772156649
    return 2.0 * harmonic - 2.0 * (n - 1.0) / n


class IsolationForestDetector(_OutlierSurface, TPUComponent):
    """Isolation-forest outlier scoring (reference analogue:
    components/outlier-detection/isolation-forest/CoreIsolationForest.py:8-120,
    a pickled sklearn model).

    ``fit`` builds the random trees on the host (tree construction is
    sequential) and packs every tree into flat arrays (feature /
    threshold / child / size a node), the JAX package's code, so a seed
    gives the same forest.  Scoring walks every (row, tree) pair one
    level an iteration on the device: ``max_depth + 1`` rounds of
    gathers, no data-dependent control flow.

    Score: the standard iForest anomaly score ``2^(-E[h(x)]/c(n))`` in
    (0, 1]; rows with score > ``threshold`` flag as outliers (0.5 is
    the classic "no structure" midpoint).
    """

    def __init__(self, n_trees: int = 100, subsample: int = 256, threshold: float = 0.6, seed: int = 0,
                 device: str = "cuda", **kwargs: Any):
        super().__init__(**kwargs)
        self.n_trees = int(n_trees)
        self.subsample = int(subsample)
        self.threshold = float(threshold)
        self.seed = int(seed)
        self.device = resolve_device(device)
        # packed forest: (n_trees, max_nodes) arrays
        self.features = None
        self.thresholds = None
        self.left = None
        self.right = None
        self.node_size = None
        self.sample_size = 0
        self._forest = None  # the packed arrays on the device
        self._last_scores = np.array([])
        self._last_flags = np.array([], dtype=bool)
        self._lock = threading.Lock()

    # ---- training (host) --------------------------------------------------

    def fit(self, X: np.ndarray) -> "IsolationForestDetector":
        X = np.atleast_2d(np.asarray(X, dtype=np.float32))
        n, d = X.shape
        rng = np.random.default_rng(self.seed)
        psi = min(self.subsample, n)
        max_depth = int(np.ceil(np.log2(max(psi, 2))))
        max_nodes = 2 ** (max_depth + 1) - 1

        feats = np.zeros((self.n_trees, max_nodes), np.int32)
        thresh = np.zeros((self.n_trees, max_nodes), np.float32)
        left = np.full((self.n_trees, max_nodes), -1, np.int32)
        right = np.full((self.n_trees, max_nodes), -1, np.int32)
        sizes = np.zeros((self.n_trees, max_nodes), np.float32)

        for t in range(self.n_trees):
            sample = X[rng.choice(n, size=psi, replace=False)]
            # iterative build: (node_index, rows, depth)
            next_free = [1]  # node 0 is the root
            stack = [(0, sample, 0)]
            while stack:
                node, rows, depth = stack.pop()
                sizes[t, node] = len(rows)
                spread = rows.max(axis=0) - rows.min(axis=0) if len(rows) else 0
                if depth >= max_depth or len(rows) <= 1 or np.all(spread == 0):
                    continue  # leaf: children stay -1
                f = int(rng.integers(0, d))
                lo, hi = rows[:, f].min(), rows[:, f].max()
                if lo == hi:  # degenerate split axis; try the widest
                    f = int(np.argmax(spread))
                    lo, hi = rows[:, f].min(), rows[:, f].max()
                s = float(rng.uniform(lo, hi))
                mask = rows[:, f] < s
                li, ri = next_free[0], next_free[0] + 1
                next_free[0] += 2
                feats[t, node], thresh[t, node] = f, s
                left[t, node], right[t, node] = li, ri
                stack.append((li, rows[mask], depth + 1))
                stack.append((ri, rows[~mask], depth + 1))

        with self._lock:
            self.features, self.thresholds = feats, thresh
            self.left, self.right, self.node_size = left, right, sizes
            self.sample_size = psi
            self._forest = None  # uploaded again at the next score
        return self

    # ---- scoring (device) -------------------------------------------------

    def _upload(self):
        dev = self.device
        return (torch.from_numpy(self.features).long().to(dev), torch.from_numpy(self.thresholds).to(dev),
                torch.from_numpy(self.left).long().to(dev), torch.from_numpy(self.right).long().to(dev),
                torch.from_numpy(self.node_size).to(dev),
                int(np.ceil(np.log2(max(self.sample_size, 2)))),
                float(_avg_path(torch.tensor(float(self.sample_size), dtype=torch.float32))))

    def score(self, X) -> np.ndarray:
        X = np.atleast_2d(np.asarray(X, dtype=np.float32))
        with self._lock:
            if self.features is None:
                raise RuntimeError("IsolationForestDetector.fit was never called")
            if self._forest is None:
                self._forest = self._upload()
            feats, thresh, left, right, sizes, max_depth, c_psi = self._forest
        with torch.inference_mode():
            x = torch.from_numpy(X).to(self.device)
            rows, trees = x.shape[0], feats.shape[0]

            def at(table: torch.Tensor, node: torch.Tensor) -> torch.Tensor:
                # table (trees, nodes) read at each (row, tree)'s node
                return torch.gather(table.unsqueeze(0).expand(rows, -1, -1), 2, node.unsqueeze(2)).squeeze(2)

            node = torch.zeros((rows, trees), dtype=torch.long, device=self.device)
            depth = torch.zeros((rows, trees), dtype=torch.float32, device=self.device)
            for _ in range(max_depth + 1):
                f, s, lft, rgt = at(feats, node), at(thresh, node), at(left, node), at(right, node)
                x_f = torch.gather(x, 1, f)
                is_leaf = lft < 0
                node = torch.where(is_leaf, node, torch.where(x_f < s, lft, rgt))
                depth = torch.where(is_leaf, depth, depth + 1.0)
            leaf_n = at(sizes, node)
            # unresolved subtrees contribute the BST average path length
            h = depth + torch.where(leaf_n > 1.0, _avg_path(leaf_n), torch.zeros_like(leaf_n))
            scores = torch.pow(2.0, -torch.mean(h, dim=1) / c_psi).cpu().numpy()
        self._last_scores = scores
        self._last_flags = scores > self.threshold
        return scores

    def class_names(self):
        return ["anomaly_score"]

    # ---- persistence (explicit state, pickle-free) ------------------------

    def checkpoint_state(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            if self.features is None:
                return None
            return {"features": self.features.copy(), "thresholds": self.thresholds.copy(),
                    "left": self.left.copy(), "right": self.right.copy(), "node_size": self.node_size.copy(),
                    "sample_size": self.sample_size}

    def restore_state(self, state: Dict[str, Any]) -> None:
        with self._lock:
            self.features = np.asarray(state["features"], np.int32)
            self.thresholds = np.asarray(state["thresholds"], np.float32)
            self.left = np.asarray(state["left"], np.int32)
            self.right = np.asarray(state["right"], np.int32)
            self.node_size = np.asarray(state["node_size"], np.float32)
            self.sample_size = int(state["sample_size"])
            self._forest = None


class Seq2Seq(nn.Module):
    """The JAX detector's network: an LSTM encoder whose final state
    seeds an LSTM decoder fed the sequence shifted one step right (zeros
    first: reconstruction comes from the learned dynamics, not copying),
    then a dense layer back to the features."""

    def __init__(self, n_features: int, hidden: int):
        super().__init__()
        self.encoder = nn.LSTM(n_features, hidden, batch_first=True)
        self.decoder = nn.LSTM(n_features, hidden, batch_first=True)
        self.out = nn.Linear(hidden, n_features)
        for lstm in (self.encoder, self.decoder):
            # flax's input kernels carry no bias: bias_ih stays zero
            lstm.bias_ih_l0.requires_grad_(False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # x: (batch, time, features)
        _, carry = self.encoder(x)
        shifted = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
        hidden_seq, _ = self.decoder(shifted, carry)
        return self.out(hidden_seq)


class Seq2SeqOutlierDetector(_OutlierSurface, TPUComponent):
    """Sequence outlier detection via LSTM encoder-decoder
    reconstruction (reference analogue:
    components/outlier-detection/seq2seq-lstm/model.py:6-100 +
    CoreSeq2SeqLSTM.py:10-200).

    Score: per-sequence mean squared reconstruction error; sequences
    above ``threshold`` flag as outliers (the reference thresholds the
    same MSE, default 0.003).
    """

    def __init__(self, n_features: int = 0, hidden_dim: int = 32, threshold: float = 0.003, model_uri: str = "",
                 seed: int = 0, device: str = "cuda", **kwargs: Any):
        super().__init__(**kwargs)
        self.n_features = int(n_features)
        self.hidden_dim = int(hidden_dim)
        self.threshold = float(threshold)
        self.model_uri = model_uri
        self.seed = int(seed)
        self.device = resolve_device(device)
        self.module: Optional[Seq2Seq] = None
        self._last_scores = np.array([])
        self._last_flags = np.array([], dtype=bool)

    def _build(self, n_features: int) -> None:
        self.n_features = n_features
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(self.seed)
            module = Seq2Seq(n_features, self.hidden_dim)
        with torch.no_grad():
            for lstm in (module.encoder, module.decoder):
                lstm.bias_ih_l0.zero_()
            module.out.bias.zero_()
        self.module = module.to(self.device)

    def load_flax(self, variables: Any) -> None:
        """Load the JAX detector's variables (numpy leaves)."""
        from seldon_core_tpu_torch.models.convert import seq2seq_params_from_flax

        state = seq2seq_params_from_flax(variables)
        n_features = state["encoder.weight_ih_l0"].shape[1]
        if self.module is None or self.n_features != n_features or state["out.weight"].shape[1] != self.hidden_dim:
            self.hidden_dim = state["out.weight"].shape[1]
            self._build(n_features)
        self.module.load_state_dict(state)

    def load(self) -> None:
        if self.model_uri:
            if self.module is None and not self.n_features:
                raise ValueError("Seq2SeqOutlierDetector needs n_features with model_uri")
            self.load_flax(_read_flax(self.model_uri))

    def fit(self, X: np.ndarray, epochs: int = 50, learning_rate: float = 1e-2, batch_size: int = 64) -> List[float]:
        """Train on normal sequences (n, time, features) with Adam at
        optax's defaults, minibatches in the JAX detector's order;
        returns per-epoch losses."""
        X = np.asarray(X, dtype=np.float32)
        if X.ndim == 2:  # single-feature sequences (n, time)
            X = X[:, :, None]
        if self.module is None:
            self._build(X.shape[2])
        params = [p for p in self.module.parameters() if p.requires_grad]
        optimizer = torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
        perm_rng = np.random.default_rng(self.seed)
        data = torch.from_numpy(X).to(self.device)
        losses = []
        for _ in range(epochs):
            order = perm_rng.permutation(len(X))
            bs = min(batch_size, len(X))  # full batches only
            epoch_loss, n_batches = 0.0, 0
            for start in range(0, len(X) - bs + 1, bs):
                batch = data[torch.from_numpy(order[start:start + bs]).to(self.device)]
                loss = torch.mean((batch - self.module(batch)) ** 2)
                optimizer.zero_grad(set_to_none=True)
                loss.backward()
                optimizer.step()
                epoch_loss += float(loss.detach())
                n_batches += 1
            losses.append(epoch_loss / max(n_batches, 1))
        return losses

    def score(self, X) -> np.ndarray:
        X = np.asarray(X, dtype=np.float32)
        if X.ndim == 2:
            X = X[:, :, None]
        if self.module is None:
            raise RuntimeError("Seq2SeqOutlierDetector needs fit() or model_uri before scoring")
        with torch.inference_mode():
            x = torch.from_numpy(X).to(self.device)
            scores = torch.mean((x - self.module(x)) ** 2, dim=(1, 2)).cpu().numpy()
        self._last_scores = scores
        self._last_flags = scores > self.threshold
        return scores

    def class_names(self):
        return ["reconstruction_error"]

    def save(self, path: str) -> None:
        """The trained network as the JAX detector's flax msgpack."""
        params: Dict[str, Any] = {"out": _flax_dense(self.module.out)}
        h = self.hidden_dim
        for lstm, cell in ((self.module.encoder, "OptimizedLSTMCell_0"), (self.module.decoder, "OptimizedLSTMCell_1")):
            w_ih = lstm.weight_ih_l0.detach().cpu().numpy()
            w_hh = lstm.weight_hh_l0.detach().cpu().numpy()
            b = (lstm.bias_hh_l0 + lstm.bias_ih_l0).detach().cpu().numpy()
            params[cell] = {}
            for k, g in enumerate("ifgo"):
                params[cell][f"i{g}"] = {"kernel": w_ih[k * h:(k + 1) * h].T.copy()}
                params[cell][f"h{g}"] = {"kernel": w_hh[k * h:(k + 1) * h].T.copy(), "bias": b[k * h:(k + 1) * h]}
        _write_flax(path, {"params": params})
