"""Learned routers — multi-armed bandits over graph branches.

Re-design of the reference's MAB components
(reference: components/routers/epsilon-greedy/EpsilonGreedy.py:9-150,
components/routers/thompson-sampling/ThompsonSampling.py): stateful
``route()`` + ``send_feedback()`` learning the best child branch online
from the reward signal the engine propagates back along the served
branch (reference call stack: SURVEY §3.3).

State is a small set of arrays (counts / reward sums / Beta
posteriors), snapshot and restored through ``checkpoint_state`` /
``restore_state`` by the persistence subsystem
(``utils/persistence.py``), as in the JAX package.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

import numpy as np

from seldon_core_tpu_torch.runtime.component import TPUComponent, gauge_metric


class EpsilonGreedy(TPUComponent):
    """Explore with probability epsilon, else exploit the best branch.

    Reward model: running mean reward per branch (the reference models
    Bernoulli success/failure counts; a running mean generalises to
    real-valued rewards).
    """

    def __init__(
        self,
        n_branches: int = 2,
        epsilon: float = 0.1,
        decay: float = 1.0,
        seed: Optional[int] = None,
        **kwargs: Any,
    ):
        super().__init__(**kwargs)
        if n_branches < 1:
            raise ValueError("n_branches must be >= 1")
        self.n_branches = int(n_branches)
        self.epsilon = float(epsilon)
        self.decay = float(decay)  # epsilon *= decay on every feedback
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()
        self.counts = np.zeros(self.n_branches, dtype=np.int64)
        self.reward_sums = np.zeros(self.n_branches, dtype=np.float64)

    def branch_values(self) -> np.ndarray:
        with self._lock:
            return np.where(self.counts > 0, self.reward_sums / np.maximum(self.counts, 1), 0.0)

    def route(self, features, names) -> int:
        with self._lock:
            if self._rng.random() < self.epsilon:
                branch = int(self._rng.integers(self.n_branches))
            else:
                values = np.where(
                    self.counts > 0, self.reward_sums / np.maximum(self.counts, 1), np.inf
                )  # optimistic: try unexplored branches first
                branch = int(np.argmax(values))
        return branch

    def send_feedback(self, features, names, reward, truth, routing=None):
        if routing is None or not (0 <= routing < self.n_branches):
            return None
        with self._lock:
            self.counts[routing] += 1
            self.reward_sums[routing] += float(reward)
            self.epsilon *= self.decay
        return None

    def metrics(self) -> List[Dict]:
        values = self.branch_values()
        out = [gauge_metric("mab_epsilon", self.epsilon)]
        for i, v in enumerate(values):
            out.append(gauge_metric("mab_branch_value", float(v), tags={"branch": str(i)}))
        return out

    def checkpoint_state(self) -> Dict[str, Any]:
        with self._lock:
            return {"counts": self.counts.copy(), "reward_sums": self.reward_sums.copy(), "epsilon": self.epsilon}

    def restore_state(self, state: Dict[str, Any]) -> None:
        with self._lock:
            self.counts = np.asarray(state["counts"], dtype=np.int64)
            self.reward_sums = np.asarray(state["reward_sums"], dtype=np.float64)
            self.epsilon = float(state.get("epsilon", self.epsilon))


class ThompsonSampling(TPUComponent):
    """Beta-Bernoulli posterior sampling per branch.

    Rewards are interpreted as success probabilities in [0, 1]
    (clipped); each feedback adds reward to alpha and (1 - reward) to
    beta, and routing samples each branch's posterior.
    """

    def __init__(self, n_branches: int = 2, seed: Optional[int] = None, **kwargs: Any):
        super().__init__(**kwargs)
        if n_branches < 1:
            raise ValueError("n_branches must be >= 1")
        self.n_branches = int(n_branches)
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()
        self.alpha = np.ones(self.n_branches, dtype=np.float64)
        self.beta = np.ones(self.n_branches, dtype=np.float64)

    def route(self, features, names) -> int:
        with self._lock:
            samples = self._rng.beta(self.alpha, self.beta)
        return int(np.argmax(samples))

    def send_feedback(self, features, names, reward, truth, routing=None):
        if routing is None or not (0 <= routing < self.n_branches):
            return None
        r = float(np.clip(reward, 0.0, 1.0))
        with self._lock:
            self.alpha[routing] += r
            self.beta[routing] += 1.0 - r
        return None

    def metrics(self) -> List[Dict]:
        with self._lock:
            means = self.alpha / (self.alpha + self.beta)
        return [
            gauge_metric("mab_branch_posterior_mean", float(m), tags={"branch": str(i)})
            for i, m in enumerate(means)
        ]

    def checkpoint_state(self) -> Dict[str, Any]:
        with self._lock:
            return {"alpha": self.alpha.copy(), "beta": self.beta.copy()}

    def restore_state(self, state: Dict[str, Any]) -> None:
        with self._lock:
            self.alpha = np.asarray(state["alpha"], dtype=np.float64)
            self.beta = np.asarray(state["beta"], dtype=np.float64)
