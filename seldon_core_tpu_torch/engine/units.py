"""Builtin graph units — zero-hop implementations selectable by name.

The declarative ``implementation`` field of a graph node picks one of
these instead of a user component or remote endpoint, mirroring the
reference engine's hardcoded units
(reference: SimpleModelUnit.java:29-72, SimpleRouterUnit.java,
AverageCombinerUnit.java, RandomABTestUnit.java:105-112,
PredictorConfigBean.java:20-60).  The stub model is what the published
baseline benchmarks measure (reference:
doc/source/reference/benchmarking.md:19-36), so ours is the unit under
test for data-plane benchmarks too.
"""

from __future__ import annotations

import importlib
import importlib.util
import random
import threading
from typing import Any, Callable, Dict, Optional

import numpy as np

from seldon_core_tpu_torch.runtime.component import MicroserviceError, TPUComponent


class StubModel(TPUComponent):
    """Fixed-output model: measures the data plane, not model compute."""

    OUTPUT = np.array([[0.9, 0.05, 0.05]])
    NAMES = ["class0", "class1", "class2"]

    def predict(self, X, names, meta=None):
        return self.OUTPUT

    def class_names(self):
        return self.NAMES


class PassthroughRouter(TPUComponent):
    """Always routes to the first child."""

    def route(self, features, names):
        return 0


class AverageCombiner(TPUComponent):
    """Element-wise mean of children outputs; shapes must agree
    (reference: AverageCombinerUnit.java)."""

    def aggregate(self, features_list, names_list):
        arrays = [np.asarray(f) for f in features_list]
        first = arrays[0].shape
        for a in arrays[1:]:
            if a.shape != first:
                raise MicroserviceError(
                    f"combiner inputs disagree on shape: {first} vs {a.shape}",
                    status_code=400,
                    reason="COMBINER_SHAPE_MISMATCH",
                )
        return np.mean(arrays, axis=0)


class RandomABTest(TPUComponent):
    """Random traffic split between two branches with feedback counters
    (reference: RandomABTestUnit.java:105-112)."""

    def __init__(self, ratio_a: float = 0.5, seed: Optional[int] = None, **kwargs):
        super().__init__(**kwargs)
        self.ratio_a = float(ratio_a)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.branch_requests = [0, 0]
        self.branch_reward = [0.0, 0.0]

    def route(self, features, names):
        branch = 0 if self._rng.random() < self.ratio_a else 1
        with self._lock:
            self.branch_requests[branch] += 1
        return branch

    def send_feedback(self, features, names, reward, truth, routing=None):
        if routing is not None and 0 <= routing < 2:
            with self._lock:
                self.branch_reward[routing] += reward
        return None

    def checkpoint_state(self):
        with self._lock:
            return {"branch_requests": list(self.branch_requests), "branch_reward": list(self.branch_reward)}

    def restore_state(self, state):
        with self._lock:
            self.branch_requests = list(state["branch_requests"])
            self.branch_reward = list(state["branch_reward"])


# registry: implementation name -> factory(parameters_kwargs) -> component
BUILTIN_IMPLEMENTATIONS: Dict[str, Callable[..., Any]] = {
    # reference-compatible names (reference: seldon_deployment.proto:102-113)
    "SIMPLE_MODEL": StubModel,
    "SIMPLE_ROUTER": PassthroughRouter,
    "AVERAGE_COMBINER": AverageCombiner,
    "RANDOM_ABTEST": RandomABTest,
}


# the prepackaged servers and reusable components, imported on first use
# so that building a graph of stubs loads neither torch models nor
# routers: implementation name -> "module:attribute"
PREPACKAGED: Dict[str, str] = {
    "CUDA_SERVER": "seldon_core_tpu_torch.models.cudaserver:CudaServer",
    "STREAMING_LM": "seldon_core_tpu_torch.models.paged:StreamingLM",
    "GENERATIVE_LM": "seldon_core_tpu_torch.models.generate:GenerativeLM",
    "SPECULATIVE_LM": "seldon_core_tpu_torch.models.speculative:SpeculativeLM",
    "DISAGGREGATED_LM": "seldon_core_tpu_torch.models.disagg:DisaggregatedLM",
    "PREFILL_LM": "seldon_core_tpu_torch.models.disagg:PrefillLM",
    "EPSILON_GREEDY": "seldon_core_tpu_torch.components.routers:EpsilonGreedy",
    "THOMPSON_SAMPLING": "seldon_core_tpu_torch.components.routers:ThompsonSampling",
    "OUTLIER_MAHALANOBIS": "seldon_core_tpu_torch.components.outliers:MahalanobisDetector",
    "OUTLIER_VAE": "seldon_core_tpu_torch.components.outliers:VAEOutlierDetector",
    "OUTLIER_ISOLATION_FOREST": "seldon_core_tpu_torch.components.outliers:IsolationForestDetector",
    "OUTLIER_SEQ2SEQ": "seldon_core_tpu_torch.components.outliers:Seq2SeqOutlierDetector",
    "XGBOOST_SERVER": "seldon_core_tpu_torch.models.xgboostserver:XGBoostServer",
    "TORCH_SERVER": "seldon_core_tpu_torch.models.torchserver:TorchServer",
    "MLFLOW_SERVER": "seldon_core_tpu_torch.models.mlflowserver:MLFlowServer",
    "REST_PROXY": "seldon_core_tpu_torch.models.proxyserver:RestProxyServer",
    "SAGEMAKER_PROXY": "seldon_core_tpu_torch.models.proxyserver:SageMakerProxy",
    # the reference's TENSORFLOW_SERVER prepackaged proxy
    "TENSORFLOW_SERVER": "seldon_core_tpu_torch.models.proxyserver:TFServingGrpcProxy",
}
# gated on the optional toolkit, as the JAX package registers it
if importlib.util.find_spec("sklearn") is not None:
    PREPACKAGED["SKLEARN_SERVER"] = "seldon_core_tpu_torch.models.sklearnserver:SKLearnServer"


def register_implementation(name: str, factory: Callable[..., Any]) -> None:
    BUILTIN_IMPLEMENTATIONS[name.upper()] = factory


def _lookup_builtin(name: str) -> Callable[..., Any]:
    key = name.upper()
    factory = BUILTIN_IMPLEMENTATIONS.get(key)
    if factory is None and key in PREPACKAGED:
        module, attr = PREPACKAGED[key].split(":")
        factory = getattr(importlib.import_module(module), attr)
    if factory is None:
        raise MicroserviceError(
            f"unknown builtin implementation {name!r}", status_code=400, reason="UNKNOWN_IMPLEMENTATION"
        )
    return factory


def make_builtin(name: str, **kwargs: Any) -> Any:
    return _lookup_builtin(name)(**kwargs)
