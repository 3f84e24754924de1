"""Data-plane orchestrator: graph spec, executor, transports, builtins."""

from seldon_core_tpu_torch.engine.graph import (  # noqa: F401
    Endpoint,
    GraphSpecError,
    UnitSpec,
    validate_graph,
)
from seldon_core_tpu_torch.engine.executor import GraphExecutor, build_client  # noqa: F401
from seldon_core_tpu_torch.engine.transport import (  # noqa: F401
    BalancedClient,
    CircuitBreaker,
    backoff_s,
    breakers_enabled,
)
from seldon_core_tpu_torch.engine.service import PredictorService, new_puid  # noqa: F401
from seldon_core_tpu_torch.engine.units import (  # noqa: F401
    BUILTIN_IMPLEMENTATIONS,
    AverageCombiner,
    PassthroughRouter,
    RandomABTest,
    StubModel,
    make_builtin,
    register_implementation,
)
from seldon_core_tpu_torch.engine.native_ingress import fast_lane_for, serve_native_ingress  # noqa: F401
