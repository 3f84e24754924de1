"""Control plane: spec, defaulting/validation, placement, deployer, supervisor."""

from seldon_core_tpu_torch.controlplane.spec import (  # noqa: F401
    DeploymentSpecError,
    PredictorSpec,
    TpuDeployment,
)
from seldon_core_tpu_torch.controlplane.defaulting import (  # noqa: F401
    apply_defaults,
    default_and_validate,
    validate,
)
from seldon_core_tpu_torch.controlplane.placement import plan_placement  # noqa: F401
from seldon_core_tpu_torch.controlplane.deployer import (  # noqa: F401
    Deployer,
    ManagedDeployment,
    build_generation,
    serve_deployment,
)
from seldon_core_tpu_torch.controlplane.supervisor import (  # noqa: F401
    ProcessSpec,
    SupervisedProcess,
    Supervisor,
)
from seldon_core_tpu_torch.controlplane.autoscaler import (  # noqa: F401
    Autoscaler,
    CounterRateSampler,
    HpaSpec,
    ReplicaSet,
)
