"""L1 API layer: TPUJob schema, defaults, validation, helpers, serde.

Equivalent of the reference's ``pkg/apis/tensorflow/`` tree (SURVEY.md
C4-C9; images/tf3.PNG at k8s-operator.md:229).
"""

from tfk8s_tpu_torch.api.types import (  # noqa: F401
    AutoscalePolicy,
    BatchingPolicy,
    CleanPodPolicy,
    Condition,
    ContainerSpec,
    DisaggregationPolicy,
    ElasticPolicy,
    JobConditionType,
    KVTierPolicy,
    MeshSpec,
    ObjectMeta,
    OwnerReference,
    Pod,
    PodPhase,
    PodSpec,
    PodStatus,
    ReplicaSpec,
    ReplicaStatus,
    ReplicaType,
    RestartPolicy,
    RollingUpdatePolicy,
    RunPolicy,
    SchedulingPolicy,
    ServeCondition,
    ServeConditionType,
    Service,
    ServicePort,
    ServiceSpec,
    TPUJob,
    TPUJobSpec,
    TPUJobStatus,
    TPUServe,
    TPUServeSpec,
    TPUServeStatus,
    TPUSpec,
)
from tfk8s_tpu_torch.api.defaults import set_defaults, set_serve_defaults  # noqa: F401
from tfk8s_tpu_torch.api.validation import (  # noqa: F401
    ValidationError,
    validate,
    validate_or_raise,
    validate_serve,
    validate_serve_or_raise,
)
from tfk8s_tpu_torch.api import helpers  # noqa: F401
from tfk8s_tpu_torch.api import serde  # noqa: F401
