"""L2 client layer + L0 fake substrate (SURVEY.md C10-C16).

- ``store``      in-memory cluster state with List/Watch + finalizers (L0 fake)
- ``clientset``  typed, token-bucket rate-limited clients
- ``fake``       action-recording test double with reactors
- ``informer``   reflector -> delta stream -> indexed cache -> callbacks
- ``listers``    read-only cache access
- ``workqueue``  dedup'ing rate-limited queue
- ``ratelimit``  token bucket + per-item backoff limiters
"""

from tfk8s_tpu_torch.api.frozen import FrozenObjectError, freeze, is_frozen, thaw  # noqa: F401
from tfk8s_tpu_torch.client.store import (  # noqa: F401
    AlreadyExists,
    ClusterStore,
    Conflict,
    EventType,
    Gone,
    Invalid,
    NotFound,
    Watch,
    WatchEvent,
)
from tfk8s_tpu_torch.client.clientset import Clientset, RESTConfig, TypedClient  # noqa: F401
from tfk8s_tpu_torch.client.fake import Action, FakeClientset  # noqa: F401
from tfk8s_tpu_torch.client.informer import (  # noqa: F401
    DeletedFinalStateUnknown,
    Indexer,
    ResourceEventHandler,
    SharedIndexInformer,
    deletion_handling_key,
    meta_namespace_key,
    wait_for_cache_sync,
)
from tfk8s_tpu_torch.client.listers import Lister  # noqa: F401
from tfk8s_tpu_torch.client.workqueue import (  # noqa: F401
    DelayingQueue,
    RateLimitingQueue,
    WorkQueue,
)
