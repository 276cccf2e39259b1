"""L1 API types: the TPUJob resource and the core objects it reconciles to.

A copy of the JAX package's ``api/types.py``: the same kinds, fields and
API group, so one manifest and one wire form hold on both operators. On
this one ``spec.tpu.accelerator`` names NVIDIA cards (``h100-8``,
``utils/topology.py``) and the mesh is built by the port's launcher over
``torch.distributed``. The reference's design notes follow.

TPU-native re-design of the reference's ``pkg/apis/tensorflow/v1alpha1/types.go``
(SURVEY.md C4; domain model at k8s-operator.md:6 — *task = one process per
machine; tasks form a job; jobs are PS or WORKER; jobs form a cluster*).

Differences from the reference, by design (SURVEY.md §0 north star):

- replica sets request TPU slices (``TPUSpec``: accelerator type + topology +
  num_slices) instead of ``nvidia.com/gpu`` counts;
- the job carries an optional ``MeshSpec`` — the logical device-mesh axes
  (data/fsdp/tensor/sequence/expert/pipeline) the data plane will build with
  ``jax.sharding.Mesh`` — because on TPU the parallelism layout is a
  *scheduling* concern (slice shape must match mesh shape), not a container
  detail;
- restart semantics keep the reference's ``OnFailure`` / ``Never`` meaning
  (k8s-operator.md:47-49) but add gang semantics: a TPU slice fails as a
  unit, so replica-level restart escalates to whole-gang restart-from-
  checkpoint (SURVEY.md §2 "Elastic / gang semantics").

Everything is a plain dataclass; serialization lives in ``api/serde.py``
(the scheme-registration equivalent of the reference's ``register.go``, C5).
"""

from __future__ import annotations

import copy
import dataclasses
import enum
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from tfk8s_tpu_torch import API_VERSION


# Wire-encoding marker for epoch-seconds fields that serialize as RFC3339
# (api/serde.py to_wire). An explicit per-field registry — NOT a name
# heuristic — so a future duration named *_time can never be silently
# mangled into a timestamp.
RFC3339 = {"wire": "rfc3339"}


# ---------------------------------------------------------------------------
# Metadata (the k8s ObjectMeta equivalent; finalizer/deletion semantics per
# k8s-operator.md:36-43)
# ---------------------------------------------------------------------------


@dataclass
class OwnerReference:
    """Back-pointer from a child object (pod/service) to its owning TPUJob."""

    kind: str
    name: str
    uid: str
    controller: bool = True


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    uid: str = ""
    resource_version: int = 0
    generation: int = 1
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    finalizers: List[str] = field(default_factory=list)
    owner_references: List[OwnerReference] = field(default_factory=list)
    creation_timestamp: Optional[float] = field(default=None, metadata=RFC3339)
    # Deletion only *marks* the object; controllers run finalizers and then
    # clear them, at which point the store actually removes the object
    # (k8s-operator.md:36-43).
    deletion_timestamp: Optional[float] = field(default=None, metadata=RFC3339)

    @property
    def key(self) -> str:
        """The ``namespace/name`` cache key (MetaNamespaceKeyFunc)."""
        return f"{self.namespace}/{self.name}"


# ---------------------------------------------------------------------------
# Enums
# ---------------------------------------------------------------------------


class ReplicaType(str, enum.Enum):
    """Replica roles. CHIEF/WORKER/PS mirror the reference's job types
    (k8s-operator.md:6; 'master/chief per north star' SURVEY.md C4)."""

    CHIEF = "Chief"
    WORKER = "Worker"
    PS = "PS"
    EVALUATOR = "Evaluator"


class RestartPolicy(str, enum.Enum):
    """Per-replica restart semantics (k8s-operator.md:47-49):

    - ON_FAILURE: restart the task in place.
    - NEVER: a failed task is replaced by a fresh one; the failed record is
      kept for inspection (completed pods are not auto-deleted,
      k8s-operator.md:50-52).
    - ALWAYS: restart regardless of exit status (long-running PS tasks).
    - EXIT_CODE: retryable exit codes restart in place, permanent codes fail
      the replica.
    """

    ALWAYS = "Always"
    ON_FAILURE = "OnFailure"
    NEVER = "Never"
    EXIT_CODE = "ExitCode"


class CleanPodPolicy(str, enum.Enum):
    """What to clean up when the job finishes."""

    ALL = "All"
    RUNNING = "Running"
    NONE = "None"


class JobConditionType(str, enum.Enum):
    CREATED = "Created"
    RUNNING = "Running"
    RESTARTING = "Restarting"
    SUSPENDED = "Suspended"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"


class PodPhase(str, enum.Enum):
    PENDING = "Pending"
    SCHEDULED = "Scheduled"
    RUNNING = "Running"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"
    # Terminal like FAILED, but GRACEFUL: the entrypoint honored a reclaim
    # notice (runtime/kubelet.py RECLAIM_AT_ANNOTATION) — finished its
    # in-flight step, committed a drain checkpoint, and exited. The job
    # controller answers a Drained worker with an elastic resize (or a
    # preemption-style restart) instead of burning backoff_limit.
    DRAINED = "Drained"


# ---------------------------------------------------------------------------
# Spec
# ---------------------------------------------------------------------------


@dataclass
class ContainerSpec:
    """What each replica task runs. ``entrypoint`` names a registered Python
    callable (the in-process/local backend analogue of an image+command);
    ``image``/``command`` are carried for real-cluster rendering parity."""

    entrypoint: str = ""
    image: str = ""
    command: List[str] = field(default_factory=list)
    args: List[str] = field(default_factory=list)
    env: Dict[str, str] = field(default_factory=dict)
    resources: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ReplicaSpec:
    """One replica set (the reference's TFReplicaSpec): N tasks of one role."""

    replicas: Optional[int] = None
    restart_policy: Optional[RestartPolicy] = None
    # Cap on per-replica restarts before the whole job is failed.
    max_restarts: Optional[int] = None
    template: ContainerSpec = field(default_factory=ContainerSpec)


@dataclass
class TPUSpec:
    """TPU slice request — replaces the reference's nvidia.com/gpu resource
    counts (north star, BASELINE.json). ``accelerator`` is a type string like
    ``v5p-32`` / ``v5litepod-8`` / ``cpu`` (hermetic tests); ``topology`` an
    optional explicit chip grid like ``2x2x4``; ``num_slices`` > 1 means
    multislice over DCN."""

    accelerator: str = ""
    topology: str = ""
    num_slices: int = 1
    # "" = hermetic/local rendering (tfk8s.dev/* node selectors only);
    # "gke" additionally renders nvidia.com/gpu resource requests and the
    # cloud.google.com/gke-accelerator node selector a real GKE GPU
    # nodepool admits (trainer/replicas.py)
    provider: str = ""


@dataclass
class MeshSpec:
    """Logical device-mesh axes for the data plane, in order. Axis names
    follow the scaling-book convention: data / fsdp / tensor / sequence /
    expert / pipeline (SURVEY.md §2 parallelism table). The product of sizes
    must equal chips-per-slice x num_slices (validated in api/validation.py).
    """

    axes: Dict[str, int] = field(default_factory=dict)

    def size(self) -> int:
        n = 1
        for v in self.axes.values():
            n *= v
        return n


@dataclass
class SchedulingPolicy:
    """Gang-scheduling knobs. TPU slices admit all-or-nothing by hardware
    construction (SURVEY.md §2 'Elastic / gang semantics')."""

    gang: bool = True
    priority: int = 0
    # Max seconds a gang may sit Pending before the job is marked Failed.
    admission_timeout_s: Optional[float] = None


@dataclass
class ElasticPolicy:
    """Elastic world sizing for the Worker replica set (TorchElastic-style
    min/max bounds translated to TPU gang semantics). When set, a Drained
    worker (reclaim notice honored, runtime/kubelet.py) shrinks the gang
    to the surviving count instead of triggering a whole-gang
    restart-from-checkpoint — as long as the survivors stay >=
    ``min_replicas`` — and the controller grows the gang back toward the
    spec count (debounced by ``resize_debounce_s``) when capacity
    returns. Resizes never consume ``backoff_limit``. On real TPU slices
    the resize granularity is a WHOLE slice (a slice admits and fails as
    a unit), so validation rejects bounds that are not slice-aligned."""

    min_replicas: Optional[int] = None
    max_replicas: Optional[int] = None
    # Seconds a downsized gang must hold steady before scaling back up —
    # capacity that flaps must not thrash the mesh.
    resize_debounce_s: Optional[float] = None


@dataclass
class RunPolicy:
    clean_pod_policy: Optional[CleanPodPolicy] = None
    ttl_seconds_after_finished: Optional[float] = None
    active_deadline_seconds: Optional[float] = None
    # Whole-gang restarts-from-checkpoint before the job is failed.
    backoff_limit: Optional[int] = None
    # Kueue-style suspend: True evicts the gang (pods deleted, slices
    # returned to the pool) while keeping the job object; flipping back
    # to False re-admits and resumes from checkpoint.
    suspend: bool = False
    scheduling: SchedulingPolicy = field(default_factory=SchedulingPolicy)
    # Elastic world sizing (None = fixed-size gang, the legacy semantics).
    elastic: Optional[ElasticPolicy] = None


@dataclass
class TPUJobSpec:
    replica_specs: Dict[ReplicaType, ReplicaSpec] = field(default_factory=dict)
    tpu: TPUSpec = field(default_factory=TPUSpec)
    mesh: Optional[MeshSpec] = None
    run_policy: RunPolicy = field(default_factory=RunPolicy)


# ---------------------------------------------------------------------------
# Status
# ---------------------------------------------------------------------------


@dataclass
class Condition:
    type: JobConditionType
    status: bool = True
    reason: str = ""
    message: str = ""
    last_transition_time: float = field(default_factory=time.time, metadata=RFC3339)


@dataclass
class ReplicaStatus:
    active: int = 0
    succeeded: int = 0
    failed: int = 0
    restarts: int = 0


@dataclass
class TPUJobStatus:
    conditions: List[Condition] = field(default_factory=list)
    replica_statuses: Dict[ReplicaType, ReplicaStatus] = field(default_factory=dict)
    start_time: Optional[float] = field(default=None, metadata=RFC3339)
    completion_time: Optional[float] = field(default=None, metadata=RFC3339)
    # Whole-gang restarts performed so far (counts against backoff_limit).
    gang_restarts: int = 0
    # Times this job's gang was evicted without failing: preempted by a
    # higher-priority job, or suspended via RunPolicy.suspend. An
    # eviction IS a gang restart for the resume contract (the recreated
    # gang restores from checkpoint) but does NOT consume backoff_limit.
    preemptions: int = 0
    # Checkpoint step the gang last persisted (resume point on restart).
    checkpoint_step: Optional[int] = None
    # Elastic state (RunPolicy.elastic): the CURRENT effective Worker
    # count (None = the spec-desired count), and a monotonically bumped
    # world version rendered into every pod as TFK8S_WORLD_VERSION — a
    # resize re-forms the mesh at the new size and the nonzero version
    # makes the relaunched processes resume from the drain checkpoint.
    elastic_replicas: Optional[int] = None
    world_version: int = 0


# ---------------------------------------------------------------------------
# Serving (TPUServe): the inference workload — a replicated, dynamically
# batched model server with rolling updates and a queue-depth autoscaler.
# The training CRD reconciles a *gang* (all-or-nothing, fails as a unit);
# serving replicas are deliberately independent: each holds its own model
# copy, so the controller can surge/drain them one at a time.
# ---------------------------------------------------------------------------


class ServeConditionType(str, enum.Enum):
    AVAILABLE = "Available"    # ready replicas >= spec.replicas, all updated
    PROGRESSING = "Progressing"  # a rollout or scale is converging
    DEGRADED = "Degraded"      # validation failed / replicas crash-looping


@dataclass
class ServeCondition:
    type: ServeConditionType
    status: bool = True
    reason: str = ""
    message: str = ""
    last_transition_time: float = field(default_factory=time.time, metadata=RFC3339)


@dataclass
class SamplingParams:
    """Per-request token sampling knobs (models/gpt.filter_logits
    semantics, threaded per-row through the packed decode step).
    ``temperature`` 0 means greedy — bit-identical to the argmax path;
    ``top_k`` 0 and ``top_p`` 1.0 disable their cuts. ``seed`` plus the
    absolute-position PRNG fold make a sampled stream deterministic
    under resume (preemption spill/restore, KV handoff).

    This dataclass IS the wire contract for a request's ``sampling``
    block: runtime/server's request parsing normalizes through
    :meth:`from_payload`, so the defaults and ranges here are what the
    serving path enforces."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    @classmethod
    def from_payload(cls, raw: Any) -> "SamplingParams":
        """Normalize a request payload's ``sampling`` block. Accepts both
        wire casings (``topK``/``top_k``) since gateway payloads arrive
        camelCase while tests speak snake_case. Raises ``ValueError`` on
        malformed blocks and out-of-range knobs — callers on the serving
        path re-type it as their client-visible InvalidRequest."""
        if not isinstance(raw, dict):
            raise ValueError(
                f"sampling must be a dict, got {type(raw).__name__}"
            )

        def _get(snake: str, camel: str, default):
            return raw.get(snake, raw.get(camel, default))

        try:
            params = cls(
                temperature=float(_get("temperature", "temperature", 0.0)),
                top_k=int(_get("top_k", "topK", 0)),
                top_p=float(_get("top_p", "topP", 1.0)),
                seed=int(_get("seed", "seed", 0)),
            )
        except (TypeError, ValueError):
            raise ValueError(f"malformed sampling block: {raw!r}") from None
        if params.temperature < 0:
            raise ValueError(
                f"temperature must be >= 0, got {params.temperature}"
            )
        if params.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {params.top_k}")
        if not 0.0 < params.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {params.top_p}")
        return params

    def as_tuple(self) -> "tuple":
        """The (temperature, top_k, top_p, seed) form the decode loop
        threads through the packed device step."""
        return (self.temperature, self.top_k, self.top_p, self.seed)


@dataclass
class SchedulerPolicy:
    """Token-scheduler knobs for the decode loop (runtime/sched).
    ``policy`` picks admission order: ``fifo`` (arrival order, the
    default — bit-identical to pre-scheduler behavior) or ``priority``
    (per-priority-class queues, aged weighted pick; a request gains one
    priority level per ``aging_s`` seconds queued, the anti-starvation
    bound). ``preemption`` (priority policy only) lets a stalled
    higher-priority admission spill a low-priority row's KV pages to a
    host buffer and requeue it. ``spec_decode`` enables speculative
    decoding: a ``spec_draft``-sized draft model proposes ``spec_tokens``
    tokens per row and the serving model verifies them in one packed
    step — output token-identical to plain decoding, throughput up by
    the accept ratio."""

    policy: str = "fifo"
    preemption: bool = True
    aging_s: float = 5.0
    spec_decode: bool = False
    spec_tokens: int = 4
    spec_draft: str = "tiny"


@dataclass
class BatchingPolicy:
    """Dynamic micro-batching knobs (runtime/server.py): a batch closes at
    ``max_batch_size`` or after ``batch_timeout_ms`` — whichever first —
    and the request queue is bounded at ``queue_limit``; past it, submits
    shed with the typed overload error instead of queuing unboundedly
    (Clipper-style adaptive batching under a latency SLO).

    Generative tasks run the continuous-batching decode loop instead:
    ``max_batch_size`` becomes the decode SLOT capacity (rows admitted
    and retired at token granularity), and the block-paged KV cache is
    sized by ``page_size`` (tokens per page) × ``max_pages`` (pool
    pages, one reserved as the trash page) — admission is gated on the
    pool covering a request's worst-case prompt + generation budget, so
    out-of-pages stalls admission and never corrupts live rows."""

    max_batch_size: int = 8
    batch_timeout_ms: float = 10.0
    queue_limit: int = 128
    # block-paged KV cache (decode loop only; ignored by classifiers)
    page_size: int = 16
    max_pages: int = 256
    # token scheduler (decode loop only): admission order, preemption,
    # speculative decode — see SchedulerPolicy
    scheduler: SchedulerPolicy = field(default_factory=SchedulerPolicy)


@dataclass
class RollingUpdatePolicy:
    """Deployment-style surge rollout: during an update at most
    ``max_surge`` replicas exist above ``spec.replicas``, and the count of
    READY replicas never drops below ``replicas - max_unavailable`` (old
    replicas drain before deletion, gated on new ones passing readiness)."""

    max_surge: int = 1
    max_unavailable: int = 0


@dataclass
class AutoscalePolicy:
    """Queue-depth autoscaling: the controller smooths the replicas'
    reported queue depth (EMA) and sizes ``replicas`` to hold the
    per-replica depth near ``target_queue_depth``. Hysteresis bands
    (scale up only above ``target * high_band``, down only below
    ``target * low_band``) plus ``cooldown_s`` between scale events keep
    it from flapping."""

    enabled: bool = False
    min_replicas: int = 1
    max_replicas: int = 4
    target_queue_depth: float = 4.0
    high_band: float = 1.25
    low_band: float = 0.5
    cooldown_s: float = 30.0


@dataclass
class DisaggregationPolicy:
    """Splitwise/DistServe-style phase disaggregation: the serve runs
    TWO labeled replica pools — prefill (compute-bound, bursty) and
    decode (memory-bound, steady) — instead of one. The gateway runs
    chunked prefill on a prefill replica, moves the warm KV across the
    pool seam (runtime/handoff.py), and admits the row directly into a
    decode replica's loop; a prompt burst then queues on the prefill
    pool instead of stalling in-flight generations. Present in the spec
    ⇒ pool counts REPLACE ``spec.replicas`` and each pool autoscales
    off its own signal (prefill queue depth vs decode slot occupancy);
    absent ⇒ single-pool serving, bit-for-bit today's behavior."""

    prefill_replicas: int = 1
    decode_replicas: int = 1


@dataclass
class KVTierPolicy:
    """The KV economy (runtime/kvtier): tiered prefix-cache residency —
    device page pool, host-RAM LRU behind it, and peer pulls over the
    KV transport, with a gateway cache directory steering affinity
    routing at actual cache contents. Present in the spec ⇒ each
    replica runs a ``host_bytes``-bounded host tier (device evictions
    demote instead of drop), the gateway polls per-replica digest
    reports and overrides the consistent-hash guess on a fresh
    directory hit, and a miss routed next to a warm peer pulls the
    prefix instead of re-prefilling; absent ⇒ bit-for-bit today's
    behavior (no demotions, no directory traffic, no peer pulls)."""

    #: host-tier capacity per replica, in bytes of serialized prefix
    #: buffers (0 disables the host tier but keeps the directory)
    host_bytes: int = 64 << 20
    #: pull warm prefixes from directory-advertised peers on a local miss
    peer_fetch: bool = True
    #: directory staleness bound — reports older than this are ignored
    #: (a wrong entry costs only a fallback prefill, so this trades
    #: report traffic against routing accuracy, not correctness)
    directory_ttl_s: float = 5.0


@dataclass
class TenantQuota:
    """One tenant's admission budget at the gateway (gateway/admission.py).
    ``qps``/``burst`` parameterize a reservation-style token bucket
    (client/ratelimit.py); ``max_concurrency`` caps in-flight requests
    (0 = unlimited); ``priority`` orders tenants under overload — when the
    target replica set saturates, LOWER priorities shed first."""

    qps: float = 100.0
    # bucket capacity in requests; 0 defaults to max(1, ceil(qps))
    burst: int = 0
    max_concurrency: int = 0
    priority: int = 0


@dataclass
class TenantPolicy:
    """Multi-tenant admission at the serving front door. Tenants are
    identified by the request's ``X-Tenant`` header (map keys are data and
    pass through the wire verbatim, like labels); a tenant absent from
    ``tenants`` gets its OWN bucket sized by ``default_quota``. Disabled
    (the default) the gateway admits everything and only the replicas'
    bounded queues shed. Quota edits deliberately do NOT change the
    pod-template hash — tightening a tenant must never roll the serving
    pods."""

    enabled: bool = False
    tenants: Dict[str, TenantQuota] = field(default_factory=dict)
    default_quota: TenantQuota = field(default_factory=TenantQuota)


@dataclass
class TPUServeSpec:
    """What to serve and how. ``task`` names a registered served-model
    family (runtime/server.py: ``echo`` / ``mlp`` / ``gpt``);
    ``checkpoint`` is the model-weights ref the server loads before
    reporting Ready (``seed:<n>`` for hermetic deterministic params, or a
    checkpoint directory/URI). Changing ``checkpoint`` (or the template /
    batching) changes the pod-template hash and triggers a rolling
    update."""

    task: str = ""
    checkpoint: str = ""
    replicas: int = 1
    # image/env parity with training replicas; entrypoint defaults to the
    # in-process model server (runtime/server.py:serve)
    template: ContainerSpec = field(default_factory=ContainerSpec)
    batching: BatchingPolicy = field(default_factory=BatchingPolicy)
    rolling_update: RollingUpdatePolicy = field(default_factory=RollingUpdatePolicy)
    autoscale: AutoscalePolicy = field(default_factory=AutoscalePolicy)
    # gateway admission only — excluded from the pod-template hash
    tenancy: TenantPolicy = field(default_factory=TenantPolicy)
    tpu: TPUSpec = field(default_factory=TPUSpec)
    # phase-split pools (None = single-pool serving, today's behavior);
    # changing pool COUNTS scales in place, but adding/removing the
    # block itself rolls the template (the pods' phase env changes)
    disaggregation: Optional[DisaggregationPolicy] = None
    # KV economy (None = single-tier prefix cache, today's behavior);
    # knob changes roll the template — host capacity renders into the
    # pods' env, so the hash must see it
    kv_tier: Optional[KVTierPolicy] = None


@dataclass
class TPUServeStatus:
    conditions: List[ServeCondition] = field(default_factory=list)
    # live (non-terminal, non-deleting) serving pods observed
    replicas: int = 0
    # live pods that loaded the checkpoint and passed the health probe
    ready_replicas: int = 0
    # live pods rendered from the CURRENT pod-template hash
    updated_replicas: int = 0
    # the template hash fully rolled out (== desired once a rollout ends)
    observed_version: str = ""
    # smoothed load signals the autoscaler acts on (mirrored from the
    # replicas' per-pod reports)
    queue_depth: float = 0.0
    qps: float = 0.0
    last_scale_time: Optional[float] = field(default=None, metadata=RFC3339)
    # gateway route for this serve (path under the gateway's base URL)
    endpoint: str = ""


@dataclass
class TPUServe:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: TPUServeSpec = field(default_factory=TPUServeSpec)
    status: TPUServeStatus = field(default_factory=TPUServeStatus)
    api_version: str = API_VERSION
    kind: str = "TPUServe"

    def deepcopy(self) -> "TPUServe":
        return copy.deepcopy(self)


# ---------------------------------------------------------------------------
# Top-level objects
# ---------------------------------------------------------------------------


@dataclass
class TPUJob:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: TPUJobSpec = field(default_factory=TPUJobSpec)
    status: TPUJobStatus = field(default_factory=TPUJobStatus)
    api_version: str = API_VERSION
    kind: str = "TPUJob"

    def deepcopy(self) -> "TPUJob":
        return copy.deepcopy(self)


@dataclass
class PodSpec:
    containers: List[ContainerSpec] = field(default_factory=list)
    # Topology placement request: which slice / which host within the slice
    # this task must land on (filled by the trainer, consumed by the
    # scheduler; SURVEY.md §7 hard part 1).
    node_selector: Dict[str, str] = field(default_factory=dict)
    restart_policy: RestartPolicy = RestartPolicy.NEVER
    scheduler_name: str = "gang"


@dataclass
class PodStatus:
    phase: PodPhase = PodPhase.PENDING
    exit_code: Optional[int] = None
    message: str = ""
    host: str = ""
    restarts: int = 0
    # Bounded container-log tail captured by the kubelet (the hermetic
    # analogue of `kubectl logs`: real k8s proxies the kubelet for logs;
    # here the tail rides pod status so any client — including the remote
    # apiserver path — reads it with a plain GET, no kubelet proxy).
    log_tail: List[str] = field(default_factory=list)
    # Latest training-progress values reported by the entrypoint
    # (runtime/progress.py): step, steps_per_sec, examples_per_sec,
    # step_seconds. Published by the kubelet's flush loop; the operator
    # mirrors them into per-job /metrics series.
    training: Dict[str, float] = field(default_factory=dict)


@dataclass
class Pod:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)
    api_version: str = "v1"
    kind: str = "Pod"

    def deepcopy(self) -> "Pod":
        return copy.deepcopy(self)


@dataclass
class ServicePort:
    name: str = ""
    port: int = 0


@dataclass
class ServiceSpec:
    selector: Dict[str, str] = field(default_factory=dict)
    ports: List[ServicePort] = field(default_factory=list)


@dataclass
class Service:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ServiceSpec = field(default_factory=ServiceSpec)
    api_version: str = "v1"
    kind: str = "Service"

    def deepcopy(self) -> "Service":
        return copy.deepcopy(self)


@dataclass
class LeaseSpec:
    holder: str = ""
    lease_duration_s: float = 15.0
    acquire_time: Optional[float] = field(default=None, metadata=RFC3339)
    renew_time: Optional[float] = field(default=None, metadata=RFC3339)
    lease_transitions: int = 0


@dataclass
class Lease:
    """Leader-election lease (SURVEY.md C17: 'uses the leaderelection
    package for high availability', k8s-operator.md:59,237)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: LeaseSpec = field(default_factory=LeaseSpec)
    api_version: str = "coordination/v1"
    kind: str = "Lease"


@dataclass
class Event:
    """A control-plane event as an API OBJECT (k8s core/v1 Event parity):
    the operator's EventRecorder mirrors its in-memory log into these so
    any client — including `describe`/`get --kind events` across the
    HTTP apiserver — can read a job's history without reaching into the
    operator process. Aggregated k8s-style: one object per (involved
    object, reason), bumping ``count``/``last_timestamp`` on repeats."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    involved_kind: str = ""
    involved_key: str = ""  # namespace/name of the involved object
    reason: str = ""
    message: str = ""
    count: int = 1
    first_timestamp: Optional[float] = field(default=None, metadata=RFC3339)
    last_timestamp: Optional[float] = field(default=None, metadata=RFC3339)
    api_version: str = "core/v1"
    kind: str = "Event"


# All registerable top-level kinds, for the scheme (serde.py).
TOP_LEVEL_KINDS = {
    "TPUJob": TPUJob,
    "TPUServe": TPUServe,
    "Pod": Pod,
    "Service": Service,
    "Lease": Lease,
    "Event": Event,
}
