"""Shared spec/status helpers — the ``helper/helpers.go`` equivalent
(SURVEY.md C8): replica naming, condition bookkeeping, terminal-state
queries, and the cluster-endpoints map (the TF_CONFIG ``cluster`` section's
TPU-native descendant, consumed by the trainer to wire the port launcher's
``torch.distributed`` rendezvous — SURVEY.md §2 'Distributed communication
backend').
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from tfk8s_tpu_torch.api.types import (
    Condition,
    JobConditionType,
    ReplicaType,
    ServeCondition,
    ServeConditionType,
    TPUJob,
    TPUJobStatus,
    TPUServeStatus,
)

# Stable ordering for process-id assignment: chief is always process 0.
REPLICA_ORDER = [
    ReplicaType.CHIEF,
    ReplicaType.WORKER,
    ReplicaType.PS,
    ReplicaType.EVALUATOR,
]

DEFAULT_PORT = 8471  # coordination/service port per task


def replica_name(job_name: str, rtype: ReplicaType, index: int) -> str:
    """Deterministic per-task name, e.g. ``mnist-worker-0`` — the analogue of
    the reference's label/name scheme in pkg/trainer/labels.go (C19)."""
    return f"{job_name}-{rtype.value.lower()}-{index}"


def sorted_replica_types(job: TPUJob) -> List[ReplicaType]:
    return [rt for rt in REPLICA_ORDER if rt in job.spec.replica_specs]


def total_replicas(job: TPUJob) -> int:
    return sum(rs.replicas or 0 for rs in job.spec.replica_specs.values())


def process_index(job: TPUJob, rtype: ReplicaType, index: int) -> int:
    """Global process id of a task: replica sets in REPLICA_ORDER, tasks in
    index order. Chief (or Worker 0 when no chief) is process 0 — the
    rendezvous' coordinator."""
    pid = 0
    for rt in sorted_replica_types(job):
        if rt == rtype:
            return pid + index
        pid += job.spec.replica_specs[rt].replicas or 0
    raise KeyError(f"replica type {rtype} not in job {job.metadata.name}")


def cluster_endpoints(job: TPUJob, port: int = DEFAULT_PORT) -> Dict[str, List[str]]:
    """Role -> list of ``host:port`` endpoints, one per task; hostnames are
    the per-task service names the trainer creates. This is the structural
    equivalent of TF_CONFIG's ``cluster`` map (k8s-operator.md:6) that the
    reference's users previously built by hand (k8s-operator.md:4)."""
    out: Dict[str, List[str]] = {}
    ns = job.metadata.namespace
    for rt in sorted_replica_types(job):
        n = job.spec.replica_specs[rt].replicas or 0
        out[rt.value.lower()] = [
            f"{replica_name(job.metadata.name, rt, i)}.{ns}:{port}" for i in range(n)
        ]
    return out


def coordinator_address(job: TPUJob, port: int = DEFAULT_PORT) -> str:
    """Address of process 0 — the coordinator of the launcher's
    ``torch.distributed`` rendezvous (``runtime/launcher.py``)."""
    for rt in sorted_replica_types(job):
        if (job.spec.replica_specs[rt].replicas or 0) > 0:
            return f"{replica_name(job.metadata.name, rt, 0)}.{job.metadata.namespace}:{port}"
    raise ValueError(f"job {job.metadata.name} has no replicas")


# ---------------------------------------------------------------------------
# Conditions (level-triggered status bookkeeping)
# ---------------------------------------------------------------------------


def get_condition(status: TPUJobStatus, ctype: JobConditionType) -> Optional[Condition]:
    for c in status.conditions:
        if c.type == ctype:
            return c
    return None


def has_condition(status: TPUJobStatus, ctype: JobConditionType) -> bool:
    c = get_condition(status, ctype)
    return c is not None and c.status


def set_condition(
    status: TPUJobStatus, ctype: JobConditionType, reason: str = "", message: str = ""
) -> bool:
    """Set condition ``ctype`` true (clearing mutually-exclusive run-state
    conditions). Returns True iff the status changed — callers use this to
    skip no-op status writes (the update-filter pattern,
    k8s-operator.md:142-150)."""
    exclusive = {
        JobConditionType.RUNNING,
        JobConditionType.RESTARTING,
        JobConditionType.SUSPENDED,
        JobConditionType.SUCCEEDED,
        JobConditionType.FAILED,
    }
    changed = False
    existing = get_condition(status, ctype)
    if (
        existing is not None
        and existing.status
        and existing.reason == reason
        and existing.message == message
    ):
        return False
    if ctype in exclusive:
        for c in status.conditions:
            if c.type in exclusive and c.type != ctype and c.status:
                c.status = False
                c.last_transition_time = time.time()
                changed = True
    if existing is None:
        status.conditions.append(
            Condition(type=ctype, status=True, reason=reason, message=message)
        )
        changed = True
    else:
        existing.status = True
        existing.reason = reason
        existing.message = message
        existing.last_transition_time = time.time()
        changed = True
    return changed


# -- TPUServe conditions (same level-triggered bookkeeping, but serve
#    conditions are NOT mutually exclusive: Available and Progressing can
#    both be true mid-rollout, deployment-style) ---------------------------


def get_serve_condition(
    status: TPUServeStatus, ctype: ServeConditionType
) -> Optional[ServeCondition]:
    for c in status.conditions:
        if c.type == ctype:
            return c
    return None


def serve_condition_is(status: TPUServeStatus, ctype: ServeConditionType) -> bool:
    c = get_serve_condition(status, ctype)
    return c is not None and c.status


def set_serve_condition(
    status: TPUServeStatus,
    ctype: ServeConditionType,
    value: bool = True,
    reason: str = "",
    message: str = "",
) -> bool:
    """Set condition ``ctype`` to ``value``; returns True iff anything
    changed (callers skip no-op status writes on False)."""
    existing = get_serve_condition(status, ctype)
    if (
        existing is not None
        and existing.status == value
        and existing.reason == reason
        and existing.message == message
    ):
        return False
    if existing is None:
        status.conditions.append(
            ServeCondition(type=ctype, status=value, reason=reason, message=message)
        )
    else:
        existing.status = value
        existing.reason = reason
        existing.message = message
        existing.last_transition_time = time.time()
    return True


def is_succeeded(status: TPUJobStatus) -> bool:
    return has_condition(status, JobConditionType.SUCCEEDED)


def is_failed(status: TPUJobStatus) -> bool:
    return has_condition(status, JobConditionType.FAILED)


def is_finished(status: TPUJobStatus) -> bool:
    return is_succeeded(status) or is_failed(status)
