"""Selector labels tying pods/services to their job, replica set, and task
index — the ``pkg/trainer/labels.go`` equivalent (SURVEY.md C19).
"""

from __future__ import annotations

from typing import Dict

from tfk8s_tpu_torch.api.types import ReplicaType

JOB_NAME = "tfk8s.dev/job-name"
REPLICA_TYPE = "tfk8s.dev/replica-type"
REPLICA_INDEX = "tfk8s.dev/replica-index"
SLICE_ID = "tfk8s.dev/slice-id"
HOST_INDEX = "tfk8s.dev/host-index"
CONTROLLER = "tfk8s.dev/controller"
CONTROLLER_NAME = "tpujob-operator"
# Serving (TPUServe) pods: owner + the pod-template hash they were
# rendered from (the rolling-update version identity, Deployment's
# pod-template-hash analogue).
SERVE_NAME = "tfk8s.dev/serve-name"
SERVE_VERSION = "tfk8s.dev/serve-version"
# Disaggregated serving: which phase pool a replica belongs to
# ("prefill" / "decode"; absent on single-pool serves)
SERVE_PHASE = "tfk8s.dev/serve-phase"


def job_selector(job_name: str) -> Dict[str, str]:
    """Selector matching every pod/service of a job."""
    return {JOB_NAME: job_name, CONTROLLER: CONTROLLER_NAME}


def replica_labels(job_name: str, rtype: ReplicaType, index: int) -> Dict[str, str]:
    return {
        JOB_NAME: job_name,
        CONTROLLER: CONTROLLER_NAME,
        REPLICA_TYPE: rtype.value,
        REPLICA_INDEX: str(index),
    }


def replica_type_selector(job_name: str, rtype: ReplicaType) -> Dict[str, str]:
    return {**job_selector(job_name), REPLICA_TYPE: rtype.value}


def serve_selector(serve_name: str) -> Dict[str, str]:
    """Selector matching every serving replica pod of a TPUServe."""
    return {SERVE_NAME: serve_name, CONTROLLER: CONTROLLER_NAME}


def serve_version_labels(serve_name: str, version: str) -> Dict[str, str]:
    return {**serve_selector(serve_name), SERVE_VERSION: version}


def serve_phase_selector(serve_name: str, phase: str) -> Dict[str, str]:
    """Selector matching ONE phase pool of a disaggregated serve."""
    return {**serve_selector(serve_name), SERVE_PHASE: phase}
