"""Selector labels tying pods/services to their job, replica set, and task
index — the ``pkg/trainer/labels.go`` equivalent (SURVEY.md C19). The
reference's serving labels come with the port's serving controller
(ROADMAP item 18).
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

