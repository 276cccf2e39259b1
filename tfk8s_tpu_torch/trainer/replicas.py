"""Replica materialization: TPUJob -> per-task pods + services — the
``pkg/trainer/replicas.go`` equivalent (SURVEY.md C18).

A copy of the JAX package's ``trainer/replicas.py`` with the GPU device
resource: a pod requests ``nvidia.com/gpu`` (its host's cards) where the
reference requests ``google.com/tpu``, and ``provider: gke`` selects GKE's
``cloud.google.com/gke-accelerator`` node label. The env contract below is
the reference's unchanged, read by the port's launcher
(``runtime/launcher.py``), which joins ``torch.distributed`` where the
reference calls ``jax.distributed.initialize``.

The reference renders each task a pod whose env carries the hand-built TF
cluster spec (``{cluster:{ps:[...],worker:[...]}, job, task_index}`` —
k8s-operator.md:4,6; SURVEY.md §3.3). The TPU-native contract replaces
TF_CONFIG with JAX distributed-coordination env (SURVEY.md §2 'Distributed
communication backend'):

- ``TFK8S_COORDINATOR_ADDRESS`` — process 0's service address, consumed by
  ``jax.distributed.initialize``;
- ``TFK8S_PROCESS_ID`` / ``TFK8S_NUM_PROCESSES`` — this task's global rank;
- ``TFK8S_MESH`` — the logical mesh axes the data plane builds;
- ``TFK8S_SLICE_ID`` / ``TFK8S_HOST_INDEX`` — placement within the gang
  (multislice jobs see their slice for DCN-aware layouts);
- ``TFK8S_CLUSTER_SPEC`` — full role->endpoints map, kept for API parity
  with the reference's cluster spec.

Placement rides ``node_selector`` (slice + host), written by the gang
allocator's assignment so the scheduler/kubelet puts each process on the
host whose chips it will attach to (SURVEY.md §3.3 device boundary).
"""

from __future__ import annotations

import json
from typing import List

from tfk8s_tpu_torch.api import helpers
from tfk8s_tpu_torch.api.types import (
    ContainerSpec,
    ObjectMeta,
    OwnerReference,
    Pod,
    PodSpec,
    ReplicaType,
    RestartPolicy,
    Service,
    ServicePort,
    ServiceSpec,
    TPUJob,
)
from tfk8s_tpu_torch.trainer import labels as L
from tfk8s_tpu_torch.trainer.gang import GangAssignment
from tfk8s_tpu_torch.utils.topology import GKE_ACCELERATOR

CHECKPOINT_DIR_ANNOTATION = "tfk8s.dev/checkpoint-dir"
# the device-plugin resource of an NVIDIA card
GPU_RESOURCE = "nvidia.com/gpu"


def owner_ref(job: TPUJob) -> OwnerReference:
    return OwnerReference(kind=job.kind, name=job.metadata.name, uid=job.metadata.uid)


def coordination_env(
    job: TPUJob, rtype: ReplicaType, index: int, assignment: GangAssignment
) -> dict:
    pid = helpers.process_index(job, rtype, index)
    slice_id, host_index = assignment.host_of(pid)
    env = {
        "TFK8S_JOB_NAME": job.metadata.name,
        "TFK8S_NAMESPACE": job.metadata.namespace,
        "TFK8S_REPLICA_TYPE": rtype.value,
        "TFK8S_REPLICA_INDEX": str(index),
        "TFK8S_PROCESS_ID": str(pid),
        "TFK8S_NUM_PROCESSES": str(helpers.total_replicas(job)),
        "TFK8S_COORDINATOR_ADDRESS": helpers.coordinator_address(job),
        "TFK8S_CLUSTER_SPEC": json.dumps(helpers.cluster_endpoints(job)),
        "TFK8S_ACCELERATOR": job.spec.tpu.accelerator,
        "TFK8S_TOPOLOGY": job.spec.tpu.topology,
        "TFK8S_NUM_SLICES": str(max(job.spec.tpu.num_slices, 1)),
        "TFK8S_SLICE_ID": slice_id,
        "TFK8S_HOST_INDEX": str(host_index),
        # restarts + preemptions: either one means "this incarnation is a
        # re-launch; restore from checkpoint" (launcher resume contract)
        "TFK8S_GANG_RESTARTS": str(
            job.status.gang_restarts + job.status.preemptions
        ),
        # elastic world identity: bumped by the controller on every gang
        # resize, so a relaunched process knows its world was re-formed
        # (launcher resume contract) and stale-world pods are
        # identifiable during the resize drain
        "TFK8S_WORLD_VERSION": str(job.status.world_version),
    }
    if job.spec.mesh is not None:
        env["TFK8S_MESH"] = json.dumps(job.spec.mesh.axes)
    ckpt = job.metadata.annotations.get(CHECKPOINT_DIR_ANNOTATION)
    if ckpt:
        env["TFK8S_CHECKPOINT_DIR"] = ckpt
    return env


def render_pod(
    job: TPUJob, rtype: ReplicaType, index: int, assignment: GangAssignment
) -> Pod:
    rspec = job.spec.replica_specs[rtype]
    name = helpers.replica_name(job.metadata.name, rtype, index)
    pid = helpers.process_index(job, rtype, index)
    slice_id, host_index = assignment.host_of(pid)
    tmpl = rspec.template
    resources = dict(tmpl.resources)
    sl = assignment.handle_of(pid)
    if sl.info.generation != "cpu":
        # the pod's device request: every card of its host (a pod is one
        # host's process, and its ranks take cards 0..d-1)
        resources.setdefault(GPU_RESOURCE, str(sl.info.chips_per_host))
    if job.spec.tpu.provider == "gke":
        # GKE-shaped rendering: a real GPU nodepool's nodes carry only the
        # cloud.google.com/* labels, so that is the ONLY selector (ANDed
        # selectors naming tfk8s.dev/* would leave the pod Pending
        # forever); the gang allocator's placement rides the pod labels
        # instead. Validation admits gke only for a generation GKE has a
        # nodepool of.
        node_selector = {
            "cloud.google.com/gke-accelerator": GKE_ACCELERATOR[sl.info.generation],
        }
    else:
        # Node labels name PHYSICAL properties: a carved sub-slice's pods
        # must select the parent slice's accelerator type, id, and the
        # box-offset host index — real nodes are labeled with what they
        # ARE, not what the job asked for (two jobs carved from one
        # h100-16 land on disjoint physical hosts of that h100-16).
        if sl.physical is not None:
            phys_acc, phys_slice = sl.physical.info.accelerator, sl.physical.slice_id
        else:
            phys_acc, phys_slice = job.spec.tpu.accelerator, slice_id
        node_selector = {
            "tfk8s.dev/accelerator": phys_acc,
            "tfk8s.dev/slice": phys_slice,
            "tfk8s.dev/host": str(assignment.global_host_of(pid)),
        }
    container = ContainerSpec(
        entrypoint=tmpl.entrypoint,
        image=tmpl.image,
        command=list(tmpl.command),
        args=list(tmpl.args),
        env={**tmpl.env, **coordination_env(job, rtype, index, assignment)},
        resources=resources,
    )
    lbls = L.replica_labels(job.metadata.name, rtype, index)
    lbls[L.SLICE_ID] = slice_id
    lbls[L.HOST_INDEX] = str(host_index)
    return Pod(
        metadata=ObjectMeta(
            name=name,
            namespace=job.metadata.namespace,
            labels=lbls,
            owner_references=[owner_ref(job)],
        ),
        spec=PodSpec(
            containers=[container],
            restart_policy=rspec.restart_policy or RestartPolicy.ON_FAILURE,
            node_selector=node_selector,
        ),
    )


def render_service(job: TPUJob, rtype: ReplicaType, index: int) -> Service:
    """Per-task service providing the stable DNS name used in
    cluster_endpoints (SURVEY.md §3.3: each task addressable by name)."""
    name = helpers.replica_name(job.metadata.name, rtype, index)
    return Service(
        metadata=ObjectMeta(
            name=name,
            namespace=job.metadata.namespace,
            labels=L.replica_labels(job.metadata.name, rtype, index),
            owner_references=[owner_ref(job)],
        ),
        spec=ServiceSpec(
            selector=L.replica_labels(job.metadata.name, rtype, index),
            ports=[ServicePort(name="coord", port=helpers.DEFAULT_PORT)],
        ),
    )


def render_all(job: TPUJob, assignment: GangAssignment) -> tuple:
    """Every pod + service of the gang, in process-id order."""
    pods: List[Pod] = []
    services: List[Service] = []
    for rtype in helpers.sorted_replica_types(job):
        for i in range(job.spec.replica_specs[rtype].replicas or 0):
            pods.append(render_pod(job, rtype, i, assignment))
            services.append(render_service(job, rtype, i))
    return pods, services
