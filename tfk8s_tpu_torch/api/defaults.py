"""Defaulting for TPUJob specs — the ``defaults.go`` equivalent (SURVEY.md
C6). Idempotent: ``set_defaults(set_defaults(job)) == set_defaults(job)``.

Defaults chosen to mirror the reference's semantics where they exist:
``restart_policy`` defaults to OnFailure — the in-place-restart behavior the
doc singles out (k8s-operator.md:47-49) — and PS replicas default to Always
(a parameter server is a long-running service, never 'done'). TPU-specific
defaults (mesh = pure data-parallel over all chips) are new surface.
"""

from __future__ import annotations

import math

from tfk8s_tpu_torch.api.types import (
    CleanPodPolicy,
    MeshSpec,
    ReplicaType,
    RestartPolicy,
    TPUJob,
    TPUServe,
)
from tfk8s_tpu_torch.utils import topology as topo

DEFAULT_ACCELERATOR = "cpu-1"
DEFAULT_MAX_RESTARTS = 3
DEFAULT_BACKOFF_LIMIT = 3
# Seconds a downsized elastic gang holds steady before scaling back up.
DEFAULT_RESIZE_DEBOUNCE_S = 5.0

# The in-process model server (runtime/server.py): what a TPUServe pod
# runs unless the template pins another entrypoint.
DEFAULT_SERVE_ENTRYPOINT = "tfk8s_tpu_torch.runtime.server:serve"


def set_defaults(job: TPUJob) -> TPUJob:
    """Fill unset spec fields in place and return the job."""
    spec = job.spec

    for rtype, rspec in spec.replica_specs.items():
        if rspec.replicas is None:
            rspec.replicas = 1
        if rspec.restart_policy is None:
            rspec.restart_policy = (
                RestartPolicy.ALWAYS if rtype == ReplicaType.PS else RestartPolicy.ON_FAILURE
            )
        if rspec.max_restarts is None:
            rspec.max_restarts = DEFAULT_MAX_RESTARTS

    if not spec.tpu.accelerator:
        spec.tpu.accelerator = DEFAULT_ACCELERATOR
    # num_slices < 1 is left as-is: validation reports it (clamping here
    # would make the numSlices validation error unreachable).

    rp = spec.run_policy
    if rp.clean_pod_policy is None:
        rp.clean_pod_policy = CleanPodPolicy.RUNNING
    if rp.backoff_limit is None:
        rp.backoff_limit = DEFAULT_BACKOFF_LIMIT

    el = rp.elastic
    if el is not None:
        if el.resize_debounce_s is None:
            el.resize_debounce_s = DEFAULT_RESIZE_DEBOUNCE_S
        worker = spec.replica_specs.get(ReplicaType.WORKER)
        if el.max_replicas is None:
            el.max_replicas = (worker.replicas if worker else None) or 1
        if el.min_replicas is None:
            # the smallest world a resize may shrink to: one host on the
            # hermetic backend, one whole slice on real TPU (a slice
            # admits and fails as a unit — validation enforces alignment)
            try:
                info = topo.parse_accelerator(
                    spec.tpu.accelerator, spec.tpu.topology
                )
                el.min_replicas = 1 if info.generation == "cpu" else info.hosts
            except topo.TopologyError:
                el.min_replicas = 1

    # Default mesh: one pure data-parallel axis over every chip in the job.
    if spec.mesh is None:
        try:
            info = topo.parse_accelerator(spec.tpu.accelerator, spec.tpu.topology)
            spec.mesh = MeshSpec(axes={"data": info.chips * max(spec.tpu.num_slices, 1)})
        except topo.TopologyError:
            pass  # malformed accelerator -> leave unset; validation reports it

    return job


def set_serve_defaults(serve: TPUServe) -> TPUServe:
    """Fill unset TPUServe spec fields in place and return it. Idempotent,
    like :func:`set_defaults`."""
    spec = serve.spec
    if not spec.template.entrypoint and not spec.template.image:
        spec.template.entrypoint = DEFAULT_SERVE_ENTRYPOINT
    if not spec.tpu.accelerator:
        spec.tpu.accelerator = DEFAULT_ACCELERATOR
    auto = spec.autoscale
    if auto.enabled:
        # the autoscaler owns replicas between its bounds; a spec count
        # outside them is clamped rather than rejected (HPA semantics)
        spec.replicas = min(max(spec.replicas, auto.min_replicas), auto.max_replicas)
        if spec.disaggregation is not None:
            # each phase pool is autoscaled independently against the
            # same bounds (per-pool signals, trainer/serve_controller)
            d = spec.disaggregation
            d.prefill_replicas = min(
                max(d.prefill_replicas, auto.min_replicas), auto.max_replicas
            )
            d.decode_replicas = min(
                max(d.decode_replicas, auto.min_replicas), auto.max_replicas
            )
    ten = spec.tenancy
    if ten.enabled:
        # burst=0 means "one second's worth of tokens, at least 1" — the
        # smallest bucket that still admits a full-rate steady stream
        for quota in [ten.default_quota, *ten.tenants.values()]:
            if quota.burst == 0 and quota.qps > 0:
                quota.burst = max(1, math.ceil(quota.qps))
    return serve
