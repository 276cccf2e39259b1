"""TPUJob spec validation — the ``validation/validation.go`` equivalent
(SURVEY.md C7). Returns the full list of problems (field path + message)
rather than failing fast, so a user fixes a spec in one round trip.
"""

from __future__ import annotations

import re
from typing import List

from tfk8s_tpu_torch.api.types import ReplicaType, TPUJob, TPUServe
from tfk8s_tpu_torch.utils import topology as topo

# DNS-1123 label: what k8s accepts for object names.
_NAME_RE = re.compile(r"^[a-z0-9]([-a-z0-9]*[a-z0-9])?$")
MAX_NAME_LEN = 63


class ValidationError(ValueError):
    def __init__(self, errors: List[str]):
        self.errors = errors
        super().__init__("; ".join(errors))


def validate(job: TPUJob) -> List[str]:
    """Validate a (defaulted) TPUJob. Returns a list of error strings —
    empty means valid."""
    errs: List[str] = []
    meta, spec = job.metadata, job.spec

    if not meta.name:
        errs.append("metadata.name: required")
    elif len(meta.name) > MAX_NAME_LEN or not _NAME_RE.match(meta.name):
        errs.append(
            f"metadata.name: {meta.name!r} must be a DNS-1123 label "
            f"(<= {MAX_NAME_LEN} chars, [a-z0-9-])"
        )
    if not meta.namespace:
        errs.append("metadata.namespace: required")

    if not spec.replica_specs:
        errs.append("spec.replicaSpecs: at least one replica set is required")
    for rtype, rspec in spec.replica_specs.items():
        path = f"spec.replicaSpecs[{rtype.value}]"
        if rspec.replicas is not None and rspec.replicas < 0:
            errs.append(f"{path}.replicas: must be >= 0, got {rspec.replicas}")
        if rtype == ReplicaType.CHIEF and (rspec.replicas or 0) > 1:
            errs.append(f"{path}.replicas: at most one Chief, got {rspec.replicas}")
        if not rspec.template.entrypoint and not rspec.template.image:
            errs.append(f"{path}.template: entrypoint or image is required")
        if rspec.max_restarts is not None and rspec.max_restarts < 0:
            errs.append(f"{path}.maxRestarts: must be >= 0")
    compute = {
        rt: rs
        for rt, rs in spec.replica_specs.items()
        if rt in (ReplicaType.CHIEF, ReplicaType.WORKER)
    }
    n_compute = sum(rs.replicas or 0 for rs in compute.values())
    if spec.replica_specs and n_compute == 0:
        errs.append(
            "spec.replicaSpecs: at least one Chief or Worker replica is required"
        )

    info = None
    if spec.tpu.accelerator:
        try:
            info = topo.parse_accelerator(spec.tpu.accelerator, spec.tpu.topology)
        except topo.TopologyError as e:
            errs.append(f"spec.tpu: {e}")
    if spec.tpu.num_slices < 1:
        errs.append(f"spec.tpu.numSlices: must be >= 1, got {spec.tpu.num_slices}")
    if spec.tpu.provider not in ("", "gke"):
        errs.append(
            f"spec.tpu.provider: must be '' (hermetic) or 'gke', "
            f"got {spec.tpu.provider!r}"
        )
    elif spec.tpu.provider == "gke" and info is not None:
        if info.generation not in topo.GKE_ACCELERATOR:
            errs.append(
                f"spec.tpu.provider: 'gke' has no nodepool shape for "
                f"generation {info.generation!r} "
                f"(supported: {sorted(set(topo.GKE_ACCELERATOR))})"
            )

    # Gang consistency: the compute replicas are the slice's hosts. One pod
    # per host, whose ranks take its cards (runtime/pod_ranks.py), so
    # compute replica count must equal hosts-per-slice x num_slices.
    if info is not None and info.generation != "cpu":
        want = info.hosts * max(spec.tpu.num_slices, 1)
        if n_compute and n_compute != want:
            errs.append(
                f"spec.replicaSpecs: {n_compute} compute replicas (Chief+Worker) "
                f"but {spec.tpu.accelerator} x{spec.tpu.num_slices} has {want} "
                f"host(s); one process per host"
            )

    if spec.mesh is not None:
        for name, size in spec.mesh.axes.items():
            if size < 1:
                errs.append(f"spec.mesh.axes[{name}]: must be >= 1, got {size}")
        if info is not None:
            want = info.chips * max(spec.tpu.num_slices, 1)
            if spec.mesh.size() != want:
                errs.append(
                    f"spec.mesh: axes product {spec.mesh.size()} != total chips {want} "
                    f"({spec.tpu.accelerator} x {spec.tpu.num_slices})"
                )

    el = job.spec.run_policy.elastic
    if el is not None:
        path = "spec.runPolicy.elastic"
        worker = spec.replica_specs.get(ReplicaType.WORKER)
        n_workers = (worker.replicas if worker else None) or 0
        if not job.spec.run_policy.scheduling.gang:
            errs.append(f"{path}: requires gang scheduling (resize re-forms the gang)")
        if worker is None:
            errs.append(f"{path}: requires a Worker replica set to resize")
        mn, mx = el.min_replicas or 0, el.max_replicas or 0
        if mn < 1:
            errs.append(f"{path}.minReplicas: must be >= 1, got {mn}")
        if mx < mn:
            errs.append(
                f"{path}.maxReplicas: must be >= minReplicas ({mn}), got {mx}"
            )
        if worker is not None and not mn <= n_workers <= mx:
            errs.append(
                f"{path}: Worker replicas {n_workers} outside "
                f"[minReplicas={mn}, maxReplicas={mx}]"
            )
        if el.resize_debounce_s is not None and el.resize_debounce_s < 0:
            errs.append(
                f"{path}.resizeDebounceS: must be >= 0, got {el.resize_debounce_s}"
            )
        if info is not None and info.generation != "cpu":
            # TPU resize granularity is a WHOLE slice: a slice admits and
            # fails as a unit, so the gang cannot shrink below (or sit
            # between) slice boundaries. One process per host means the
            # boundary is hosts-per-slice.
            if ReplicaType.CHIEF in spec.replica_specs:
                errs.append(
                    f"{path}: elastic TPU gangs must be Worker-only "
                    "(a Chief pins process 0 outside the resizable set)"
                )
            for fname, v in (("minReplicas", mn), ("maxReplicas", mx)):
                if v and info.hosts and v % info.hosts:
                    errs.append(
                        f"{path}.{fname}: {v} is not a multiple of "
                        f"hosts-per-slice ({info.hosts}) — a gang cannot "
                        "shrink below a slice boundary"
                    )
            if spec.mesh is not None and set(spec.mesh.axes) != {"data"}:
                errs.append(
                    f"{path}: only a pure data-parallel mesh can be "
                    f"re-derived on resize (got axes "
                    f"{sorted(spec.mesh.axes)})"
                )

    rp = job.spec.run_policy
    if rp.backoff_limit is not None and rp.backoff_limit < 0:
        errs.append("spec.runPolicy.backoffLimit: must be >= 0")
    if rp.active_deadline_seconds is not None and rp.active_deadline_seconds <= 0:
        errs.append("spec.runPolicy.activeDeadlineSeconds: must be > 0")
    if rp.ttl_seconds_after_finished is not None and rp.ttl_seconds_after_finished < 0:
        errs.append("spec.runPolicy.ttlSecondsAfterFinished: must be >= 0")

    return errs


def validate_or_raise(job: TPUJob) -> None:
    errs = validate(job)
    if errs:
        raise ValidationError(errs)


def validate_serve(serve: TPUServe) -> List[str]:
    """Validate a (defaulted) TPUServe; empty list means valid."""
    errs: List[str] = []
    meta, spec = serve.metadata, serve.spec

    if not meta.name:
        errs.append("metadata.name: required")
    elif len(meta.name) > MAX_NAME_LEN or not _NAME_RE.match(meta.name):
        errs.append(
            f"metadata.name: {meta.name!r} must be a DNS-1123 label "
            f"(<= {MAX_NAME_LEN} chars, [a-z0-9-])"
        )
    if not meta.namespace:
        errs.append("metadata.namespace: required")

    if not spec.task:
        errs.append("spec.task: required (a registered served-model family)")
    if spec.replicas < 0:
        errs.append(f"spec.replicas: must be >= 0, got {spec.replicas}")
    if not spec.template.entrypoint and not spec.template.image:
        errs.append("spec.template: entrypoint or image is required")

    b = spec.batching
    if b.max_batch_size < 1:
        errs.append(f"spec.batching.maxBatchSize: must be >= 1, got {b.max_batch_size}")
    if b.batch_timeout_ms < 0:
        errs.append(
            f"spec.batching.batchTimeoutMs: must be >= 0, got {b.batch_timeout_ms}"
        )
    if b.queue_limit < b.max_batch_size:
        errs.append(
            f"spec.batching.queueLimit: must be >= maxBatchSize "
            f"({b.max_batch_size}), got {b.queue_limit}"
        )
    if b.page_size < 1:
        errs.append(f"spec.batching.pageSize: must be >= 1, got {b.page_size}")
    if b.max_pages < 2:
        # page 0 is the reserved trash page — a pool of 1 could never
        # admit anything (the model-side max_len fit is checked at
        # replica startup, where max_len is known)
        errs.append(
            f"spec.batching.maxPages: must be >= 2 (trash page + 1 usable), "
            f"got {b.max_pages}"
        )
    sch = b.scheduler
    if sch.policy not in ("fifo", "priority"):
        errs.append(
            f"spec.batching.scheduler.policy: must be 'fifo' or 'priority', "
            f"got {sch.policy!r}"
        )
    if sch.aging_s <= 0:
        errs.append(
            f"spec.batching.scheduler.agingS: must be > 0, got {sch.aging_s}"
        )
    if sch.spec_tokens < 1:
        errs.append(
            f"spec.batching.scheduler.specTokens: must be >= 1, "
            f"got {sch.spec_tokens}"
        )
    if sch.spec_draft not in ("tiny", "mid", "base"):
        errs.append(
            f"spec.batching.scheduler.specDraft: must be one of "
            f"('tiny', 'mid', 'base'), got {sch.spec_draft!r}"
        )

    ru = spec.rolling_update
    if ru.max_surge < 0 or ru.max_unavailable < 0:
        errs.append("spec.rollingUpdate: maxSurge and maxUnavailable must be >= 0")
    if ru.max_surge == 0 and ru.max_unavailable == 0:
        errs.append(
            "spec.rollingUpdate: maxSurge and maxUnavailable cannot both be 0 "
            "(no replica could ever be replaced)"
        )

    a = spec.autoscale
    if a.enabled:
        if a.min_replicas < 1:
            # scale-to-zero would be a one-way door: the scale-up signal
            # is the replicas' own queue-depth reports, and zero replicas
            # report nothing — an external activator (not built) is the
            # prerequisite for min 0
            errs.append(f"spec.autoscale.minReplicas: must be >= 1, got {a.min_replicas}")
        if a.max_replicas < max(a.min_replicas, 1):
            errs.append(
                f"spec.autoscale.maxReplicas: must be >= max(minReplicas, 1), "
                f"got {a.max_replicas}"
            )
        if a.target_queue_depth <= 0:
            errs.append(
                f"spec.autoscale.targetQueueDepth: must be > 0, got "
                f"{a.target_queue_depth}"
            )
        if not (a.low_band < 1.0 <= a.high_band):
            errs.append(
                "spec.autoscale: need lowBand < 1.0 <= highBand "
                f"(got low={a.low_band}, high={a.high_band}) — overlapping "
                "bands would oscillate"
            )
        if a.cooldown_s < 0:
            errs.append(f"spec.autoscale.cooldownS: must be >= 0, got {a.cooldown_s}")

    d = spec.disaggregation
    if d is not None:
        if spec.task not in ("gpt", "t5"):
            # phase splitting only means something for generative tasks:
            # the handoff plane moves KV pages, which classifiers and
            # echo replicas don't have
            errs.append(
                f"spec.disaggregation: only generative tasks (gpt, t5) "
                f"can split prefill/decode pools, got task {spec.task!r}"
            )
        if d.prefill_replicas < 1:
            errs.append(
                f"spec.disaggregation.prefillReplicas: must be >= 1, "
                f"got {d.prefill_replicas}"
            )
        if d.decode_replicas < 1:
            errs.append(
                f"spec.disaggregation.decodeReplicas: must be >= 1, "
                f"got {d.decode_replicas}"
            )

    kv = spec.kv_tier
    if kv is not None:
        if spec.task not in ("gpt", "t5"):
            # the KV economy moves prompt-prefix K/V pages between
            # tiers; only generative tasks have any
            errs.append(
                f"spec.kvTier: only generative tasks (gpt, t5) have a "
                f"KV cache to tier, got task {spec.task!r}"
            )
        if kv.host_bytes < 0:
            errs.append(
                f"spec.kvTier.hostBytes: must be >= 0, got {kv.host_bytes}"
            )
        if kv.directory_ttl_s <= 0:
            errs.append(
                f"spec.kvTier.directoryTtlS: must be > 0, got "
                f"{kv.directory_ttl_s}"
            )

    ten = spec.tenancy
    if ten.enabled:
        for path, quota in [
            ("spec.tenancy.defaultQuota", ten.default_quota),
            *((f"spec.tenancy.tenants[{name!r}]", q)
              for name, q in sorted(ten.tenants.items())),
        ]:
            if quota.qps < 0:
                errs.append(f"{path}.qps: must be >= 0, got {quota.qps}")
            if quota.burst < 0:
                errs.append(f"{path}.burst: must be >= 0, got {quota.burst}")
            if quota.max_concurrency < 0:
                errs.append(
                    f"{path}.maxConcurrency: must be >= 0, got "
                    f"{quota.max_concurrency}"
                )
        for name in sorted(ten.tenants):
            if not name:
                errs.append("spec.tenancy.tenants: tenant name cannot be empty")

    if spec.tpu.accelerator:
        try:
            topo.parse_accelerator(spec.tpu.accelerator, spec.tpu.topology)
        except topo.TopologyError as e:
            errs.append(f"spec.tpu: {e}")

    return errs


def validate_serve_or_raise(serve: TPUServe) -> None:
    errs = validate_serve(serve)
    if errs:
        raise ValidationError(errs)
