"""The TPUJob controller: level-triggered reconcile of TPUJob -> gang of
pods/services (SURVEY.md C15 + C18 joined, re-designed for TPU gang
semantics).

Reconcile contract (idempotent; every step safe to repeat — SURVEY.md §7
hard part 2):

1. key -> cache lookup; a missing object means 'deleted' -> release the
   gang (k8s-operator.md:162-164).
2. ``deletion_timestamp`` set -> finalizer logic: tear down replicas,
   release slices, strip the finalizer so the store completes the delete
   (k8s-operator.md:36-43; SURVEY.md §3.4).
3. default + validate; invalid specs -> Failed(ValidationFailed).
4. finished jobs -> clean-pod policy + TTL; completed pods are *kept*
   unless policy says otherwise (k8s-operator.md:50-52).
5. gang admission (all-or-nothing, SURVEY.md §7 hard part 1); short
   capacity -> requeue with event, optional admission timeout -> Failed.
6. create missing pods/services (level-triggered: compares desired vs
   observed, never assumes its own last write survived).
7. failure handling (k8s-operator.md:47-49 translated to slices):
   - gang mode (TPU): any failed pod -> whole-gang restart-from-checkpoint
     while ``backoff_limit`` lasts, then Failed;
   - per-pod mode (cpu/hermetic, gang=False): OnFailure/Always restart the
     task in place up to ``max_restarts``; Never -> replacement pods are
     NOT created, job fails (the reference's Never-vs-OnFailure split).
8. status: replica counts, Created/Running/Succeeded/Failed conditions,
   ``active_deadline_seconds`` enforcement.
"""

from __future__ import annotations

import re
import time
from typing import List, Optional

from tfk8s_tpu_torch.api import helpers, serde, set_defaults, validate
from tfk8s_tpu_torch.api.types import (
    CleanPodPolicy,
    JobConditionType,
    Pod,
    PodPhase,
    ReplicaStatus,
    ReplicaType,
    RestartPolicy,
    TPUJob,
)
from tfk8s_tpu_torch.client.clientset import Clientset
from tfk8s_tpu_torch.client.informer import SharedIndexInformer, ResourceEventHandler
from tfk8s_tpu_torch.client.listers import Lister
from tfk8s_tpu_torch.client.store import Conflict, NotFound
from tfk8s_tpu_torch.controller.controller import Controller
from tfk8s_tpu_torch.obs.trace import TRACEPARENT_ENV, Tracer, get_tracer
from tfk8s_tpu_torch.trainer import labels as L
from tfk8s_tpu_torch.trainer import replicas as R
from tfk8s_tpu_torch.trainer.gang import SliceAllocator
from tfk8s_tpu_torch.utils.logging import EventRecorder, Metrics, get_logger

log = get_logger("tpujob")

FINALIZER = "tfk8s.dev/job-cleanup"
RESTARTS_ANNOTATION = "tfk8s.dev/restarts"
PENDING_REQUEUE_S = 0.5

# Env keys derived from per-sync controller state rather than the job
# spec — the SliceAllocator's in-memory placement and the creating
# sync's trace context; excluded from the stale-render diff in
# _reconcile_replicas so an operator restart (fresh placement, fresh
# trace ids) doesn't churn running gangs.
_PLACEMENT_ENV_KEYS = frozenset(
    {"TFK8S_SLICE_ID", "TFK8S_HOST_INDEX", TRACEPARENT_ENV}
)

# Training-progress keys mirrored from pod status into per-job labeled
# gauges on /metrics (runtime/progress.py -> runtime/kubelet.py -> here).
_TRAINING_GAUGE_KEYS = (
    "steps_per_sec",
    "examples_per_sec",
    "step",
    "compile_seconds",
    "input_mb_per_sec",
    "input_wait_seconds",
    "input_starved_steps",
    # the decode pool's delivered rate (image input) — the series the
    # image-input-ceiling operator alert watches, next to input MB/s
    "decoded_images_per_sec",
)

# Node-lost detection (k8s node-lease semantics): a RUNNING pod whose
# node's heartbeat Lease (runtime/kubelet.py NODE_LEASE_PREFIX) has been
# stale for GRACE x lease_duration is marked Failed(NodeLost), feeding
# the ordinary failure path (gang restart-from-checkpoint). Nodes that
# never wrote a lease are exempt — there is no liveness contract to
# break. Jobs with running pods are re-checked every CHECK_PERIOD
# because a dead node emits no events to wake the reconciler.
NODE_LOST_GRACE = 2.0
NODE_CHECK_PERIOD_S = 2.0

# Elastic resize (RunPolicy.elastic): grace the controller gives the
# surviving pods to finish their in-flight step and commit a drain
# checkpoint before the world re-forms at the new size. Past the
# deadline a still-running old-world pod is hard-deleted (the
# SIGTERM->SIGKILL escalation). Tests shrink this via monkeypatch.
RESIZE_DRAIN_GRACE_S = 5.0
RESIZE_POLL_S = 0.1


def _contract_env(pod) -> dict:
    return {
        k: v
        for k, v in pod.spec.containers[0].env.items()
        if k not in _PLACEMENT_ENV_KEYS
    }


def _rendered_before(pod, generation: int) -> bool:
    """True when ``pod`` was rendered while the job had fewer than
    ``generation`` gang restarts and preemptions (its
    ``TFK8S_GANG_RESTARTS``, trainer/replicas.py)."""
    env = pod.spec.containers[0].env if pod.spec.containers else {}
    try:
        return int(env["TFK8S_GANG_RESTARTS"]) < generation
    except (KeyError, ValueError):
        return False


class TPUJobController:
    """Owns the TPUJob/Pod/Service informers and the reconcile logic."""

    def __init__(
        self,
        clientset: Clientset,
        allocator: Optional[SliceAllocator] = None,
        recorder: Optional[EventRecorder] = None,
        metrics: Optional[Metrics] = None,
        resync_period: float = 0.0,
        tracer: Optional[Tracer] = None,
    ):
        self.cs = clientset
        self.allocator = allocator or SliceAllocator()
        # default recorder mirrors events into the cluster as Event
        # objects (utils/logging.py EventRecorder sink) so `describe` /
        # `get --kind events` work across the apiserver
        self.recorder = recorder or EventRecorder(sink=clientset)
        self.metrics = metrics or Metrics()
        self.tracer = tracer or get_tracer()

        self.job_informer = SharedIndexInformer(
            clientset.tpujobs(namespace=None), resync_period, name="tpujob",
            metrics=self.metrics,
        )
        self.pod_informer = SharedIndexInformer(
            clientset.pods(namespace=None), resync_period, name="pod",
            metrics=self.metrics,
        )
        self.svc_informer = SharedIndexInformer(
            clientset.services(namespace=None), resync_period, name="service",
            metrics=self.metrics,
        )
        self.jobs = Lister(self.job_informer.indexer, "TPUJob")
        self.pods = Lister(self.pod_informer.indexer, "Pod")
        self.services = Lister(self.svc_informer.indexer, "Service")

        self.controller = Controller(
            "tpujob",
            self.sync,
            informers=[self.job_informer, self.pod_informer, self.svc_informer],
            recorder=self.recorder,
            metrics=self.metrics,
            kind="TPUJob",
            tracer=self.tracer,
        )
        self.job_informer.add_event_handler(self.controller.default_handler())
        # Pod/Service events reconcile their owning job (the enqueuePod
        # pattern of k8s-operator.md:132-139, re-keyed to the owner) —
        # with the reference's update filter (k8s-operator.md:142-150):
        # a pod update that only refreshed status.log_tail (the kubelet's
        # periodic log flush) changes nothing a reconcile acts on, and
        # enqueueing it would cost one full job sync per chatty pod per
        # flush interval.
        self.pod_informer.add_event_handler(ResourceEventHandler(
            on_add=self._enqueue_owner,
            on_update=self._pod_updated,
            on_delete=self._enqueue_owner,
        ))
        self.svc_informer.add_event_handler(ResourceEventHandler(
            on_add=self._enqueue_owner,
            on_update=lambda old, new: self._enqueue_owner(new),
            on_delete=self._enqueue_owner,
        ))
        for mname, help_text in (
            ("tfk8s_status_patches_skipped_total",
             "Status writes skipped because the computed status deep-"
             "compared equal to the cached server state."),
            ("tpujob.pods_created_total", "Pods created by the reconciler."),
            ("tpujob.pods_deleted_total", "Pods deleted by the reconciler."),
            ("tpujob.gang_restarts_total", "Whole-gang restarts from checkpoint."),
            ("tpujob.gang_pending_total", "Syncs that found no gang capacity."),
            ("tpujob.succeeded_total", "Jobs that reached Succeeded."),
            ("tpujob.preemptions_total", "Gangs evicted for higher priority."),
            ("tpujob.suspensions_total", "Gangs parked by RunPolicy.suspend."),
            ("tpujob.node_lost_pods_total", "Running pods failed via stale node lease."),
            ("tfk8s_elastic_resizes_total",
             "Elastic gang resizes, labeled by direction (up/down)."),
            ("tfk8s_drain_checkpoint_seconds",
             "Drain-checkpoint commit latency reported by reclaimed workers."),
            ("tpujob.recovery_seconds",
             "Seconds from resize start to the resized gang Running."),
            ("gang.free_slices", "Free whole slices per accelerator type."),
            ("tpujob.training.steps_per_sec", "Per-job reported training step rate."),
            ("tpujob.training.step_seconds", "Per-job distribution of step wall time."),
            ("tpujob.training.compile_seconds", "Per-job first-step compile time."),
            ("tpujob.training.input_starved_steps", "Per-job steps that waited on input."),
        ):
            self.metrics.describe(mname, help_text)
        # gang release needs the uid after the job object is gone
        self._uid_by_key: dict = {}
        # pod name -> restart count to stamp on the next recreation
        self._pending_restart_counts: dict = {}
        # evaluator pod uids whose terminal failure was already recorded
        # (their Failed pods persist, re-observed by every reconcile)
        self._evaluator_failures_seen: set = set()
        # job key -> gang_restarts floor: the recreate sync can run off a
        # stale cached job whose status predates the increment write; a
        # pod rendered with the old TFK8S_GANG_RESTARTS would repeat the
        # pre-restart run and burn a second unit of backoff_limit
        self._gang_restarts_floor: dict = {}
        # same stale-cache protection for the preemption counter
        self._preemptions_floor: dict = {}
        # job key -> (world_version, elastic_replicas) floor: a resize's
        # status write may not be in the informer cache yet; rendering
        # off the pre-resize world would recreate the OLD gang size
        self._elastic_floor: dict = {}
        # job key -> (start time, direction) of the resize in flight —
        # closed into the per-job recovery_seconds gauge and the
        # job.resize trace span when the resized gang reaches Running
        self._resize_started: dict = {}
        # job key -> wall time of the last resize (scale-up debounce)
        self._last_resize: dict = {}

    def _enqueue_owner(self, obj) -> None:
        meta = getattr(obj, "obj", obj).metadata  # unwrap DeletedFinalStateUnknown
        job_name = meta.labels.get(L.JOB_NAME)
        if job_name:
            self.controller.enqueue_key(f"{meta.namespace}/{job_name}")

    def _pod_updated(self, old: Pod, new: Pod) -> None:
        # Mirror reported training progress into per-job /metrics series
        # (VERDICT r2 next #8): a running job's step rate and throughput
        # are operator-visible without touching the reconcile path.
        if new.status.training and new.status.training != old.status.training:
            job = new.metadata.labels.get(L.JOB_NAME)
            # only for a LIVE owner: a late pod update delivered after
            # _finalize pruned the job's series must not resurrect them
            # (the job is gone or carries its deletion timestamp by then)
            owner = None
            if job:
                owner = self.jobs.get_by_key(f"{new.metadata.namespace}/{job}")
            if owner is not None and owner.metadata.deletion_timestamp is None:
                # LABELED series (one name, per-job label set): deletion
                # GCs exactly this job's series via remove_labels —
                # metric names stay fixed as jobs come and go
                job_labels = {"namespace": new.metadata.namespace, "job": job}
                for k in _TRAINING_GAUGE_KEYS:
                    if k in new.status.training:
                        self.metrics.set_gauge(
                            f"tpujob.training.{k}",
                            new.status.training[k],
                            job_labels,
                        )
                if "step_seconds" in new.status.training:
                    self.metrics.observe(
                        "tpujob.training.step_seconds",
                        new.status.training["step_seconds"],
                        job_labels,
                    )
                # a reclaimed worker reports its drain-checkpoint commit
                # latency exactly once per drain (runtime/train.py) —
                # mirror it into the operator histogram
                drain_s = new.status.training.get("drain_checkpoint_seconds")
                if drain_s is not None and drain_s != old.status.training.get(
                    "drain_checkpoint_seconds"
                ):
                    self.metrics.observe(
                        "tfk8s_drain_checkpoint_seconds", drain_s, job_labels
                    )
        if (
            old.metadata.resource_version != new.metadata.resource_version
            and old.metadata.uid == new.metadata.uid
            and old.metadata.deletion_timestamp == new.metadata.deletion_timestamp
            and old.status.phase == new.status.phase
            and old.status.exit_code == new.status.exit_code
            and old.status.message == new.status.message
            and old.status.restarts == new.status.restarts
            and old.status.host == new.status.host
            and old.spec == new.spec
            and (
                old.status.log_tail != new.status.log_tail
                or old.status.training != new.status.training
            )
        ):
            return  # log-flush/progress-only refresh; nothing to reconcile
        self._enqueue_owner(new)

    def run(self, workers: Optional[int] = None, stop=None, block: bool = True) -> bool:
        from tfk8s_tpu_torch.controller.controller import DEFAULT_SYNC_WORKERS

        return self.controller.run(
            DEFAULT_SYNC_WORKERS if workers is None else workers, stop, block=block
        )

    # ------------------------------------------------------------------ sync

    def sync(self, key: str) -> None:
        ns, name = key.split("/", 1)
        with self.tracer.start_span("lister.get", attributes={"key": key}):
            job = self.jobs.get_by_key(key)
        if job is None:
            # Object gone from cache: release any gang it held
            uid = self._uid_by_key.pop(key, None)
            if uid:
                self.allocator.release(uid)
                self._export_capacity_gauges()
            self._prune_job_state(key)
            return

        if job.metadata.deletion_timestamp is not None:
            self._finalize(job)
            return

        # The lister returned the SHARED frozen cached instance; roundtrip
        # gives this sync a private mutable copy to default and edit.
        cached_status_wire = serde.to_wire(job.status)
        job = set_defaults(serde.roundtrip(job))  # work on a defaulted copy
        # Baseline for the status-write skip (_write_status): the status
        # the server currently holds (as cached). A computed status that
        # deep-compares equal means the patch round trip would be a
        # no-op — skip it and count the skip.
        job._status_baseline = cached_status_wire
        errs = validate(job)
        if errs:
            if helpers.set_condition(
                job.status,
                JobConditionType.FAILED,
                reason="ValidationFailed",
                message="; ".join(errs),
            ):
                self.recorder.event("TPUJob", key, "ValidationFailed", "; ".join(errs))
                self._write_status(job)
            # A job can become invalid *after* admission (spec edited while
            # running): still tear down and release its slices.
            self._cleanup_finished(job)
            return

        self._uid_by_key[key] = job.metadata.uid

        if helpers.is_finished(job.status):
            self._cleanup_finished(job)
            return

        # Ensure our finalizer before creating anything it must clean up.
        # The finalizers LIST replaces wholesale under merge-patch, so the
        # write carries an rv precondition: without it a finalizer some
        # other writer added concurrently would be silently clobbered.
        if FINALIZER not in job.metadata.finalizers:
            try:
                self.cs.tpujobs(ns).patch(
                    job.metadata.name,
                    {"metadata": {
                        "resourceVersion": str(job.metadata.resource_version),
                        "finalizers": job.metadata.finalizers + [FINALIZER],
                    }},
                )
            except Conflict:
                self.controller.enqueue_key(job.metadata.key)
            return  # patched object re-enqueues via the watch

        changed = helpers.set_condition(
            job.status, JobConditionType.CREATED, reason="JobCreated"
        )
        if changed:
            self.recorder.event("TPUJob", key, "JobCreated")

        # Kueue-style suspend (RunPolicy.suspend): evict the gang, free
        # the slices, park the job until the flag clears — then the
        # ordinary admission path below re-admits and the eviction
        # counter makes the relaunched gang resume from checkpoint.
        if job.spec.run_policy.suspend:
            self._suspend(job)
            return
        sus = helpers.get_condition(job.status, JobConditionType.SUSPENDED)
        if sus is not None and sus.status:
            sus.status = False
            # restart the admission clock: a job parked (possibly since
            # birth) for days must not be insta-failed AdmissionTimeout
            # measured against its CREATED transition
            created_cond = helpers.get_condition(
                job.status, JobConditionType.CREATED
            )
            if created_cond is not None:
                created_cond.last_transition_time = time.time()
            if self._write_status(job):
                self.recorder.event("TPUJob", key, "JobResumed")
            # fall through to ordinary admission: the eviction counter
            # makes the relaunched gang resume from checkpoint

        # Elastic world sizing: admit + render at the EFFECTIVE worker
        # count (status.elastic_replicas), not the spec-desired one — the
        # spec stays the user's intent, the status carries the resize.
        self._clamp_elastic_floor(job)
        self._apply_elastic_override(job)

        # Gang admission (SURVEY.md §7 hard part 1)
        ga = self.allocator.admit(job)
        if ga is None:
            ga = self._try_preempt(job)
        self._export_capacity_gauges()
        if ga is None:
            self.recorder.event(
                "TPUJob", key, "GangPending",
                f"insufficient capacity for {job.spec.tpu.accelerator} "
                f"x{job.spec.tpu.num_slices}",
            )
            self.metrics.inc("tpujob.gang_pending_total")
            timeout = job.spec.run_policy.scheduling.admission_timeout_s
            created = helpers.get_condition(job.status, JobConditionType.CREATED)
            # The timeout bounds INITIAL admission only (never-started
            # jobs). A job that already ran can land here after a demand
            # edit the pool can't satisfy (allocator kept the old gang)
            # or after being PREEMPTED (gang released, awaiting
            # re-admission) — measuring either against job-creation time
            # would insta-fail a long-running job.
            if (
                helpers.has_condition(job.status, JobConditionType.RUNNING)
                or job.status.start_time is not None
                or job.status.preemptions > 0
            ):
                self.controller.enqueue_after(key, PENDING_REQUEUE_S)
                return
            if timeout and created and time.time() - created.last_transition_time > timeout:
                helpers.set_condition(
                    job.status, JobConditionType.FAILED,
                    reason="AdmissionTimeout",
                    message=f"gang not admitted within {timeout}s",
                )
                self._write_status(job)
                return
            if changed:
                self._write_status(job)
            self.controller.enqueue_after(key, PENDING_REQUEUE_S)
            return

        # Deadline enforcement
        rp = job.spec.run_policy
        if (
            rp.active_deadline_seconds
            and job.status.start_time
            and time.time() - job.status.start_time > rp.active_deadline_seconds
        ):
            helpers.set_condition(
                job.status, JobConditionType.FAILED,
                reason="DeadlineExceeded",
                message=f"active for more than {rp.active_deadline_seconds}s",
            )
            self.recorder.event("TPUJob", key, "DeadlineExceeded")
            self._delete_job_pods(job, only_phases=None)
            self._write_status(job)
            return

        self._reconcile_replicas(job, ga, status_changed=changed)

    # ------------------------------------------------------- replica logic

    def _observed_pods(self, job: TPUJob) -> List[Pod]:
        return self.pods.list(job.metadata.namespace, L.job_selector(job.metadata.name))

    def _suspend(self, job: TPUJob) -> None:
        """Evict a suspended job's gang (idempotent: re-syncs of an
        already-suspended job are no-ops). The eviction bumps the same
        counter preemption uses, so un-suspending resumes from
        checkpoint without touching backoff_limit."""
        key = job.metadata.key
        if helpers.has_condition(job.status, JobConditionType.SUSPENDED):
            # already parked; make sure stragglers are gone AND the gang
            # is released (level-triggered: a transient failure between
            # the first pass's status write and its release must not
            # leak the slices for the park's duration — release is
            # idempotent)
            for pod in self._observed_pods(job):
                if pod.metadata.deletion_timestamp is None:
                    self._delete_pod(job.metadata.namespace, pod.metadata.name)
            self.allocator.release(job.metadata.uid)
            self._export_capacity_gauges()
            return
        if job.status.preemptions < self._preemptions_floor.get(key, 0):
            # The cache lags this controller's own eviction write: an event
            # of the evicted pods re-enqueued the job before the status
            # event carrying the Suspended condition (or the preemption
            # count) arrived. Suspending again from this copy would count
            # the suspension twice and patch the stale count back over
            # the written one (the status patch carries no
            # resourceVersion). The status event re-enqueues the job.
            return
        live = [
            p for p in self._observed_pods(job)
            if p.metadata.deletion_timestamp is None
        ]
        had_gang = self.allocator.assignment(job.metadata.uid) is not None
        # pods already draining from a prior eviction are NOT a live
        # incarnation — counting them would inflate the resume lineage
        if had_gang or live:
            job.status.preemptions += 1
        helpers.set_condition(
            job.status, JobConditionType.SUSPENDED,
            reason="JobSuspended",
            message=f"suspension {job.status.preemptions} (RunPolicy.suspend)",
        )
        # pause the active-deadline clock (kueue semantics: suspend
        # resets startTime) — parked hours must not count against
        # active_deadline_seconds; re-admission restamps it
        job.status.start_time = None
        if not self._write_status(job):
            return  # conflict: re-enqueued sync redoes the accounting
        # the floor rises only once the count is stored: were it raised
        # before a write that raised, no status event would ever lift the
        # cached count to it, and every later sync would return above
        self._preemptions_floor[key] = job.status.preemptions
        self.recorder.event("TPUJob", key, "JobSuspended")
        self.metrics.inc("tpujob.suspensions_total")
        self._delete_job_pods(job, only_phases=None)
        self.allocator.release(job.metadata.uid)
        self._export_capacity_gauges()

    def _try_preempt(self, job: TPUJob):
        """Priority preemption: when admission fails, evict the cheapest
        set of strictly-lower-priority same-generation gangs whose
        release provably lets this job admit (allocator dry-run — no
        feasible plan means NOBODY is evicted: evicting without one
        would livelock the cluster, churning victims while the job still
        never fits). The release-and-admit is ONE atomic allocator
        operation — a victim's own concurrent sync must not re-admit
        itself into the freed capacity ahead of the preemptor (priority
        inversion that would force a second eviction). Each victim's
        ``preemptions`` counter bumps so its eventual re-admission
        resumes from checkpoint without consuming backoff_limit; victim
        pods drain after the swap (k8s-style grace overlap). Returns the
        preemptor's GangAssignment, or None."""
        my_pri = job.spec.run_policy.scheduling.priority
        if my_pri <= 0 or not job.spec.run_policy.scheduling.gang:
            return None
        from tfk8s_tpu_torch.utils import topology as topo

        try:
            my_gen = topo.parse_accelerator(
                job.spec.tpu.accelerator, job.spec.tpu.topology
            ).generation
        except topo.TopologyError:
            return None
        if my_gen == "cpu":
            return None  # hermetic capacity is unlimited; nothing to evict

        def victim_key(v: TPUJob):
            # lowest priority first; among equals, youngest first (it has
            # the least sunk work)
            return (
                v.spec.run_policy.scheduling.priority,
                -(v.metadata.creation_timestamp or 0),
            )

        candidates = []
        for v in self.jobs.list(None):
            if v.metadata.uid == job.metadata.uid:
                continue
            if helpers.is_finished(v.status):
                continue
            if v.spec.run_policy.scheduling.priority >= my_pri:
                continue
            if self.allocator.assignment(v.metadata.uid) is None:
                continue
            try:
                v_gen = topo.parse_accelerator(
                    v.spec.tpu.accelerator, v.spec.tpu.topology
                ).generation
            except topo.TopologyError:
                continue
            if v_gen != my_gen:
                continue
            candidates.append(v)
        if not candidates:
            return None
        ordered = sorted(candidates, key=victim_key)
        plan = self.allocator.preemption_plan(
            job, [v.metadata.uid for v in ordered]
        )
        if plan is None:
            return None
        victims = [v for v in ordered if v.metadata.uid in set(plan)]
        # 1) atomic swap FIRST: victims' boxes -> preemptor's gang. On
        #    failure (a victim finished/released between plan and swap,
        #    shrinking the freed capacity) NOTHING happened — no status
        #    writes to roll back, no pods deleted for no benefit.
        ga = self.allocator.admit_with_preemption(
            job, [v.metadata.uid for v in victims]
        )
        if ga is None:
            return None
        # 2) persist each victim's eviction (checkpoint-resume contract)
        #    and drain its pods; its next sync re-queues it for capacity
        for victim in victims:
            if not self._persist_preemption(job, victim, my_pri):
                # narrow double-fault window (finished in the race, or
                # persistent write conflict): the eviction stands — log
                # so the missing resume counter is diagnosable
                log.warning(
                    "preempted %s but could not persist its eviction "
                    "counter", victim.metadata.key,
                )
            self._delete_job_pods(victim, only_phases=None)
            self.controller.enqueue_key(victim.metadata.key)
            log.info(
                "preempted %s (priority %d) for %s (priority %d)",
                victim.metadata.key,
                victim.spec.run_policy.scheduling.priority,
                job.metadata.key, my_pri,
            )
        return ga

    def _persist_preemption(self, job: TPUJob, victim: TPUJob, my_pri: int) -> bool:
        """Persist one victim's preemption (status counter + condition +
        events). Runs AFTER the atomic swap, so it does not check the
        allocator; but the status write still re-validates the FRESH
        object — a victim that finished in the race window must not be
        resurrected: set_condition(RESTARTING) would clear its terminal
        condition and re-run a completed job."""
        vkey = victim.metadata.key
        for _ in range(3):
            try:
                fresh = self.cs.tpujobs(victim.metadata.namespace).get(
                    victim.metadata.name
                )
            except NotFound:
                return False
            if (
                helpers.is_finished(fresh.status)
                or fresh.metadata.uid != victim.metadata.uid
                or fresh.spec.run_policy.scheduling.priority >= my_pri
            ):
                return False
            fresh.status.preemptions += 1
            helpers.set_condition(
                fresh.status, JobConditionType.RESTARTING,
                reason="Preempted",
                message=(
                    f"preemption {fresh.status.preemptions} by higher-"
                    f"priority job {job.metadata.key} "
                    f"(priority {my_pri} > "
                    f"{fresh.spec.run_policy.scheduling.priority})"
                ),
            )
            try:
                self.cs.tpujobs(victim.metadata.namespace).update_status(fresh)
                break
            except Conflict:
                continue
            except NotFound:
                return False
        else:
            return False
        self._preemptions_floor[vkey] = fresh.status.preemptions
        self.recorder.event(
            "TPUJob", vkey, "Preempted",
            f"by {job.metadata.key} (priority {my_pri})",
        )
        self.recorder.event(
            "TPUJob", job.metadata.key, "PreemptedOther", vkey,
        )
        self.metrics.inc("tpujob.preemptions_total")
        return True

    def _check_node_liveness(self, job: TPUJob, observed) -> None:
        """Mark RUNNING pods on heartbeat-dead nodes Failed(NodeLost) —
        k8s node-lease semantics (module constants above). A dead node
        emits no pod events, so jobs with running pods are re-enqueued on
        a short period to keep this check live."""
        from tfk8s_tpu_torch.runtime.kubelet import NODE_LEASE_PREFIX

        key = job.metadata.key
        ns = job.metadata.namespace
        now = time.time()
        running = [
            p for p in observed.values()
            if p.status.phase == PodPhase.RUNNING
            and p.metadata.deletion_timestamp is None
            and p.status.host
        ]
        # one Lease fetch per distinct HOST, not per pod — a gang's pods
        # share few hosts and this path re-runs every CHECK_PERIOD
        leases = self.cs.generic("Lease", "default")
        stale_by_host: dict = {}
        for host in {p.status.host for p in running}:
            try:
                lease = leases.get(NODE_LEASE_PREFIX + host)
            except NotFound:
                continue  # node never heartbeated; no liveness contract
            rt = lease.spec.renew_time
            if rt is None:
                rt = lease.spec.acquire_time or 0.0
            if now > rt + lease.spec.lease_duration_s * NODE_LOST_GRACE:
                stale_by_host[host] = (now - rt, lease.spec.lease_duration_s)
        for pod in running:
            if pod.status.host not in stale_by_host:
                continue
            age, duration = stale_by_host[pod.status.host]
            msg = (
                f"NodeLost: node {pod.status.host} lease stale for "
                f"{age:.1f}s (duration {duration}s)"
            )
            try:
                cur = self.cs.pods(ns).get(pod.metadata.name)
                if (
                    cur.metadata.uid != pod.metadata.uid
                    or cur.status.phase != PodPhase.RUNNING
                ):
                    continue
                # narrow status patch with an rv PRECONDITION: a pod that
                # reaches a terminal phase between the get and this write
                # must not be clobbered to NodeLost — the precondition
                # turns that race into a skipped write (the periodic node
                # check re-evaluates)
                self.cs.pods(ns).patch_status(
                    pod.metadata.name,
                    {"metadata": {
                        "resourceVersion": str(cur.metadata.resource_version)
                    },
                     "status": {
                        "phase": PodPhase.FAILED.value,
                        "message": msg,
                        "exitCode": None,
                    }},
                )
            except (Conflict, NotFound):
                continue
            # recorded once the mark lands: a sync that read a stale cache
            # (the pod already marked) must not count the pod again
            self.recorder.event("TPUJob", key, "NodeLost",
                                f"{pod.metadata.name}: {msg}")
            self.metrics.inc("tpujob.node_lost_pods_total")
        if running:
            self.controller.enqueue_after(key, NODE_CHECK_PERIOD_S)

    def _reconcile_replicas(self, job: TPUJob, ga, status_changed: bool) -> None:
        ns, key = job.metadata.namespace, job.metadata.key
        # Never render from a stale restart count (informer cache may lag
        # the increment write by a sync or two) — the recreated gang's
        # TFK8S_GANG_RESTARTS / resume contract depends on it.
        floor = self._gang_restarts_floor.get(key, 0)
        if job.status.gang_restarts < floor:
            job.status.gang_restarts = floor
        pfloor = self._preemptions_floor.get(key, 0)
        if job.status.preemptions < pfloor:
            job.status.preemptions = pfloor
        with self.tracer.start_span("diff", attributes={"job": key}):
            desired_pods, desired_svcs = R.render_all(job, ga)
            desired_names = {p.metadata.name for p in desired_pods}
            desired_svc_names = {s.metadata.name for s in desired_svcs}
            observed = {p.metadata.name: p for p in self._observed_pods(job)}
            observed_svcs = {
                s.metadata.name
                for s in self.services.list(ns, L.job_selector(job.metadata.name))
            }
        self._check_node_liveness(job, observed)

        # Elastic / reclaim handling runs BEFORE the orphan and
        # stale-render deletions: a resize manages its own graceful drain
        # of old-world pods, which the hard-delete paths below would
        # preempt.
        if self._handle_elastic(job, observed):
            return
        if self._handle_drained(job, observed, desired_names):
            return

        # Orphans (scale-down or stale template): delete pods AND services.
        for pname, pod in observed.items():
            if pname not in desired_names and pod.metadata.deletion_timestamp is None:
                self._delete_pod(ns, pname)
        for sname in observed_svcs - desired_svc_names:
            try:
                self.cs.services(ns).delete(sname)
            except NotFound:
                pass

        # Stale renders (scale-up / template edit): a live pod whose
        # desired env differs from what it was started with cannot serve
        # the new cluster spec — the coordination contract
        # (TFK8S_NUM_PROCESSES / TFK8S_CLUSTER_SPEC / TFK8S_MESH,
        # trainer/replicas.py) is baked in at process start. Delete it;
        # level-triggered recreation (next sync) brings the gang back
        # consistent. Scaling a replica set therefore replaces the whole
        # gang in one reconcile pass — the honest TPU semantics (the
        # reference's async-PS world could add workers live; a
        # collective gang cannot, SURVEY.md §2 'Elastic/gang').
        # Allocator-derived placement keys are EXCLUDED from the diff:
        # the SliceAllocator is in-memory, so an operator restart
        # re-admits every job onto freshly-named boxes — a placement-key
        # diff would then spuriously gang-restart the whole cluster.
        desired_by_name = {p.metadata.name: p for p in desired_pods}
        for pname, pod in observed.items():
            want = desired_by_name.get(pname)
            if (
                want is not None
                and pod.metadata.deletion_timestamp is None
                and pod.status.phase in (PodPhase.PENDING, PodPhase.RUNNING)
                and _contract_env(pod) != _contract_env(want)
            ):
                self.recorder.event(
                    "TPUJob", key, "PodReplaced",
                    f"{pname}: coordination env changed (scale or template edit)",
                )
                self._delete_pod(ns, pname)

        # Failure accounting before creation, so a gang restart deletes
        # pods instead of racing recreation.
        failed = [
            p for p in observed.values()
            if p.status.phase == PodPhase.FAILED and p.metadata.name in desired_names
        ]
        if failed and self._handle_failures(job, failed, observed):
            return  # terminal or gang-restarting; next events continue

        svcs_to_create = [
            svc for svc in desired_svcs if svc.metadata.name not in observed_svcs
        ]
        if svcs_to_create:
            self.cs.services(ns).create_many(svcs_to_create)
        # Gang pods are created through ONE batched rate-limiter acquire
        # (create_many): a whole gang pays a single token reservation
        # instead of one sleep per pod on the reconcile hot path.
        pods_to_create = []
        for pod in desired_pods:
            existing = observed.get(pod.metadata.name)
            if existing is None:
                # preserve restart lineage across in-place restarts
                restarts = self._pending_restart_counts.pop(pod.metadata.key, None)
                if restarts is not None:
                    pod.metadata.annotations[RESTARTS_ANNOTATION] = str(restarts)
                with self.tracer.start_span(
                    "pod.create", attributes={"pod": pod.metadata.key}
                ) as sp:
                    # the handoff across the control->data plane boundary:
                    # the kubelet (and through it the trainer) continues
                    # THIS span's trace — CRD update to step 1, one trace
                    if sp.traceparent and pod.spec.containers:
                        pod.spec.containers[0].env[TRACEPARENT_ENV] = (
                            sp.traceparent
                        )
                pods_to_create.append(pod)
        if pods_to_create:
            created = self.cs.pods(ns).create_many(pods_to_create)
            if created:
                self.metrics.inc(
                    "tpujob.pods_created_total", float(len(created))
                )

        self._update_job_status(job, status_changed)

    @staticmethod
    def _gang_restart_message(restart_no: int, failed_ids: List[str]) -> str:
        return f"restart {restart_no} after {failed_ids} failed"

    def _handle_failures(self, job: TPUJob, failed: List[Pod], observed) -> bool:
        """Returns True when reconcile should stop (terminal / restarting)."""
        key = job.metadata.key
        ns = job.metadata.namespace
        gang_mode = job.spec.run_policy.scheduling.gang

        def _is_evaluator(pod: Pod) -> bool:
            return (
                pod.metadata.labels.get(L.REPLICA_TYPE)
                == ReplicaType.EVALUATOR.value
            )

        # Replica-level policy: Never means a failure is permanent.
        # Evaluator failures are never JOB-fatal (success keys off the
        # compute replicas) — a Never-policy evaluator is left Failed
        # for inspection and dropped from further handling.
        for pod in failed:
            if pod.spec.restart_policy == RestartPolicy.NEVER:
                if _is_evaluator(pod):
                    self._record_evaluator_failure(key, pod)
                    continue
                helpers.set_condition(
                    job.status, JobConditionType.FAILED,
                    reason="PodFailed",
                    message=f"pod {pod.metadata.name} failed: {pod.status.message}",
                )
                self.recorder.event("TPUJob", key, "PodFailed", pod.metadata.name)
                self._write_status(job)
                return True
        failed = [
            p for p in failed
            if not (p.spec.restart_policy == RestartPolicy.NEVER and _is_evaluator(p))
        ]

        # Evaluator pods sit OUTSIDE the compute gang: they hold no slice
        # chips, so an evaluator crash is not slice loss — restart it in
        # place instead of burning a gang restart of healthy training
        # replicas (a wedged evaluator would otherwise cycle the whole job
        # to BackoffLimitExceeded).
        gang_failed = [p for p in failed if not _is_evaluator(p)]

        if gang_mode and gang_failed:
            failed = gang_failed  # evaluators don't drive gang accounting
            # A failed pod rendered before the job's latest gang restart
            # or preemption belongs to a gang that is already gone: its
            # failure was counted by that restart, or came after it. A
            # lagging pod cache shows such pods one subset at a time
            # ({w0}, then {w1}, then {w0, w1}), and each subset, unequal
            # to the last restart's message below, would count once more
            # (ROADMAP F10). Such pods are deleted, never counted. The
            # caller has floored the generation.
            generation = job.status.gang_restarts + job.status.preemptions
            if all(_rendered_before(p, generation) for p in failed):
                for p in failed:
                    self._delete_pod(ns, p.metadata.name)
                return True
            failed = [p for p in failed if not _rendered_before(p, generation)]
            # Idempotent accounting FIRST — before the limit check: if a
            # sync re-observes failed pods whose episode was already
            # counted (a crash or stale cache between the status write
            # and pod deletion), it must neither burn a second unit of
            # backoff_limit NOR terminate the job — a stale observation
            # arriving after the final counted restart would otherwise
            # fire BackoffLimitExceeded before the last incarnation ever
            # ran (and, its pods already deleted, leave nothing behind).
            # Keyed by pod UID (not name): recreated pods reuse names but
            # get fresh UIDs, so a genuine repeat failure is a new
            # episode and still counts.
            failed_ids = sorted(
                f"{p.metadata.name}:{p.metadata.uid[:8]}" for p in failed
            )
            existing = helpers.get_condition(
                job.status, JobConditionType.RESTARTING
            )
            # Deliberately ignore existing.status: a stale Failed-pod
            # event can arrive AFTER the restarted gang went Running
            # (which flips RESTARTING to False) — the failed set's UIDs,
            # baked into the message, are the episode's real identity.
            already_counted = (
                existing is not None
                and existing.message
                == self._gang_restart_message(job.status.gang_restarts, failed_ids)
            )
            if already_counted:
                self._delete_job_pods(job, only_phases=None)
                return True
            # Slice loss is gang loss: restart everything from checkpoint
            # (SURVEY.md §2 'Elastic / gang semantics').
            limit = job.spec.run_policy.backoff_limit or 0
            if job.status.gang_restarts >= limit:
                helpers.set_condition(
                    job.status, JobConditionType.FAILED,
                    reason="BackoffLimitExceeded",
                    message=f"gang restarted {job.status.gang_restarts}x; limit {limit}",
                )
                self.recorder.event("TPUJob", key, "BackoffLimitExceeded")
                self._write_status(job)
                return True
            job.status.gang_restarts += 1
            helpers.set_condition(
                job.status, JobConditionType.RESTARTING,
                reason="GangRestart",
                message=self._gang_restart_message(
                    job.status.gang_restarts, failed_ids
                ),
            )
            # Persist the restart count BEFORE deleting pods: if this
            # write conflicts, stop here — the failed pods are still
            # observable, so the re-enqueued sync redoes the accounting.
            # Deleting first would lose the increment on conflict
            # (restart without trace).
            if not self._write_status(job):
                return True
            # Floor for stale-cache syncs: the recreate pass must
            # never render pods with a pre-increment restart count.
            self._gang_restarts_floor[key] = job.status.gang_restarts
            self.recorder.event(
                "TPUJob", key, "GangRestart", f"#{job.status.gang_restarts}"
            )
            self.metrics.inc("tpujob.gang_restarts_total")
            self._delete_job_pods(job, only_phases=None)
            return True

        # Per-pod in-place restart (OnFailure/Always/ExitCode)
        for pod in failed:
            restarts = int(pod.metadata.annotations.get(RESTARTS_ANNOTATION, "0"))
            rspec = None
            rt = pod.metadata.labels.get(L.REPLICA_TYPE)
            if rt:
                rspec = job.spec.replica_specs.get(ReplicaType(rt))
            max_restarts = rspec.max_restarts if rspec else 0
            if restarts >= (max_restarts or 0):
                if _is_evaluator(pod):
                    # exhausted evaluator: left Failed, job unaffected
                    self._record_evaluator_failure(key, pod)
                    continue
                helpers.set_condition(
                    job.status, JobConditionType.FAILED,
                    reason="BackoffLimitExceeded",
                    message=f"pod {pod.metadata.name} failed {restarts + 1}x",
                )
                self._write_status(job)
                return True
            self._delete_pod(ns, pod.metadata.name)
            self.recorder.event(
                "TPUJob", key, "PodRestart",
                f"{pod.metadata.name} restart #{restarts + 1}",
            )
            # The recreated pod inherits the incremented restart count
            # (keyed by namespace/name so same-named jobs in different
            # namespaces can't cross-contaminate lineage).
            self._pending_restart_counts[pod.metadata.key] = restarts + 1
        return False


    # ------------------------------------------------------ elastic resize

    def _clamp_elastic_floor(self, job: TPUJob) -> None:
        """Never act on a world OLDER than one this controller already
        committed (informer cache may lag the resize's status write)."""
        floor = self._elastic_floor.get(job.metadata.key)
        if floor is not None and job.status.world_version < floor[0]:
            job.status.world_version, job.status.elastic_replicas = floor

    def _apply_elastic_override(self, job: TPUJob) -> None:
        """Rewrite the WORKING COPY's spec to the effective elastic size:
        Worker replicas from ``status.elastic_replicas``, and (non-cpu)
        num_slices/mesh re-derived so the gang-consistency invariant
        (one process per host, mesh product == chips) holds at the
        resized world. The stored spec keeps the user's desired count —
        stashed on the copy for the scale-up path."""
        w = job.spec.replica_specs.get(ReplicaType.WORKER)
        if w is None:
            return
        job._elastic_desired = w.replicas
        eff = job.status.elastic_replicas
        if (
            job.spec.run_policy.elastic is None
            or eff is None
            or eff == w.replicas
        ):
            return
        from tfk8s_tpu_torch.utils import topology as topo

        w.replicas = eff
        try:
            info = topo.parse_accelerator(
                job.spec.tpu.accelerator, job.spec.tpu.topology
            )
        except topo.TopologyError:
            return
        if info.generation != "cpu" and info.hosts:
            job.spec.tpu.num_slices = max(eff // info.hosts, 1)
            if job.spec.mesh is not None and set(job.spec.mesh.axes) == {"data"}:
                # validation restricts elastic TPU jobs to a pure
                # data-parallel mesh exactly so this re-derivation is safe
                job.spec.mesh.axes["data"] = (
                    info.chips * job.spec.tpu.num_slices
                )

    @staticmethod
    def _pod_world(pod: Pod) -> int:
        try:
            return int(pod.spec.containers[0].env.get("TFK8S_WORLD_VERSION", "0"))
        except (ValueError, IndexError):
            return 0

    def _deliver_drain(self, ns: str, pod: Pod, deadline: float) -> None:
        """Stamp the reclaim-notice annotation on a pod (idempotent); the
        kubelet's watch turns it into the entrypoint's soft drain
        signal."""
        from tfk8s_tpu_torch.runtime.kubelet import RECLAIM_AT_ANNOTATION, reclaim_patch

        if RECLAIM_AT_ANNOTATION in pod.metadata.annotations:
            return
        try:
            self.cs.pods(ns).patch(pod.metadata.name, reclaim_patch(deadline))
        except (Conflict, NotFound):
            pass

    def _handle_elastic(self, job: TPUJob, observed) -> bool:
        """Elastic world sizing (RunPolicy.elastic). Returns True when
        this sync is consumed by resize management:

        - a Worker drained (or sits under a reclaim notice) and the
          survivors still satisfy ``min_replicas`` -> begin a resize DOWN:
          bump the world version, drain the survivors so they checkpoint
          at their freshest step, and re-render at the surviving count —
          no backoff_limit burned;
        - a resize is in flight -> shepherd old-world pods out (drained/
          terminal ones deleted, stragglers hard-deleted past the grace
          deadline) before the new gang renders;
        - the job runs below its desired size and the debounce elapsed ->
          resize UP toward the spec count when capacity allows.
        """
        el = job.spec.run_policy.elastic
        if el is None or not job.spec.run_policy.scheduling.gang:
            return False
        from tfk8s_tpu_torch.runtime.kubelet import (
            RECLAIM_AT_ANNOTATION,
            parse_reclaim_at,
        )
        from tfk8s_tpu_torch.utils import topology as topo

        key, ns = job.metadata.key, job.metadata.namespace
        now = time.time()
        wv = job.status.world_version
        live = [
            p for p in observed.values()
            if p.metadata.deletion_timestamp is None
        ]

        # -- resize in flight: old-world pods still present ---------------
        if wv > 0:
            stale = [p for p in live if self._pod_world(p) != wv]
            if stale:
                for p in stale:
                    if p.status.phase in (
                        PodPhase.DRAINED, PodPhase.SUCCEEDED, PodPhase.FAILED
                    ):
                        self._delete_pod(ns, p.metadata.name)
                        continue
                    if RECLAIM_AT_ANNOTATION not in p.metadata.annotations:
                        self._deliver_drain(
                            ns, p, now + RESIZE_DRAIN_GRACE_S
                        )
                        continue
                    # a malformed stamp makes the grace unknowable: treat
                    # it as already expired rather than waiting forever
                    deadline = parse_reclaim_at(p)
                    if deadline is None:
                        deadline = now
                    if now >= deadline:
                        # grace exhausted: SIGKILL equivalent
                        self._delete_pod(ns, p.metadata.name)
                self.controller.enqueue_after(key, RESIZE_POLL_S)
                return True

        try:
            info = topo.parse_accelerator(
                job.spec.tpu.accelerator, job.spec.tpu.topology
            )
        except topo.TopologyError:
            return False

        workers = [
            p for p in live
            if p.metadata.labels.get(L.REPLICA_TYPE) == ReplicaType.WORKER.value
        ]
        victims = [
            p for p in workers
            if p.status.phase == PodPhase.DRAINED
            or RECLAIM_AT_ANNOTATION in p.metadata.annotations
        ]
        survivors = [
            p for p in workers
            if p not in victims
            and p.status.phase in (
                PodPhase.PENDING, PodPhase.SCHEDULED, PodPhase.RUNNING
            )
        ]
        if any(
            p.status.phase == PodPhase.FAILED
            and RECLAIM_AT_ANNOTATION not in p.metadata.annotations
            for p in workers
        ):
            # a COLD crash (no notice) in the same sync as a resize
            # trigger: defer the resize so the ordinary failure machinery
            # accounts it first (backoff, restart floor, events) — a
            # world-version bump here would reclassify the carcass as a
            # stale-world pod and the shepherd would delete it silently,
            # exempting crashes from backoff whenever they coincide with
            # a resize window
            return False

        # -- resize down: capacity left; shrink to the survivors ----------
        if victims:
            new_count = len(survivors)
            if info.generation != "cpu" and info.hosts:
                # slice granularity: a partially-populated slice cannot
                # run — floor to the slice boundary
                new_count = (new_count // info.hosts) * info.hosts
            if new_count >= max(el.min_replicas or 1, 1):
                self._begin_resize(
                    job, new_count, "down",
                    drain_pods=[p for p in live if p not in victims],
                    delete_pods=[
                        p for p in victims
                        if p.status.phase == PodPhase.DRAINED
                    ],
                )
                return True
            # below min_replicas: fall through — _handle_drained answers
            # with a preemption-style whole-gang restart (re-admission at
            # full size when capacity returns)
            return False

        # -- debounced scale back up toward the desired count -------------
        eff = job.status.elastic_replicas
        desired = getattr(job, "_elastic_desired", None)
        if eff is None or desired is None or eff >= desired:
            return False
        debounce = el.resize_debounce_s or 0.0
        remaining = debounce - (now - self._last_resize.get(key, 0.0))
        if remaining > 0:
            self.controller.enqueue_after(key, min(remaining + 0.05, debounce))
            return False  # keep running at the current size meanwhile
        target = min(desired, el.max_replicas or desired)
        if info.generation != "cpu" and info.hosts:
            extra_slices = -(-(target - eff) // info.hosts)  # ceil
            if self.allocator.free_slices(job.spec.tpu.accelerator) < extra_slices:
                self.controller.enqueue_after(key, PENDING_REQUEUE_S)
                return False  # capacity hasn't returned yet
        self._begin_resize(job, target, "up", drain_pods=live, delete_pods=[])
        return True

    def _begin_resize(
        self, job: TPUJob, new_count: int, direction: str,
        drain_pods: List[Pod], delete_pods: List[Pod],
    ) -> None:
        """Commit the resize decision: new world version + effective count
        in status FIRST (conflict -> the re-enqueued sync redoes the
        accounting off fresh state), then drain every pod of the old
        world so each commits a checkpoint at its freshest step before
        the gang re-forms."""
        key, ns = job.metadata.key, job.metadata.namespace
        desired = getattr(job, "_elastic_desired", None) or new_count
        job.status.elastic_replicas = None if new_count == desired else new_count
        job.status.world_version += 1
        wv = job.status.world_version
        helpers.set_condition(
            job.status, JobConditionType.RESTARTING,
            reason="Resizing",
            message=f"{direction} to {new_count} workers (world v{wv})",
        )
        if not self._write_status(job):
            return
        self._elastic_floor[key] = (wv, job.status.elastic_replicas)
        now = time.time()
        self._last_resize[key] = now
        self._resize_started[key] = (now, direction)
        self.recorder.event(
            "TPUJob", key, "ElasticResize",
            f"{direction} -> {new_count} workers (world v{wv})",
        )
        self.metrics.inc(
            "tfk8s_elastic_resizes_total", 1.0, {"direction": direction}
        )
        for p in delete_pods:
            self._delete_pod(ns, p.metadata.name)
        deadline = now + RESIZE_DRAIN_GRACE_S
        for p in drain_pods:
            self._deliver_drain(ns, p, deadline)
        self.controller.enqueue_after(key, RESIZE_POLL_S)

    def _handle_drained(self, job: TPUJob, observed, desired_names) -> bool:
        """Drained pods NOT consumed by an elastic resize. A drained
        compute pod on a fixed-size gang (or with survivors below
        min_replicas) is a whole-gang preemption-style restart: reclaim
        is not a failure, so ``backoff_limit`` is untouched and the
        relaunched gang resumes from the drain checkpoint. Drained
        evaluators / per-pod-mode pods are simply replaced."""
        key = job.metadata.key
        drained_gang: List[Pod] = []
        for p in observed.values():
            if (
                p.status.phase != PodPhase.DRAINED
                or p.metadata.deletion_timestamp is not None
            ):
                continue
            is_eval = (
                p.metadata.labels.get(L.REPLICA_TYPE)
                == ReplicaType.EVALUATOR.value
            )
            if (
                p.metadata.name not in desired_names
                or is_eval
                or not job.spec.run_policy.scheduling.gang
            ):
                # outside the gang contract: replace in place, no
                # accounting (a fresh pod re-runs from checkpoint or
                # from its own poll loop)
                self._delete_pod(job.metadata.namespace, p.metadata.name)
                continue
            drained_gang.append(p)
        if not drained_gang:
            return False
        ids = sorted(
            f"{p.metadata.name}:{p.metadata.uid[:8]}" for p in drained_gang
        )
        existing = helpers.get_condition(
            job.status, JobConditionType.RESTARTING
        )
        already = (
            existing is not None
            and existing.message
            == self._reclaim_restart_message(job.status.preemptions, ids)
        )
        if already:
            self._delete_job_pods(job, only_phases=None)
            return True
        job.status.preemptions += 1
        helpers.set_condition(
            job.status, JobConditionType.RESTARTING,
            reason="Reclaimed",
            message=self._reclaim_restart_message(job.status.preemptions, ids),
        )
        if not self._write_status(job):
            return True
        self._preemptions_floor[key] = job.status.preemptions
        self.recorder.event(
            "TPUJob", key, "ReclaimRestart",
            f"#{job.status.preemptions} after {ids} drained",
        )
        self.metrics.inc("tpujob.preemptions_total")
        self._delete_job_pods(job, only_phases=None)
        return True

    @staticmethod
    def _reclaim_restart_message(n: int, ids: List[str]) -> str:
        return f"reclaim restart {n} after {ids} drained"

    def _export_capacity_gauges(self) -> None:
        """Free whole-slice inventory per accelerator type, as gauges.
        Cheap when nothing changed: the allocator's version counter
        gates the O(types x boxes) recomputation off the hot reconcile
        path (admit is called on every sync and is usually a no-op)."""
        v = self.allocator.version
        if v == getattr(self, "_gauges_version", None):
            return
        self._gauges_version = v
        for acc, n in self.allocator.capacity_summary().items():
            self.metrics.set_gauge(
                "gang.free_slices", float(n), {"accelerator": acc}
            )

    def _record_evaluator_failure(self, key: str, pod: Pod) -> None:
        """Once-per-pod-uid event: the terminally-Failed evaluator pod is
        kept around, so every subsequent reconcile re-observes it — without
        dedup the event log floods. Keyed by job so deletion can prune."""
        entry = (key, pod.metadata.uid)
        if entry in self._evaluator_failures_seen:
            return
        self._evaluator_failures_seen.add(entry)
        self.recorder.event("TPUJob", key, "EvaluatorFailed", pod.metadata.name)

    def _prune_job_state(self, key: str) -> None:
        """Drop ALL controller-side scratch for a deleted job (evaluator
        failure dedup, restart/preemption/elastic floors, resize clocks,
        pending per-pod restart lineage) — a future job reusing the name
        must not inherit a stale floor (it would render
        TFK8S_GANG_RESTARTS > 0 and try to resume a checkpoint that
        isn't its own), and a long-lived operator must not leak one map
        entry per job it ever saw."""
        self._evaluator_failures_seen = {
            e for e in self._evaluator_failures_seen if e[0] != key
        }
        self._gang_restarts_floor.pop(key, None)
        self._preemptions_floor.pop(key, None)
        self._elastic_floor.pop(key, None)
        self._resize_started.pop(key, None)
        self._last_resize.pop(key, None)
        # _pending_restart_counts is keyed by POD key; a pod belongs to
        # this job iff it matches <ns>/<job>-<replica-type>-<index> (exact
        # pattern, not a prefix — job "a" must not prune pods of job
        # "a-worker", whose names continue past the digits)
        ns, name = key.split("/", 1)
        types = "|".join(rt.value.lower() for rt in ReplicaType)
        pat = re.compile(
            rf"^{re.escape(ns)}/{re.escape(name)}-(?:{types})-\d+$"
        )
        for pkey in [k for k in self._pending_restart_counts if pat.match(k)]:
            self._pending_restart_counts.pop(pkey, None)

    def _delete_pod(self, ns: str, name: str) -> None:
        try:
            self.cs.pods(ns).delete(name)
            self.metrics.inc("tpujob.pods_deleted_total")
        except NotFound:
            pass

    def _delete_job_pods(self, job: TPUJob, only_phases) -> None:
        for p in self._observed_pods(job):
            if only_phases is None or p.status.phase in only_phases:
                self._delete_pod(job.metadata.namespace, p.metadata.name)

    # ----------------------------------------------------------- status

    def _update_job_status(self, job: TPUJob, already_changed: bool) -> None:
        key = job.metadata.key
        observed = self._observed_pods(job)
        changed = already_changed

        new_statuses = {}
        for rt in helpers.sorted_replica_types(job):
            rs = ReplicaStatus()
            for p in observed:
                if p.metadata.labels.get(L.REPLICA_TYPE) != rt.value:
                    continue
                if p.status.phase in (PodPhase.PENDING, PodPhase.SCHEDULED, PodPhase.RUNNING):
                    rs.active += 1
                elif p.status.phase == PodPhase.SUCCEEDED:
                    rs.succeeded += 1
                elif p.status.phase == PodPhase.FAILED:
                    rs.failed += 1
                rs.restarts += int(p.metadata.annotations.get(RESTARTS_ANNOTATION, "0"))
            new_statuses[rt] = rs
        if new_statuses != job.status.replica_statuses:
            job.status.replica_statuses = new_statuses
            changed = True

        # Success: every compute replica ran to completion (chief acts as
        # the completion oracle when present).
        compute_types = [
            rt for rt in (ReplicaType.CHIEF, ReplicaType.WORKER)
            if rt in job.spec.replica_specs
        ]
        def _count(rt):
            return job.spec.replica_specs[rt].replicas or 0

        if ReplicaType.CHIEF in compute_types:
            done = new_statuses[ReplicaType.CHIEF].succeeded >= _count(ReplicaType.CHIEF)
        else:
            done = all(new_statuses[rt].succeeded >= _count(rt) for rt in compute_types)

        n_active = sum(rs.active for rs in new_statuses.values())
        n_expected = helpers.total_replicas(job)
        # Permanently-failed evaluators (left in place by design — see
        # _handle_failures) must not block the Running transition or the
        # start_time stamp active_deadline_seconds hangs off.
        n_dead_evaluators = sum(
            1 for p in observed
            if p.status.phase == PodPhase.FAILED
            and p.metadata.labels.get(L.REPLICA_TYPE) == ReplicaType.EVALUATOR.value
        )

        if done:
            if helpers.set_condition(
                job.status, JobConditionType.SUCCEEDED, reason="JobSucceeded"
            ):
                job.status.completion_time = time.time()
                self.recorder.event("TPUJob", key, "JobSucceeded")
                self.metrics.inc("tpujob.succeeded_total")
                changed = True
            self.allocator.release(job.metadata.uid)
            self._export_capacity_gauges()
        elif n_active == n_expected - n_dead_evaluators and n_active > 0:
            running = all(
                p.status.phase == PodPhase.RUNNING for p in observed
                if p.metadata.labels.get(L.REPLICA_TYPE)
                and not (
                    p.status.phase == PodPhase.FAILED
                    and p.metadata.labels.get(L.REPLICA_TYPE)
                    == ReplicaType.EVALUATOR.value
                )
            )
            if running:
                if job.status.start_time is None:
                    job.status.start_time = time.time()
                    changed = True
                if helpers.set_condition(
                    job.status, JobConditionType.RUNNING, reason="AllReplicasRunning"
                ):
                    self.recorder.event("TPUJob", key, "JobRunning")
                    changed = True
                started = self._resize_started.pop(key, None)
                if started is not None:
                    # the resized gang is fully Running: close the resize
                    # into the per-job recovery gauge + one trace span
                    t0, direction = started
                    end = time.time()
                    self.metrics.set_gauge(
                        "tpujob.recovery_seconds", end - t0,
                        {"namespace": job.metadata.namespace,
                         "job": job.metadata.name},
                    )
                    self.tracer.record_span(
                        "job.resize", start=t0, end=end,
                        attributes={"job": key, "direction": direction},
                    )
                    self.recorder.event(
                        "TPUJob", key, "ResizeComplete",
                        f"{direction} recovered in {end - t0:.2f}s",
                    )

        if changed:
            self._write_status(job)

    def _write_status(self, job: TPUJob) -> bool:
        """Returns True when the write landed; False on deletion. Rides the
        PATCH /status subresource: the controller is the sole owner of job
        status, so a merge-patch of the full status needs no
        resourceVersion and can never 409 against concurrent spec writers
        (scale/suspend/apply) — the happy path is conflict-free.

        Deep-compares the computed status against the cached server state
        FIRST (the ``_status_baseline`` stamped by sync): an unchanged
        status skips the round trip entirely — the controller being the
        sole status owner makes the cached value an honest baseline, and
        the level-triggered resync covers the stale-cache corner. Skips
        are counted (``tfk8s_status_patches_skipped_total``)."""
        from tfk8s_tpu_torch.api import serde

        wire_status = serde.to_wire(job.status)
        baseline = getattr(job, "_status_baseline", None)
        if baseline is not None and wire_status == baseline:
            self.metrics.inc("tfk8s_status_patches_skipped_total")
            return True
        # merge-patch can't delete map keys it doesn't mention: a replica
        # type REMOVED from the spec must carry an explicit null or its
        # stale replicaStatuses entry survives server-side and every
        # reconcile re-detects a diff — an endless status-write loop. The
        # type set is the finite enum, so the nulls are bounded. Padding
        # goes on a copy: wire_status doubles as the next baseline and
        # must stay comparable to a future to_wire().
        payload = dict(wire_status)
        rs = payload.get("replicaStatuses")
        if isinstance(rs, dict):
            rs = dict(rs)
            for rt in ReplicaType:
                rs.setdefault(rt.value, None)
            payload["replicaStatuses"] = rs
        with self.tracer.start_span(
            "status.update", attributes={"job": job.metadata.key}
        ):
            try:
                self.cs.tpujobs(job.metadata.namespace).patch_status(
                    job.metadata.name, {"status": payload}
                )
                job._status_baseline = wire_status
                return True
            except NotFound:
                return False

    # ------------------------------------------------------ teardown paths

    def _cleanup_finished(self, job: TPUJob) -> None:
        """Clean-pod policy + TTL for finished jobs; slices are returned to
        the pool either way."""
        self.allocator.release(job.metadata.uid)
        self._export_capacity_gauges()
        policy = job.spec.run_policy.clean_pod_policy or CleanPodPolicy.RUNNING
        if policy == CleanPodPolicy.ALL:
            self._delete_job_pods(job, only_phases=None)
            self._delete_job_services(job)
        elif policy == CleanPodPolicy.RUNNING:
            self._delete_job_pods(
                job, only_phases=(PodPhase.PENDING, PodPhase.SCHEDULED, PodPhase.RUNNING)
            )
        ttl = job.spec.run_policy.ttl_seconds_after_finished
        if ttl is not None and job.status.completion_time:
            age = time.time() - job.status.completion_time
            if age >= ttl:
                try:
                    self.cs.tpujobs(job.metadata.namespace).delete(job.metadata.name)
                except NotFound:
                    pass
            else:
                self.controller.enqueue_after(job.metadata.key, ttl - age + 0.05)

    def _delete_job_services(self, job: TPUJob) -> None:
        for s in self.services.list(
            job.metadata.namespace, L.job_selector(job.metadata.name)
        ):
            try:
                self.cs.services(job.metadata.namespace).delete(s.metadata.name)
            except NotFound:
                pass

    def _delete_job_events(self, job: TPUJob) -> None:
        """Garbage-collect the job's mirrored Event objects (k8s expires
        events by TTL; here deletion rides job teardown)."""
        ns, key = job.metadata.namespace, job.metadata.key
        try:
            client = self.cs.generic("Event", ns)
            events, _rv = client.list()
            for ev in events:
                if getattr(ev, "involved_key", "") == key:
                    try:
                        client.delete(ev.metadata.name)
                    except NotFound:
                        pass
        except Exception as e:  # noqa: BLE001 — event GC is best-effort
            log.debug("event GC for %s failed: %s", key, e)

    def _finalize(self, job: TPUJob) -> None:
        """Deletion path (SURVEY.md §3.4): tear everything down, then strip
        the finalizer so the store completes the delete."""
        key = job.metadata.key
        self._delete_job_pods(job, only_phases=None)
        self._delete_job_services(job)
        self.allocator.release(job.metadata.uid)
        self._export_capacity_gauges()
        self._prune_job_state(key)
        if FINALIZER in job.metadata.finalizers:
            remaining = [f for f in job.metadata.finalizers if f != FINALIZER]
            try:
                # stripping the finalizer via PATCH completes the delete
                # server-side when ours was the last. rv PRECONDITION: the
                # list replaces wholesale, and completing the delete off a
                # stale list could drop a foreign finalizer added since —
                # destroying its owner's chance to ever run cleanup.
                self.cs.tpujobs(job.metadata.namespace).patch(
                    job.metadata.name,
                    {"metadata": {
                        "resourceVersion": str(job.metadata.resource_version),
                        "finalizers": remaining,
                    }},
                )
            except Conflict:
                # deletion NOT complete yet — retry off the fresh object
                # without wiping event history or recording JobDeleted
                self.controller.enqueue_key(key)
                return
            except NotFound:
                return
        self.recorder.event("TPUJob", key, "JobDeleted")
        # AFTER the terminal event, so its mirrored object is GC'd too —
        # a deleted job leaves no Event objects behind
        self.recorder.flush()
        self._delete_job_events(job)
        # ... and no /metrics series either (same leave-nothing contract):
        # label-based GC removes exactly this job's labeled series
        self.metrics.remove_labels(
            {"namespace": job.metadata.namespace, "job": job.metadata.name}
        )
