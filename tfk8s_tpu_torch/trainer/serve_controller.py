"""The TPUServe controller: level-triggered reconcile of a TPUServe into a
set of independent serving replica pods, with readiness-gated surge
rolling updates and a queue-depth autoscaler.

Where the TPUJob controller reconciles a *gang* (all-or-nothing, fails as
a unit, scale replaces the whole set), serving replicas are deliberately
independent: each pod holds its own model copy (runtime/server.py), so the
controller can create/drain them one at a time — which is exactly what
makes a zero-downtime rolling update possible.

Reconcile contract (idempotent, every step safe to repeat):

1. missing object -> drop controller-side state (autoscaler EMA, rollout
   spans); deletion timestamp -> finalizer teardown.
2. default + validate; invalid specs -> Degraded(ValidationFailed).
3. compute the desired pod-template hash (task + checkpoint + template +
   batching — runtime/server.template_hash). Pods carry it as a label;
   a hash mismatch makes a pod "old".
4. **Rolling update invariants** (RollingUpdatePolicy), maintained
   level-triggered against the OBSERVED pods, never against remembered
   intent:
   - total live pods <= replicas + max_surge (the surge ceiling);
   - an old pod is deleted only while available (Ready) pods stay >=
     replicas - max_unavailable AFTER the delete (the availability
     floor) — new replicas must pass readiness first, so an update never
     drops below the floor;
   - deletion drains: the kubelet signals the entrypoint's stop event and
     the model server finishes queued requests before exiting
     (runtime/server.serve), so accepted requests never fail.
5. **Readiness**: a replica is Ready once RUNNING *and* its server has
   loaded the checkpoint and reported ``serving_ready`` through the
   kubelet's health/progress publication into pod status — the hermetic
   form of a kubelet readiness probe (the server only reports after the
   weights are resident).
6. **Autoscaler** (AutoscalePolicy): smooth the replicas' reported queue
   depth with an EMA, size replicas to hold per-replica depth near
   target; hysteresis bands + cooldown make it provably non-flapping
   (scale-up needs depth > target*high_band, scale-down needs depth <
   target*low_band, and consecutive scale events are >= cooldown_s
   apart). The controller patches its own spec.replicas (HPA-style).
7. status: replicas/ready/updated counts, observed_version, Available/
   Progressing/Degraded conditions; events; per-serve labeled gauges;
   one trace span per completed rollout.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Optional, Tuple

from tfk8s_tpu_torch.api import (
    serde,
    set_serve_defaults,
    validate_serve,
)
from tfk8s_tpu_torch.api.helpers import set_serve_condition
from tfk8s_tpu_torch.api.types import (
    ContainerSpec,
    ObjectMeta,
    OwnerReference,
    Pod,
    PodPhase,
    PodSpec,
    RestartPolicy,
    ServeConditionType,
    TPUServe,
)
from tfk8s_tpu_torch.client.clientset import Clientset
from tfk8s_tpu_torch.client.informer import ResourceEventHandler, SharedIndexInformer
from tfk8s_tpu_torch.client.listers import Lister
from tfk8s_tpu_torch.client.store import Conflict, NotFound
from tfk8s_tpu_torch.controller.controller import Controller
from tfk8s_tpu_torch.obs.trace import TRACEPARENT_ENV, Tracer, get_tracer
from tfk8s_tpu_torch.runtime.server import template_hash
from tfk8s_tpu_torch.trainer import labels as L
from tfk8s_tpu_torch.utils.logging import EventRecorder, Metrics, get_logger

log = get_logger("tpuserve")

SERVE_FINALIZER = "tfk8s.dev/serve-cleanup"

# Pods report load every kubelet flush (~1s); re-reconciling on that
# cadence keeps the autoscaler live even when no pod event fires (e.g.
# load drained and reports stopped changing). Monkeypatched down in tests.
AUTOSCALE_PERIOD_S = 1.0
# EMA smoothing factor for the queue-depth signal: ~3 observations to
# cross a band edge, so a single spiky flush can't trigger a scale.
EMA_ALPHA = 0.4
# Disaggregated decode pools scale on SLOT OCCUPANCY (live decode slots /
# slot capacity), not queue depth: a decode pool's backlog shows up as
# full batches long before a queue forms. Target fraction of capacity in
# use; the autoscale bands apply multiplicatively around it.
DECODE_TARGET_OCCUPANCY = 0.75


def _serve_version(serve: TPUServe) -> str:
    """The pod-template hash: everything that, when changed, requires
    replacing replicas (weights ref, code template, batching knobs).
    ``disaggregation`` joins the hash only when PRESENT (existing
    single-pool hashes are unchanged), and only by presence: pool
    COUNTS scale in place like ``spec.replicas`` — adding/removing the
    block itself is what changes the pods' phase env and rolls.
    ``kv_tier`` joins WHOLE when present: its knobs render into the
    pods' env (host-tier byte budget, peer fetch), so a knob edit must
    roll the replicas — unlike the directory TTL, which only the
    gateway reads, but hashing the block uniformly keeps the rule
    simple (the TTL is a tuning knob nobody flips without also
    reconsidering capacity)."""
    base = {
        "task": serve.spec.task,
        "checkpoint": serve.spec.checkpoint,
        "template": serde.to_wire(serve.spec.template),
        "batching": serde.to_wire(serve.spec.batching),
    }
    if serve.spec.disaggregation is not None:
        base["disaggregation"] = True
    if serve.spec.kv_tier is not None:
        base["kv_tier"] = serde.to_wire(serve.spec.kv_tier)
    return template_hash(base)


def serve_pools(serve: TPUServe) -> List[Tuple[str, int]]:
    """The serve's replica pools as ``(phase, desired_count)`` pairs:
    one anonymous pool for a single-pool serve, the labeled
    prefill/decode pair under disaggregation."""
    d = serve.spec.disaggregation
    if d is None:
        return [("", serve.spec.replicas)]
    return [("prefill", d.prefill_replicas), ("decode", d.decode_replicas)]


def pod_phase_of(pod: Pod) -> str:
    """Which pool a serving pod belongs to ("" = the single pool)."""
    return pod.metadata.labels.get(L.SERVE_PHASE, "")


def render_serve_pod(
    serve: TPUServe, version: str, index: int, phase: str = ""
) -> Pod:
    """One serving replica pod at ``version``. Names carry the version so
    surge pods of two template generations coexist during a rollout;
    disaggregated pods also carry their ``phase`` (name, label, and
    ``TFK8S_SERVE_PHASE`` env) so the two pools render, roll, and
    aggregate independently."""
    spec = serve.spec
    tag = f"{phase}-" if phase else ""
    name = f"{serve.metadata.name}-srv-{version}-{tag}{index}"
    tmpl = spec.template
    env = {
        **tmpl.env,
        "TFK8S_SERVE_NAME": serve.metadata.name,
        "TFK8S_NAMESPACE": serve.metadata.namespace,
        "TFK8S_POD_NAME": name,
        "TFK8S_SERVE_TASK": spec.task,
        "TFK8S_SERVE_CHECKPOINT": spec.checkpoint,
        "TFK8S_SERVE_VERSION": version,
        "TFK8S_SERVE_MAX_BATCH": str(spec.batching.max_batch_size),
        "TFK8S_SERVE_BATCH_TIMEOUT_MS": str(spec.batching.batch_timeout_ms),
        "TFK8S_SERVE_QUEUE_LIMIT": str(spec.batching.queue_limit),
        # decode-loop knobs (generative tasks): paged KV-cache geometry
        "TFK8S_SERVE_PAGE_SIZE": str(spec.batching.page_size),
        "TFK8S_SERVE_MAX_PAGES": str(spec.batching.max_pages),
        # token-scheduler knobs (runtime/sched): admission policy,
        # page-spill preemption, speculative decode
        "TFK8S_SERVE_SCHED_POLICY": spec.batching.scheduler.policy,
        "TFK8S_SERVE_PREEMPTION": "1" if spec.batching.scheduler.preemption else "0",
        "TFK8S_SERVE_AGING_S": str(spec.batching.scheduler.aging_s),
        "TFK8S_SERVE_SPEC_DECODE": "1" if spec.batching.scheduler.spec_decode else "0",
        "TFK8S_SERVE_SPEC_TOKENS": str(spec.batching.scheduler.spec_tokens),
        "TFK8S_SERVE_SPEC_DRAFT": spec.batching.scheduler.spec_draft,
    }
    if phase:
        env["TFK8S_SERVE_PHASE"] = phase
    if spec.kv_tier is not None:
        # KV economy (runtime/kvtier): host-tier byte budget + peer
        # fetch render per replica; the directory TTL stays gateway-side
        env["TFK8S_KV_HOST_BYTES"] = str(spec.kv_tier.host_bytes)
        env["TFK8S_KV_PEER_FETCH"] = "1" if spec.kv_tier.peer_fetch else "0"
    lbls = L.serve_version_labels(serve.metadata.name, version)
    lbls[L.REPLICA_INDEX] = str(index)
    if phase:
        lbls[L.SERVE_PHASE] = phase
    return Pod(
        metadata=ObjectMeta(
            name=name,
            namespace=serve.metadata.namespace,
            labels=lbls,
            owner_references=[
                OwnerReference(
                    kind=serve.kind, name=serve.metadata.name,
                    uid=serve.metadata.uid,
                )
            ],
        ),
        spec=PodSpec(
            containers=[
                ContainerSpec(
                    entrypoint=tmpl.entrypoint,
                    image=tmpl.image,
                    command=list(tmpl.command),
                    args=list(tmpl.args),
                    env=env,
                    resources=dict(tmpl.resources),
                )
            ],
            # serving pods are replaced by the controller, never restarted
            # in place: a fresh uid re-runs load()->Ready cleanly
            restart_policy=RestartPolicy.NEVER,
        ),
    )


def pod_is_ready(pod: Pod) -> bool:
    """Readiness gate for rollouts — the ONE shared predicate
    (runtime/server.replica_is_ready), so the controller's availability
    accounting and ServeClient's routing can never disagree."""
    from tfk8s_tpu_torch.runtime.server import replica_is_ready

    return replica_is_ready(pod)


class TPUServeController:
    """Owns the TPUServe/Pod informers and the serving reconcile logic."""

    def __init__(
        self,
        clientset: Clientset,
        recorder: Optional[EventRecorder] = None,
        metrics: Optional[Metrics] = None,
        resync_period: float = 0.0,
        tracer: Optional[Tracer] = None,
    ):
        self.cs = clientset
        self.recorder = recorder or EventRecorder(sink=clientset)
        self.metrics = metrics or Metrics()
        self.tracer = tracer or get_tracer()

        self.serve_informer = SharedIndexInformer(
            clientset.tpuserves(namespace=None), resync_period, name="tpuserve",
            metrics=self.metrics,
        )
        self.pod_informer = SharedIndexInformer(
            clientset.pods(namespace=None), resync_period, name="serve-pod",
            metrics=self.metrics,
        )
        self.serves = Lister(self.serve_informer.indexer, "TPUServe")
        self.pods = Lister(self.pod_informer.indexer, "Pod")

        self.controller = Controller(
            "tpuserve",
            self.sync,
            informers=[self.serve_informer, self.pod_informer],
            recorder=self.recorder,
            metrics=self.metrics,
            kind="TPUServe",
            tracer=self.tracer,
        )
        self.serve_informer.add_event_handler(self.controller.default_handler())
        # Pod events re-key to the owning serve. Progress-only updates are
        # NOT filtered out here (unlike the job controller): the replicas'
        # load reports ARE the autoscaler's input signal.
        self.pod_informer.add_event_handler(ResourceEventHandler(
            on_add=self._enqueue_owner,
            on_update=lambda old, new: self._enqueue_owner(new),
            on_delete=self._enqueue_owner,
        ))
        for mname, help_text in (
            ("tfk8s_serving_ready_replicas",
             "Ready serving replicas per TPUServe."),
            ("tfk8s_serving_replicas", "Live serving replicas per TPUServe."),
            ("tfk8s_serving_desired_replicas",
             "spec.replicas per TPUServe (autoscaler-owned when enabled)."),
            ("tfk8s_serving_smoothed_queue_depth",
             "EMA of the replicas' reported queue depth, per TPUServe."),
            ("tfk8s_serving_rollouts_total",
             "Completed rolling updates (template-hash transitions)."),
            ("tfk8s_serving_scale_events_total",
             "Autoscaler replica changes, by direction."),
            ("tfk8s_serving_pods_created_total",
             "Serving pods created by the reconciler."),
            ("tfk8s_serving_pods_deleted_total",
             "Serving pods deleted by the reconciler."),
            ("tfk8s_serving_pool_ready_replicas",
             "Ready replicas per disaggregated phase pool."),
        ):
            self.metrics.describe(mname, help_text)
        # key -> (ema_queue_depth, ema_qps)
        self._load_ema: Dict[str, Tuple[float, float]] = {}
        # key -> monotonic time of the last autoscale event (cooldown)
        self._last_scale: Dict[str, float] = {}
        # key -> (target_version, start_time) of the rollout in flight
        self._rollout_started: Dict[str, Tuple[str, float]] = {}

    def _enqueue_owner(self, obj) -> None:
        meta = getattr(obj, "obj", obj).metadata  # unwrap DeletedFinalStateUnknown
        name = meta.labels.get(L.SERVE_NAME)
        if name:
            self.controller.enqueue_key(f"{meta.namespace}/{name}")

    def run(self, workers: Optional[int] = None, stop=None, block: bool = True) -> bool:
        from tfk8s_tpu_torch.controller.controller import DEFAULT_SYNC_WORKERS

        return self.controller.run(
            DEFAULT_SYNC_WORKERS if workers is None else workers, stop, block=block
        )

    # ------------------------------------------------------------------ sync

    def sync(self, key: str) -> None:
        ns, name = key.split("/", 1)
        serve = self.serves.get_by_key(key)
        if serve is None:
            self._forget(key)
            return
        if serve.metadata.deletion_timestamp is not None:
            self._finalize(serve)
            return

        cached_status_wire = serde.to_wire(serve.status)
        serve = set_serve_defaults(serde.roundtrip(serve))  # private mutable copy
        serve._status_baseline = cached_status_wire
        errs = validate_serve(serve)
        if errs:
            changed = set_serve_condition(
                serve.status, ServeConditionType.DEGRADED, True,
                reason="ValidationFailed", message="; ".join(errs),
            )
            if changed:
                self.recorder.event(
                    "TPUServe", key, "ValidationFailed", "; ".join(errs)
                )
                self._write_status(serve)
            return

        if SERVE_FINALIZER not in serve.metadata.finalizers:
            try:
                self.cs.tpuserves(ns).patch(
                    serve.metadata.name,
                    {"metadata": {
                        "resourceVersion": str(serve.metadata.resource_version),
                        "finalizers": serve.metadata.finalizers + [SERVE_FINALIZER],
                    }},
                )
            except Conflict:
                self.controller.enqueue_key(key)
            return  # patched object re-enqueues via the watch

        # -- observe --------------------------------------------------------
        version = _serve_version(serve)
        observed = self.pods.list(ns, L.serve_selector(name))
        terminal = (PodPhase.FAILED, PodPhase.SUCCEEDED, PodPhase.DRAINED)
        live = [
            p for p in observed
            if p.metadata.deletion_timestamp is None
            and p.status.phase not in terminal
        ]
        # Failed/completed/drained serving pods are replaced, not
        # restarted in place: delete the carcass; the create pass below
        # brings a fresh replica (new uid -> clean load()->Ready cycle).
        # DRAINED is the graceful case — the replica honored a reclaim
        # notice, unregistered first, and finished its accepted requests
        # under the rollout availability contract (zero failed requests).
        for p in observed:
            if (
                p.status.phase in terminal
                and p.metadata.deletion_timestamp is None
            ):
                reason = (
                    "ReplicaReclaimed"
                    if p.status.phase == PodPhase.DRAINED
                    else "ReplicaFailed"
                )
                self.recorder.event(
                    "TPUServe", key, reason,
                    f"{p.metadata.name}: {p.status.phase.value} "
                    f"{p.status.message}".strip(),
                )
                self._delete_pod(ns, p.metadata.name)

        new = [p for p in live if p.metadata.labels.get(L.SERVE_VERSION) == version]
        old = [p for p in live if p.metadata.labels.get(L.SERVE_VERSION) != version]
        ready_new = [p for p in new if pod_is_ready(p)]
        ready_old = [p for p in old if pod_is_ready(p)]

        # Desired state is a set of pools: one anonymous pool normally,
        # the prefill/decode pair under disaggregation. Surge ceiling and
        # availability floor are computed over the TOTAL so a serve
        # transitioning single<->disagg still honors the rollout contract.
        pools = serve_pools(serve)
        replicas = sum(count for _, count in pools)
        ru = serve.spec.rolling_update
        floor = max(replicas - ru.max_unavailable, 0)
        ceiling = replicas + ru.max_surge

        # rollout bookkeeping: a version transition — INCLUDING the first
        # deployment (observed_version still empty) — opens a trace span
        # and the Started/Complete event pair
        rolling = bool(old) or serve.status.observed_version != version
        if rolling and self._rollout_started.get(key, ("", 0.0))[0] != version:
            self._rollout_started[key] = (version, time.time())
            self.recorder.event(
                "TPUServe", key, "RolloutStarted",
                f"-> {version} ({len(old)} replica(s) to replace)",
            )

        # -- surge creation: bring up new-version replicas, bounded by the
        #    ceiling; per pool, indices not present among that pool's new
        #    pods are missing (indices are pool-local: prefill-0 and
        #    decode-0 coexist)
        to_create: List[Pod] = []
        for phase, count in pools:
            have_idx = {
                int(p.metadata.labels.get(L.REPLICA_INDEX, "-1"))
                for p in new if pod_phase_of(p) == phase
            }
            for i in range(count):
                if i in have_idx:
                    continue
                if len(live) + len(to_create) >= ceiling:
                    break
                pod = render_serve_pod(serve, version, i, phase=phase)
                with self.tracer.start_span(
                    "pod.create", attributes={"pod": pod.metadata.key}
                ) as sp:
                    # same control->data plane handoff as the trainer: the
                    # replica's kubelet/entrypoint spans continue THIS trace,
                    # so a rollout reads as one tree from CRD edit to Ready
                    if sp.traceparent and pod.spec.containers:
                        pod.spec.containers[0].env[TRACEPARENT_ENV] = sp.traceparent
                to_create.append(pod)
        if to_create:
            created = self.cs.pods(ns).create_many(to_create)
            if created:
                self.metrics.inc(
                    "tfk8s_serving_pods_created_total", float(len(created))
                )

        # -- availability-gated old-replica drain: delete old pods only
        #    while the Ready count stays at/above the floor afterwards.
        #    Not-ready old pods are free to go; ready ones leave one at a
        #    time as new replicas pass readiness.
        available = len(ready_new) + len(ready_old)
        for p in sorted(old, key=lambda p: (pod_is_ready(p), p.metadata.name)):
            cost = 1 if pod_is_ready(p) else 0
            if available - cost < floor:
                break  # availability floor: wait for new replicas to ready up
            self.recorder.event(
                "TPUServe", key, "ReplicaDrained",
                f"{p.metadata.name} (version {p.metadata.labels.get(L.SERVE_VERSION)})",
            )
            self._delete_pod(ns, p.metadata.name)
            available -= cost

        # -- scale-down of excess new-version pods (autoscale down or a
        #    replicas edit): highest indices first. Not-ready extras go
        #    freely; a READY extra is deleted only while the Ready count
        #    stays at/above the (new, smaller) floor afterwards — a
        #    scale-down while a retained pod is still loading must not
        #    take the last serving replicas with it (the retained pod's
        #    readiness unblocks the rest, level-triggered).
        desired_by_phase = dict(pools)
        extra = sorted(
            (p for p in new
             if int(p.metadata.labels.get(L.REPLICA_INDEX, "-1"))
             >= desired_by_phase.get(pod_phase_of(p), 0)),
            key=lambda p: (pod_is_ready(p),
                           -int(p.metadata.labels.get(L.REPLICA_INDEX, "-1"))),
        )
        for p in extra:
            cost = 1 if pod_is_ready(p) else 0
            if cost and available - cost < floor:
                break  # wait for the retained replicas to ready up
            self._delete_pod(ns, p.metadata.name)
            available -= cost

        rollout_done = not old and len(ready_new) >= replicas
        if rollout_done and key in self._rollout_started:
            v, t0 = self._rollout_started.pop(key)
            if v == version:
                self.tracer.record_span(
                    "serve.rollout", start=t0, end=time.time(),
                    attributes={"serve": key, "version": version},
                )
                self.recorder.event(
                    "TPUServe", key, "RolloutComplete", f"version {version}"
                )
                self.metrics.inc("tfk8s_serving_rollouts_total")

        self._autoscale(serve, ready_new + ready_old)
        self._update_status(serve, version, live, new, ready_new, ready_old)

        serve_labels = {"namespace": ns, "serve": name}
        self.metrics.set_gauge(
            "tfk8s_serving_ready_replicas",
            float(len(ready_new) + len(ready_old)), serve_labels,
        )
        self.metrics.set_gauge(
            "tfk8s_serving_replicas", float(len(live)), serve_labels
        )
        self.metrics.set_gauge(
            "tfk8s_serving_desired_replicas", float(replicas), serve_labels
        )
        if serve.spec.disaggregation is not None:
            for phase, _count in pools:
                self.metrics.set_gauge(
                    "tfk8s_serving_pool_ready_replicas",
                    float(sum(1 for p in ready_new + ready_old
                              if pod_phase_of(p) == phase)),
                    {**serve_labels, "phase": phase},
                )

        # keep the loop live: readiness flips and load reports arrive via
        # pod updates, but a quiet system (or an autoscaler waiting out
        # its cooldown) still needs a periodic look
        if serve.spec.autoscale.enabled or not rollout_done:
            self.controller.enqueue_after(key, AUTOSCALE_PERIOD_S)

    # ------------------------------------------------------- autoscaler

    def _autoscale(self, serve: TPUServe, ready_pods: List[Pod]) -> None:
        auto = serve.spec.autoscale
        key = serve.metadata.key
        if not auto.enabled:
            self._load_ema.pop(key, None)
            return
        inst_depth = sum(
            p.status.training.get("serving_queue_depth", 0.0) for p in ready_pods
        )
        inst_qps = sum(
            p.status.training.get("serving_qps", 0.0) for p in ready_pods
        )
        prev_depth, prev_qps = self._load_ema.get(key, (inst_depth, inst_qps))
        ema_depth = EMA_ALPHA * inst_depth + (1 - EMA_ALPHA) * prev_depth
        ema_qps = EMA_ALPHA * inst_qps + (1 - EMA_ALPHA) * prev_qps
        self._load_ema[key] = (ema_depth, ema_qps)
        serve.status.queue_depth = round(ema_depth, 3)
        serve.status.qps = round(ema_qps, 3)
        self.metrics.set_gauge(
            "tfk8s_serving_smoothed_queue_depth", ema_depth,
            {"namespace": serve.metadata.namespace, "serve": serve.metadata.name},
        )

        if serve.spec.disaggregation is not None:
            self._autoscale_pools(serve, ready_pods)
            return

        n = serve.spec.replicas
        if not ready_pods or n < 1:
            return  # no signal yet (or scaled to zero by hand)
        per_replica = ema_depth / max(len(ready_pods), 1)
        want = n
        if per_replica > auto.target_queue_depth * auto.high_band:
            want = min(
                max(n + 1, math.ceil(ema_depth / auto.target_queue_depth)),
                auto.max_replicas,
            )
        elif per_replica < auto.target_queue_depth * auto.low_band:
            want = max(n - 1, auto.min_replicas)
        if want == n:
            return
        now = time.monotonic()
        if now - self._last_scale.get(key, -1e9) < auto.cooldown_s:
            return  # cooldown: the anti-flap guarantee
        direction = "up" if want > n else "down"
        try:
            self.cs.tpuserves(serve.metadata.namespace).patch(
                serve.metadata.name, {"spec": {"replicas": want}}
            )
        except (Conflict, NotFound):
            return  # next periodic pass re-evaluates off fresh state
        self._last_scale[key] = now
        serve.spec.replicas = want  # status write below reflects intent
        serve.status.last_scale_time = time.time()
        self.recorder.event(
            "TPUServe", key, "Scaled",
            f"{direction}: {n} -> {want} (ema queue depth "
            f"{ema_depth:.1f}, target {auto.target_queue_depth}/replica)",
        )
        self.metrics.inc(
            "tfk8s_serving_scale_events_total", 1.0, {"direction": direction}
        )
        log.info("%s: autoscale %s %d -> %d (ema depth %.2f)",
                 key, direction, n, want, ema_depth)

    def _autoscale_pools(self, serve: TPUServe, ready_pods: List[Pod]) -> None:
        """Disaggregated autoscaling: each phase pool sizes off ITS OWN
        signal. Prefill replicas absorb queue wait, so the prefill pool
        runs the standard queue-depth law over prefill pods only; decode
        replicas hold long-lived slots, so the decode pool targets slot
        occupancy (live decode slots vs. slot capacity). One spec patch
        carries both counts (a partial patch could clobber the sibling
        pool on a merge that replaces the nested object)."""
        auto = serve.spec.autoscale
        d = serve.spec.disaggregation
        key = serve.metadata.key

        def _ema(tag: str, inst: float) -> float:
            prev, _ = self._load_ema.get(f"{key}#{tag}", (inst, 0.0))
            val = EMA_ALPHA * inst + (1 - EMA_ALPHA) * prev
            self._load_ema[f"{key}#{tag}"] = (val, 0.0)
            return val

        prefill = [p for p in ready_pods if pod_phase_of(p) == "prefill"]
        decode = [p for p in ready_pods if pod_phase_of(p) == "decode"]

        # prefill: queue depth per ready prefill replica (same law as the
        # single-pool autoscaler, scoped to the pool)
        pq = _ema("prefill", sum(
            p.status.training.get("serving_queue_depth", 0.0) for p in prefill
        ))
        want_p = n_p = d.prefill_replicas
        if prefill and n_p >= 1:
            per = pq / len(prefill)
            if per > auto.target_queue_depth * auto.high_band:
                want_p = min(
                    max(n_p + 1, math.ceil(pq / auto.target_queue_depth)),
                    auto.max_replicas,
                )
            elif per < auto.target_queue_depth * auto.low_band:
                want_p = max(n_p - 1, auto.min_replicas)

        # decode: slot occupancy — live decode slots over the pool's slot
        # capacity (ready replicas x max_batch_size)
        slots = _ema("decode", sum(
            p.status.training.get("serving_live_slots", 0.0) for p in decode
        ))
        cap_per = max(serve.spec.batching.max_batch_size, 1)
        want_d = n_d = d.decode_replicas
        if decode and n_d >= 1:
            occ = slots / (len(decode) * cap_per)
            if occ > DECODE_TARGET_OCCUPANCY * auto.high_band:
                want_d = min(
                    max(n_d + 1,
                        math.ceil(slots / (DECODE_TARGET_OCCUPANCY * cap_per))),
                    auto.max_replicas,
                )
            elif occ < DECODE_TARGET_OCCUPANCY * auto.low_band:
                want_d = max(n_d - 1, auto.min_replicas)

        if want_p == n_p and want_d == n_d:
            return
        now = time.monotonic()
        if now - self._last_scale.get(key, -1e9) < auto.cooldown_s:
            return  # cooldown: the anti-flap guarantee
        try:
            self.cs.tpuserves(serve.metadata.namespace).patch(
                serve.metadata.name,
                {"spec": {"disaggregation": {
                    "prefillReplicas": want_p, "decodeReplicas": want_d,
                }}},
            )
        except (Conflict, NotFound):
            return  # next periodic pass re-evaluates off fresh state
        self._last_scale[key] = now
        d.prefill_replicas, d.decode_replicas = want_p, want_d
        serve.status.last_scale_time = time.time()
        for phase, n, want, why in (
            ("prefill", n_p, want_p, f"ema queue depth {pq:.1f}"),
            ("decode", n_d, want_d, f"ema live slots {slots:.1f}"),
        ):
            if want == n:
                continue
            direction = "up" if want > n else "down"
            self.recorder.event(
                "TPUServe", key, "Scaled",
                f"{phase} {direction}: {n} -> {want} ({why})",
            )
            self.metrics.inc(
                "tfk8s_serving_scale_events_total", 1.0,
                {"direction": direction, "phase": phase},
            )
            log.info("%s: autoscale %s pool %s %d -> %d",
                     key, phase, direction, n, want)

    # ----------------------------------------------------------- status

    def _update_status(
        self,
        serve: TPUServe,
        version: str,
        live: List[Pod],
        new: List[Pod],
        ready_new: List[Pod],
        ready_old: List[Pod],
    ) -> None:
        st = serve.status
        st.replicas = len(live)
        st.ready_replicas = len(ready_new) + len(ready_old)
        st.updated_replicas = len(new)
        base = f"/v1/serve/{serve.metadata.namespace}/{serve.metadata.name}"
        pools = serve_pools(serve)
        if serve.spec.disaggregation is None:
            st.endpoint = base
        else:
            # both phase pools are published; the gateway serves the bare
            # path and splits prefill/decode internally
            st.endpoint = ",".join(f"{base}#{phase}" for phase, _ in pools)
        replicas = sum(count for _, count in pools)
        rollout_done = len(new) == len(live) and len(ready_new) >= replicas
        if rollout_done:
            st.observed_version = version
        if serve.spec.disaggregation is None:
            available = st.ready_replicas >= replicas and replicas > 0
        else:
            # a disaggregated serve needs BOTH pools at strength: a fully
            # ready prefill pool can't cover for an empty decode pool
            ready = ready_new + ready_old
            available = replicas > 0 and all(
                sum(1 for p in ready if pod_phase_of(p) == phase) >= count
                for phase, count in pools
            )
        set_serve_condition(
            st, ServeConditionType.AVAILABLE,
            available,
            reason="AllReplicasReady" if available
            else ("ScaledToZero" if replicas == 0 else "Unavailable"),
            message=f"{st.ready_replicas}/{replicas} ready",
        )
        set_serve_condition(
            st, ServeConditionType.PROGRESSING,
            not rollout_done,
            reason="RollingOut" if not rollout_done else "Complete",
            message=f"version {version}",
        )
        set_serve_condition(st, ServeConditionType.DEGRADED, False, reason="")
        self._write_status(serve)

    def _write_status(self, serve: TPUServe) -> bool:
        """Merge-patch the status subresource, with the deep-compare skip
        the job controller uses (the controller is the sole status owner,
        so the cached wire form is an honest baseline)."""
        wire_status = serde.to_wire(serve.status)
        baseline = getattr(serve, "_status_baseline", None)
        if baseline is not None and wire_status == baseline:
            self.metrics.inc("tfk8s_status_patches_skipped_total")
            return True
        try:
            self.cs.tpuserves(serve.metadata.namespace).patch_status(
                serve.metadata.name, {"status": wire_status}
            )
            serve._status_baseline = wire_status
            return True
        except NotFound:
            return False

    # -------------------------------------------------------- teardown

    def _delete_pod(self, ns: str, name: str) -> None:
        try:
            self.cs.pods(ns).delete(name)
            self.metrics.inc("tfk8s_serving_pods_deleted_total")
        except NotFound:
            pass

    def _forget(self, key: str) -> None:
        self._load_ema.pop(key, None)
        self._last_scale.pop(key, None)
        self._rollout_started.pop(key, None)

    def _finalize(self, serve: TPUServe) -> None:
        key = serve.metadata.key
        ns = serve.metadata.namespace
        for p in self.pods.list(ns, L.serve_selector(serve.metadata.name)):
            if p.metadata.deletion_timestamp is None:
                self._delete_pod(ns, p.metadata.name)
        self._forget(key)
        if SERVE_FINALIZER in serve.metadata.finalizers:
            remaining = [
                f for f in serve.metadata.finalizers if f != SERVE_FINALIZER
            ]
            try:
                # rv precondition: completing the delete off a stale list
                # could drop a foreign finalizer (same rule as the job
                # controller's _finalize)
                self.cs.tpuserves(ns).patch(
                    serve.metadata.name,
                    {"metadata": {
                        "resourceVersion": str(serve.metadata.resource_version),
                        "finalizers": remaining,
                    }},
                )
            except Conflict:
                self.controller.enqueue_key(key)
                return
            except NotFound:
                return
        self.recorder.event("TPUServe", key, "ServeDeleted")
        self.recorder.flush()
        self.metrics.remove_labels(
            {"namespace": ns, "serve": serve.metadata.name}
        )
        self.metrics.remove_labels({"serve": serve.metadata.name})
