"""Priority preemption on the port's operator against the reference's, on
the CPU.

Each flow of ``tests/test_preemption.py`` runs through both packages at
once (``_torch_control.side_by_side``): a fake cluster, its
``TPUJobController`` over a ``SliceAllocator`` of one slice and its
``LocalKubelet``, in this process. A higher-priority gang evicts the
lowest-priority running gang when admission fails; the victim's pods are
deleted, its ``preemptions`` counter bumps with ``gang_restarts``
untouched, and it re-admits and resumes when capacity frees.

Layout: the reference's flows hold one ``v5litepod-16`` slice, 4 hosts in
1 slice. The port refuses TPU generations, and ``cpu-N`` admits without
limit in both allocators (each job gets a virtual slice of its own, so
nothing is ever preempted there). So the port runs the same flows on one
``h100-32`` slice: 4 hosts of 8 cards in 1 slice, the same host and slice
counts. Held equal: each job's status fields (``world_version``,
``elastic_replicas``, ``gang_restarts``, ``preemptions``, conditions), the
event reasons, ``tpujob.preemptions_total``, the rendered pods'
``TFK8S_*`` contract env, and each incarnation's resume lineage (the
victim's worker 0 trains the package's MLP: the reference's through its
``Trainer``, as ``tests/test_preemption.py`` does, the port's through its
``run_task`` on ``TFK8S_DEVICE=cpu``), the checkpoint step at start
masked to whether it is past the first save.
"""

import dataclasses
import os
import time

import torch

from _torch_control import PACKAGES, Cluster, contract_env, side_by_side, wait
import _torch_threads  # noqa: F401  (torch's threads under xdist)

ACCELERATOR = {"reference": "v5litepod-16", "port": "h100-32"}
CAPACITY = {n: {a: 1} for n, a in ACCELERATOR.items()}
CKPT_EVERY = 25
OBS = {}  # (plane, job) -> one record per incarnation of worker 0


def _block(env, stop):
    stop.wait(30)


def _reference_train(env, stop):
    """``tests/test_preemption.py``'s ``preempt.train``: process 0 trains
    and checkpoints on a private 1-device mesh; the other ranks hold their
    hosts."""
    from tfk8s_tpu.models import mlp
    from tfk8s_tpu.parallel.mesh import make_mesh
    from tfk8s_tpu.runtime.checkpoint import Checkpointer
    from tfk8s_tpu.runtime.launcher import ProcessContext
    from tfk8s_tpu.runtime.train import TrainConfig, Trainer

    ctx = ProcessContext.from_env(dict(env))
    if ctx.process_id != 0:
        stop.wait(120)
        return
    _observe("reference", ctx, Checkpointer(ctx.checkpoint_dir))
    trainer = Trainer(
        dataclasses.replace(mlp.make_task(), targets={}),
        TrainConfig(steps=100_000, checkpoint_every=CKPT_EVERY, log_every=CKPT_EVERY,
                    checkpoint_dir=ctx.checkpoint_dir, resume=ctx.resuming),
        make_mesh(data=1),
    )
    trainer.fit(stop=stop)


def _port_train(env, stop):
    """The same on the port: process 0 runs the port's MLP through
    ``run_task`` on a 1-device CPU mesh (the job's 32-card mesh is the
    slice's, not this process's)."""
    from tfk8s_tpu_torch.models import mlp
    from tfk8s_tpu_torch.parallel.mesh import build_mesh
    from tfk8s_tpu_torch.runtime.checkpoint import Checkpointer
    from tfk8s_tpu_torch.runtime.launcher import ProcessContext
    from tfk8s_tpu_torch.runtime.train import TrainConfig, run_task

    ctx = ProcessContext.from_env(dict(env))
    if ctx.process_id != 0:
        stop.wait(120)
        return
    _observe("port", ctx, Checkpointer(ctx.checkpoint_dir))
    task = dataclasses.replace(mlp.make_task(), targets={})
    config = TrainConfig(steps=100_000, checkpoint_every=CKPT_EVERY, log_every=CKPT_EVERY,
                         checkpoint_dir=ctx.checkpoint_dir, resume=ctx.resuming)
    # eviction sets the stop event; fit's final save commits the step the
    # victim was evicted at
    run_task(task, env, stop, config=config, mesh=build_mesh(None, torch.device("cpu")))


def _observe(plane, ctx, ckpt):
    OBS.setdefault((plane, ctx.job_name), []).append({
        "gang_restarts": ctx.gang_restarts, "resuming": ctx.resuming,
        "ckpt_step_at_start": ckpt.latest_step() if ckpt.enabled else None,
    })
    ckpt.close()


for _name, _train in (("reference", _reference_train), ("port", _port_train)):
    PACKAGES[_name].registry.register("tpreempt.block", _block)
    PACKAGES[_name].registry.register("tpreempt.train", _train)


def make_job(c, name, priority=0, entrypoint="tpreempt.block", slices=1, env=None):
    t = c.P.t
    return t.TPUJob(
        metadata=t.ObjectMeta(name=name),
        spec=t.TPUJobSpec(
            replica_specs={t.ReplicaType.WORKER: t.ReplicaSpec(
                replicas=4 * slices,
                template=t.ContainerSpec(entrypoint=entrypoint, env=dict(env or {})))},
            tpu=t.TPUSpec(accelerator=ACCELERATOR[c.name], num_slices=slices),
            run_policy=t.RunPolicy(scheduling=t.SchedulingPolicy(gang=True, priority=priority)),
        ),
    )


def evicted(c, name, times=1):
    def check():
        st = c.status(name)
        return st.preemptions == times and not any(
            p.status.phase.value == "Running" for p in c.live_pods(name))
    return check


def test_higher_priority_preempts_and_victim_resumes():
    def flow(c):
        c.cs.tpujobs().create(make_job(c, "low", priority=1))
        wait(lambda: c.has("low", "Running"))
        c.cs.tpujobs().create(make_job(c, "high", priority=10))
        # high takes the slice; low is evicted
        wait(lambda: c.has("high", "Running"))
        wait(evicted(c, "low"))
        out = {"evicted": c.record("low"), "high": c.record("high"),
               "preemptions_total": c.counter("tpujob.preemptions_total")}
        # capacity frees -> the victim re-admits and RESUMES (restart env > 0)
        c.cs.tpujobs().delete("high")
        wait(lambda: c.has("low", "Running") and len(c.live_pods("low")) == 4)
        out["readmitted"] = c.record("low")
        out["env"] = [contract_env(p) for p in c.live_pods("low")]
        out["reasons"] = {"low": c.reasons("low"), "high": c.reasons("high")}
        return out

    out = side_by_side(flow, CAPACITY)
    assert (out["evicted"]["preemptions"], out["evicted"]["gang_restarts"]) == (1, 0)
    assert out["preemptions_total"] == 1
    assert "Preempted" in out["reasons"]["low"]
    assert "PreemptedOther" in out["reasons"]["high"]
    assert out["readmitted"]["gang_restarts"] == 0
    assert [e["TFK8S_GANG_RESTARTS"] for e in out["env"]] == ["1"] * 4


def test_preempted_victim_resumes_from_checkpoint_step(tmp_path):
    """The evicted victim's relaunched worker 0 restores the checkpoint
    step it was evicted at, not step 0, and the eviction never burns
    backoff."""
    def flow(c):
        commits = os.path.join(str(tmp_path), c.name, c.P.checkpoint._COMMITS_DIRNAME)
        victim = make_job(c, "victim", priority=1, entrypoint="tpreempt.train",
                          env={"TFK8S_DEVICE": "cpu"})
        victim.metadata.annotations[c.P.trainer.replicas.CHECKPOINT_DIR_ANNOTATION] = (
            os.path.dirname(commits))
        OBS.pop((c.name, "victim"), None)
        c.cs.tpujobs().create(victim)
        wait(lambda: c.has("victim", "Running"))

        def committed_step():
            if not os.path.isdir(commits):
                return 0
            return max((int(n) for n in os.listdir(commits) if n.isdigit()), default=0)

        # a durably COMMITTED checkpoint exists before the eviction
        wait(lambda: committed_step() >= CKPT_EVERY, timeout=90)
        c.cs.tpujobs().create(make_job(c, "high", priority=10))
        wait(lambda: c.has("high", "Running"))
        wait(evicted(c, "victim"))
        out = {"evicted": c.record("victim")}
        c.cs.tpujobs().delete("high")
        wait(lambda: c.has("victim", "Running"))
        wait(lambda: len(OBS.get((c.name, "victim"), [])) >= 2)
        out["lineage"] = [dict(r, ckpt_step_at_start=(
            r["ckpt_step_at_start"] if r["ckpt_step_at_start"] is None
            else r["ckpt_step_at_start"] >= CKPT_EVERY)) for r in OBS[(c.name, "victim")][:2]]
        out["after"] = c.record("victim")
        return out

    out = side_by_side(flow, CAPACITY)
    first, second = out["lineage"]
    assert first == {"gang_restarts": 0, "resuming": False, "ckpt_step_at_start": None}
    # the relaunch restores the eviction-time checkpoint, not step 0
    assert second == {"gang_restarts": 1, "resuming": True, "ckpt_step_at_start": True}
    assert out["evicted"]["gang_restarts"] == out["after"]["gang_restarts"] == 0
    port = OBS[("port", "victim")][1]["ckpt_step_at_start"]
    assert port >= CKPT_EVERY


def test_infeasible_demand_evicts_nobody():
    """The livelock guard: a job whose demand can never be met (2 slices;
    the pool owns 1) churns no lower-priority gang."""
    def flow(c):
        c.cs.tpujobs().create(make_job(c, "steady", priority=1))
        wait(lambda: c.has("steady", "Running"))
        c.cs.tpujobs().create(make_job(c, "giant", priority=10, slices=2))
        wait(lambda: "GangPending" in c.reasons("giant"))
        time.sleep(2)  # several admission retries
        return {"steady": c.record("steady"), "pods": len(c.live_pods("steady")),
                "reasons": c.reasons(), "preemptions_total": c.counter("tpujob.preemptions_total")}

    out = side_by_side(flow, CAPACITY)
    assert out["steady"]["preemptions"] == 0 and out["pods"] == 4
    assert "Preempted" not in out["reasons"] and not out["preemptions_total"]


def test_equal_priority_never_preempts():
    def flow(c):
        c.cs.tpujobs().create(make_job(c, "a", priority=5))
        wait(lambda: c.has("a", "Running"))
        c.cs.tpujobs().create(make_job(c, "b", priority=5))
        wait(lambda: "GangPending" in c.reasons("b"))
        # a keeps its gang; b waits
        return {"a": c.record("a"), "pods": len(c.live_pods("a")),
                "b_running": c.has("b", "Running"), "b_pods": len(c.live_pods("b"))}

    out = side_by_side(flow, CAPACITY)
    assert (out["pods"], out["b_running"], out["b_pods"]) == (4, False, 0)
    assert out["a"]["preemptions"] == 0


def test_zero_priority_job_cannot_preempt():
    def flow(c):
        c.cs.tpujobs().create(make_job(c, "base", priority=0))
        wait(lambda: c.has("base", "Running"))
        c.cs.tpujobs().create(make_job(c, "also-zero", priority=0))
        wait(lambda: "GangPending" in c.reasons("also-zero"))
        return {"base": c.record("base"), "reasons": c.reasons()}

    out = side_by_side(flow, CAPACITY)
    assert out["base"]["preemptions"] == 0 and "Preempted" not in out["reasons"]


def test_a_recreated_pod_waits_for_its_draining_predecessor():
    """The port's kubelet starts a pod recreated under the name of a pod
    whose thread still drains only once that thread has ended, so the two
    incarnations never run at once (a preempted trainer's final save and
    its successor's restore would race for one checkpoint directory, and
    both would hold one card). The reference's kubelet starts it at once."""
    P = PACKAGES["port"]
    t = P.t
    spans = []  # (incarnation, entry start, entry end)

    def drains(env, stop):
        start = time.monotonic()
        stop.wait(30)
        time.sleep(0.5)  # the drain checkpoint
        spans.append((env["INCARNATION"], start, time.monotonic()))

    P.registry.register("tpreempt.slow_drain", drains)

    def pod(incarnation):
        return t.Pod(metadata=t.ObjectMeta(name="victim", namespace="default"),
                     spec=t.PodSpec(containers=[t.ContainerSpec(
                         entrypoint="tpreempt.slow_drain", env={"INCARNATION": incarnation})]))

    c = Cluster("port")
    c.kubelet.run(c.stop)
    try:
        c.cs.pods().create(pod("1"))
        wait(lambda: c.cs.pods().get("victim").status.phase.value == "Running", 30)
        c.cs.pods().delete("victim")
        c.cs.pods().create(pod("2"))
        wait(lambda: c.cs.pods().get("victim").status.phase.value == "Running", 30)
        c.cs.pods().delete("victim")
        wait(lambda: not c.kubelet._claimed, 30)
    finally:
        c.stop.set()
    (first, _, first_end), (second, second_start, _) = spans
    assert (first, second) == ("1", "2")
    assert second_start >= first_end, spans
