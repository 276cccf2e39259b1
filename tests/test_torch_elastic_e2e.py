"""Elastic, preemption-tolerant training on the port's operator against the
reference's, on the CPU.

Each flow of ``tests/test_elastic_e2e.py`` runs through both packages at
once (``_torch_control.side_by_side``): a fake cluster, its
``TPUJobController`` (or ``TPUServeController``), ``SliceAllocator`` and
``LocalKubelet`` in this process, with ``tests/chaos.py``'s
``ChaosInjector`` on either package's kubelet. Every worker of a 4-worker
elastic ``cpu-1`` job (the reference's layout, in both packages) runs its
package's MLP through its package's ``run_task`` (the port's on
``TFK8S_DEVICE=cpu``); process 0 owns the checkpoint directory.

- a reclaim notice honored: the victim drains, the gang resizes to the
  survivors with ``backoff_limit`` untouched, and the world-1 process 0
  resumes from the drain checkpoint;
- a TPUServe replica on reclaimed capacity drains with zero failed
  requests while four clients hammer the serve;
- a deleted job's controller scratch maps are pruned;
- a cold crash in the resize window defers to the failure accounting;
- ``LocalKubelet.chaos_fail`` itself, in each package.

Held equal: each job's status fields (``world_version``,
``elastic_replicas``, ``gang_restarts``, ``preemptions``, conditions), the
event reasons, ``tfk8s_elastic_resizes_total{direction}``, the re-rendered
pods' ``TFK8S_WORLD_VERSION``, ``TFK8S_NUM_PROCESSES`` and
``TFK8S_GANG_RESTARTS``, and the resume lineage (``resuming``, the
checkpoint step at start against the drain step). The reference's
dropped-notice and scale-up flows, ``slow`` there, are
``tests/test_torch_elastic_restarts.py`` and
``tests/test_torch_elastic_scale_up.py``; its seeded chaos sweep has no
counterpart.
"""

import importlib
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import pytest

from _torch_control import (PACKAGES, Cluster, contract_env, run_side_by_side, side_by_side,
                            wait)
from _torch_elastic import (CAPACITY, OBS, fast_flush, make_elastic_job, process0,
                            reported_step, workers)
from chaos import ChaosInjector
from conftest import wait_for
import _torch_threads  # noqa: F401  (torch's threads under xdist)

@pytest.fixture(autouse=True)
def fast(monkeypatch):
    fast_flush(monkeypatch)


def test_reclaim_notice_resizes_gang_without_burning_backoff(tmp_path):
    """Reclaim 1 of 4 workers WITH notice: the job resizes to 3, backoff
    untouched, and the re-formed world resumes from the drain checkpoint
    with a monotone step counter."""
    def flow(c):
        ckpt = str(tmp_path / c.name / "ckpt")
        name = "elastic"
        OBS.pop((c.name, name), None)
        c.cs.tpujobs().create(make_elastic_job(c.P, name, ckpt))
        wait(lambda: c.has(name, "Running"))
        wait(lambda: reported_step(c, f"{name}-worker-0") >= 20)
        chaos = ChaosInjector(c.cs, c.kubelet, seed=7)
        victim = chaos.pick_worker(name, exclude_index_0=True)
        chaos.reclaim(victim, grace_s=5.0)
        wait(lambda: (c.status(name).world_version, c.status(name).elastic_replicas) == (1, 3))

        def reformed():
            pods = workers(c, name)
            return c.has(name, "Running") and len(pods) == 3 and all(
                p.spec.containers[0].env.get("TFK8S_WORLD_VERSION") == "1"
                and p.status.phase.value == "Running" for p in pods)

        wait(reformed)
        out = {"victim": victim.metadata.name, "record": c.record(name),
               "env": [contract_env(p) for p in workers(c, name)]}
        wait(lambda: any(r.get("drain_step") for r in process0(c, name))
             and any(r["world"] == 1 for r in process0(c, name)))
        drain = next(r for r in process0(c, name) if r.get("drain_step"))
        world1 = next(r for r in process0(c, name) if r["world"] == 1)
        # monotone step counter, observed from the control plane
        wait(lambda: reported_step(c, f"{name}-worker-0") >= drain["drain_step"])
        hists = c.ctrl.metrics.snapshot()["histograms"]
        out.update(
            drained=drain["drain_step"] > 0,
            world1={k: world1[k] for k in ("resuming", "num_processes", "gang_restarts")},
            from_drain=world1["ckpt_step_at_start"] == drain["drain_step"],
            reasons=c.reasons(name),
            down=c.counter("tfk8s_elastic_resizes_total", {"direction": "down"}),
            recovered=(c.ctrl.metrics.get_gauge(
                "tpujob.recovery_seconds", {"namespace": "default", "job": name}) or 0) > 0,
            drain_histogram=any(k.startswith("tfk8s_drain_checkpoint_seconds") for k in hists))
        return out

    out = side_by_side(flow, CAPACITY)
    rec = out["record"]
    assert (rec["gang_restarts"], rec["preemptions"]) == (0, 0), "a resize burns no backoff"
    assert rec["conditions"] == ["Created", "Running"]
    assert [(e["TFK8S_WORLD_VERSION"], e["TFK8S_NUM_PROCESSES"]) for e in out["env"]] == [
        ("1", "3")] * 3
    assert out["drained"] and out["from_drain"], "resumed from the drain checkpoint"
    assert out["world1"] == {"resuming": True, "num_processes": 3, "gang_restarts": 0}
    assert {"ElasticResize", "ResizeComplete"} <= set(out["reasons"])
    assert out["down"] == 1.0 and out["recovered"] and out["drain_histogram"]


def test_reclaimed_serve_replica_drains_with_zero_failed_requests(tmp_path):
    """A TPUServe replica under a reclaim notice unregisters first, finishes
    its accepted requests, exits Drained and is replaced, while four
    clients hammer the serve: not one request fails, in either package
    (the port's serves run the port's own echo entry point)."""
    def go(name):
        def run():
            P = PACKAGES[name]
            ServeClient = importlib.import_module(f"{P.root}.runtime.server").ServeClient
            with Cluster(name, serves=True) as c:
                t = P.t
                serve = t.TPUServe(
                    metadata=t.ObjectMeta(name="spot-serve"),
                    spec=t.TPUServeSpec(task="echo", checkpoint="v1", replicas=3,
                                        batching=t.BatchingPolicy(
                                            max_batch_size=8, batch_timeout_ms=2.0,
                                            queue_limit=256)))
                serve.spec.template.env.update({"TFK8S_SERVE_ECHO_DELAY_MS": "3",
                                                "TFK8S_DEVICE": "cpu"})
                c.cs.tpuserves().create(serve)
                ready = lambda: c.cs.tpuserves().get("spot-serve").status.ready_replicas  # noqa: E731
                wait(lambda: ready() == 3, timeout=60)
                failures, served = [], []
                stop = threading.Event()
                client = ServeClient(c.cs, "spot-serve")

                def hammer(i):
                    while not stop.is_set():
                        try:
                            client.request(float(i), timeout=30)
                            served.append(1)
                        except Exception as e:  # noqa: BLE001 — every failure counts
                            failures.append(e)

                with ThreadPoolExecutor(4) as pool:
                    for i in range(4):
                        pool.submit(hammer, i)
                    time.sleep(0.5)
                    pods, _ = c.cs.pods().list(
                        label_selector=P.labels.serve_selector("spot-serve"))
                    victim = sorted(pods, key=lambda p: p.metadata.name)[1]
                    c.kubelet.deliver_reclaim(victim.metadata.key, grace_s=5.0)

                    def healed():
                        try:
                            if c.cs.pods().get(victim.metadata.name).metadata.uid == (
                                    victim.metadata.uid):
                                return False  # the old carcass is still there
                        except P.store.NotFound:
                            pass
                        return ready() == 3

                    healed_ok = wait_for(healed, timeout=60)
                    time.sleep(0.5)  # keep hammering the healed set a moment
                    stop.set()
                return {"healed": healed_ok, "failures": [repr(e) for e in failures[:3]],
                        "served_over_50": len(served) > 50,
                        "reclaimed": "ReplicaReclaimed" in c.reasons()}
        return run

    out = run_side_by_side({n: go(n) for n in PACKAGES}, timeout=150)
    assert out["port"] == out["reference"], out
    assert out["port"] == {"healed": True, "failures": [], "served_over_50": True,
                           "reclaimed": True}


def test_deleted_job_prunes_all_controller_scratch_maps():
    """Every per-job scratch map empties on delete, the pod-keyed
    ``_pending_restart_counts`` included, and a job whose name shares a
    prefix keeps its entries."""
    out = {}
    for name, P in PACKAGES.items():
        ctrl = P.trainer.TPUJobController(P.FakeClientset(),
                                          allocator=P.trainer.SliceAllocator())
        key = "default/leaky"
        ctrl._gang_restarts_floor[key] = 2
        ctrl._preemptions_floor[key] = 1
        ctrl._elastic_floor[key] = (3, 2)
        ctrl._resize_started[key] = (time.time(), "down")
        ctrl._last_resize[key] = time.time()
        ctrl._evaluator_failures_seen.add((key, "uid-1"))
        ctrl._pending_restart_counts["default/leaky-worker-0"] = 2
        ctrl._pending_restart_counts["default/leaky-evaluator-1"] = 1
        # decoys that must SURVIVE: another namespace, and the job named
        # "leaky-worker" whose pods continue past the digits
        ctrl._pending_restart_counts["other/leaky-worker-0"] = 7
        ctrl._pending_restart_counts["default/leaky-worker-worker-0"] = 7
        ctrl._gang_restarts_floor["default/other"] = 9
        ctrl._prune_job_state(key)
        out[name] = {m: getattr(ctrl, m) for m in (
            "_gang_restarts_floor", "_preemptions_floor", "_elastic_floor", "_resize_started",
            "_last_resize", "_evaluator_failures_seen", "_pending_restart_counts")}

    assert out["port"] == out["reference"], out
    assert out["port"] == {
        "_gang_restarts_floor": {"default/other": 9}, "_preemptions_floor": {},
        "_elastic_floor": {}, "_resize_started": {}, "_last_resize": {},
        "_evaluator_failures_seen": set(),
        "_pending_restart_counts": {"other/leaky-worker-0": 7,
                                    "default/leaky-worker-worker-0": 7}}


def test_cold_crash_during_resize_window_defers_to_failure_accounting(tmp_path):
    """A worker that cold-crashes (Failed, no reclaim notice) in the sync of
    a resize trigger is not consumed by the resize: ``_handle_elastic``
    defers to the failure machinery. A Failed pod WITH the notice is drain
    collateral and does not defer."""
    out = {}
    for name, P in PACKAGES.items():
        t = P.t
        ctrl = P.trainer.TPUJobController(P.FakeClientset(),
                                          allocator=P.trainer.SliceAllocator())
        job = make_elastic_job(P, "cold", str(tmp_path / name / "ck"), debounce=0.0)
        job.status.elastic_replicas = 3
        job.status.world_version = 1
        job._elastic_desired = 4

        def pod(i, phase, annotations=None):
            return t.Pod(
                metadata=t.ObjectMeta(name=f"cold-worker-{i}", namespace="default",
                                      labels={P.labels.REPLICA_TYPE: "Worker"},
                                      annotations=dict(annotations or {})),
                spec=t.PodSpec(containers=[
                    t.ContainerSpec(entrypoint="x", env={"TFK8S_WORLD_VERSION": "1"})]),
                status=t.PodStatus(phase=phase))

        observed = {f"cold-worker-{i}": pod(i, t.PodPhase.RUNNING) for i in range(3)}
        observed["cold-worker-3"] = pod(3, t.PodPhase.FAILED)
        # scale-up is due (debounce 0, 3 < 4) but the cold crash defers the
        # whole elastic sync: no world bump, the failure path's turn
        deferred = (ctrl._handle_elastic(job, observed), job.status.world_version)
        # the SAME crash carrying the reclaim notice is drain collateral:
        # the resize proceeds (down, victims excluded) and bumps the world
        observed["cold-worker-3"] = pod(3, t.PodPhase.FAILED,
                                        {P.kubelet.RECLAIM_AT_ANNOTATION: "1.000"})
        out[name] = [deferred, (ctrl._handle_elastic(job, observed), job.status.world_version)]

    assert out["port"] == out["reference"] == [(False, 1), (True, 2)]


@pytest.mark.parametrize("plane", list(PACKAGES))
def test_chaos_fail_outranks_a_drained_exit(plane):
    """``LocalKubelet.chaos_fail``: a poisoned pod ends Failed with the
    message even though its entry point drained, and the poison map
    empties with the pod."""
    P = PACKAGES[plane]
    t = P.t
    started = threading.Event()

    def drains(env, stop):
        started.set()
        stop.wait(30)
        raise P.registry.PodDrained("drained at step 3 on reclaim notice")

    P.registry.register(f"telastic.drains.{plane}", drains)
    c = Cluster(plane)
    c.kubelet.run(c.stop)
    try:
        c.cs.pods().create(t.Pod(
            metadata=t.ObjectMeta(name="poisoned", namespace="default"),
            spec=t.PodSpec(containers=[t.ContainerSpec(entrypoint=f"telastic.drains.{plane}")])))
        assert started.wait(30)
        c.kubelet.chaos_fail("default/poisoned", "chaos: node died (notice dropped)")
        wait(lambda: c.cs.pods().get("poisoned").status.phase.value == "Failed", timeout=30)
        wait(lambda: not c.kubelet._claimed, timeout=30)
        pod = c.cs.pods().get("poisoned")
        assert pod.status.message == "RuntimeError: chaos: node died (notice dropped)"
        assert c.kubelet._chaos_fail == {}
        # a pod the kubelet does not run is no target
        c.kubelet.chaos_fail("default/absent")
        assert c.kubelet._chaos_fail == {}
    finally:
        c.stop.set()
