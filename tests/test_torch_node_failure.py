"""Node loss on the port's operator against the reference's, on the CPU.

(i) The three flows of ``tests/test_node_failure.py`` run through both
    packages at once (``_torch_control.run_side_by_side``), each on its
    own fake clientset with its ``TPUJobController`` and ``LocalKubelet``s
    in this process: a kubelet renews its ``node-<name>`` Lease; a dead
    node's Running pod is marked ``Failed(NodeLost)`` and the gang restarts
    onto a second node; a pod whose node's lease was deleted is never
    marked. Held equal: the lease's fields, the event reasons and the
    ``NodeLost`` message with its times masked, ``gang_restarts`` and the
    replacement pod's host; ``tpujob.node_lost_pods_total`` is 1 on the
    port and at least that on the reference, which counts a pod again
    on a sync that read a stale cache (a fourth flow shows it).
(ii) Four processes, each ``python -m tfk8s_tpu_torch.cmd.main`` with JAX
    and the reference package unimportable (``tests/test_torch_imports.py``'s
    finder): ``apiserver``, ``operator --no-local-kubelet`` and the
    ``kubelet``s ``node-a`` (a 2 s lease through ``TFK8S_NODE_LEASE_*``)
    and ``node-b``, each kubelet's process importing the entry point's
    module (torch with it) before its kubelet starts. An MLP TPUJob on ``cpu-2`` over ``{"data": 2}`` (a pod
    of two rank processes, ``runtime/pod_ranks.py``) checkpointing every
    step is held after its third update, with step 1 committed and step
    2's directory written but unmarked; ``node-a`` is then killed with
    SIGKILL. Its ranks must write nothing more into the checkpoint
    directory (their node is gone: no final save), and the job must resume
    on ``node-b`` from step 1, the last committed step, and succeed with
    one gang restart.
"""

import json
import os
import re
import signal
import subprocess
import sys
import threading
import time

from _torch_control import PACKAGES, run_side_by_side, wait
from conftest import wait_for
from test_torch_imports import _BLOCK
import _torch_node_entry as entry
import _torch_threads  # noqa: F401  (torch's threads under xdist)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
BLOCK_ENTRY = "nodefail.block"
LEASE_S, RENEW_S = 0.5, 0.1  # the reference's node-a and node-b
# seconds a blocked pod waits for its stop before it returns
BLOCK_S = 30.0


def _block(env, stop):
    stop.wait(BLOCK_S)


for _P in PACKAGES.values():
    _P.registry.register(BLOCK_ENTRY, _block)


def _job(P, name):
    t = P.t
    return t.TPUJob(
        metadata=t.ObjectMeta(name=name),
        spec=t.TPUJobSpec(
            replica_specs={t.ReplicaType.WORKER: t.ReplicaSpec(
                replicas=1, template=t.ContainerSpec(entrypoint=BLOCK_ENTRY))},
            tpu=t.TPUSpec(accelerator="cpu-1"),
            run_policy=t.RunPolicy(scheduling=t.SchedulingPolicy(gang=True)),
        ),
    )


class _Plane:
    """One package's fake clientset and job controller over two ``cpu-1``
    slices, and the kubelets a flow starts on it. On exit the jobs are
    deleted and every kubelet and the controller stopped."""

    def __init__(self, name):
        self.P = P = PACKAGES[name]
        self.cs = P.FakeClientset()
        self.ctrl = P.trainer.TPUJobController(
            self.cs, allocator=P.trainer.SliceAllocator({"cpu-1": 2}))
        self.stop = threading.Event()
        self.kubelets = {}

    def __enter__(self):
        assert self.ctrl.run(workers=2, stop=self.stop, block=False)
        return self

    def kubelet(self, name, **lease):
        stop = threading.Event()
        self.P.LocalKubelet(self.cs, name=name, **lease).run(stop)
        self.kubelets[name] = stop
        return stop

    def pods(self, job):
        pods, _ = self.cs.pods().list(label_selector=self.P.labels.job_selector(job))
        return pods

    def running(self, job, host=None):
        return any(p.status.phase == self.P.t.PodPhase.RUNNING
                   and host in (None, p.status.host) for p in self.pods(job))

    def events(self, job):
        return [e for e in self.ctrl.recorder.events(key=f"default/{job}")]

    def __exit__(self, *exc):
        try:
            objs, _ = self.cs.tpujobs().list()
            for obj in objs:
                try:
                    self.cs.tpujobs().delete(obj.metadata.name)
                except self.P.store.NotFound:
                    pass
        finally:
            for stop in self.kubelets.values():
                stop.set()
            self.stop.set()
            self.ctrl.controller.shutdown()


def _lease(plane, node):
    try:
        return plane.cs.generic("Lease", "default").get(
            plane.P.kubelet.NODE_LEASE_PREFIX + node).spec
    except plane.P.store.NotFound:
        return None


_STALE_FOR = re.compile(r"stale for \d+\.\d+s")


def test_a_kubelet_renews_its_node_lease_in_both_packages():
    def flow(name):
        def run():
            with _Plane(name) as plane:
                plane.kubelet("hb-node", lease_renew_s=0.1)
                wait(lambda: _lease(plane, "hb-node") is not None)
                first = _lease(plane, "hb-node")
                wait(lambda: _lease(plane, "hb-node").renew_time > first.renew_time)
                spec = _lease(plane, "hb-node")
                return {"name": plane.P.kubelet.NODE_LEASE_PREFIX + "hb-node",
                        "holder": spec.holder, "duration_s": spec.lease_duration_s,
                        "acquired_first": spec.acquire_time <= first.renew_time}
        return run

    out = run_side_by_side({n: flow(n) for n in PACKAGES})
    assert out["port"] == out["reference"]
    assert out["port"] == {"name": "node-hb-node", "holder": "hb-node",
                           "duration_s": 20.0, "acquired_first": True}


def test_a_dead_nodes_pod_fails_node_lost_and_runs_again_on_a_second_node():
    def flow(name):
        def run():
            with _Plane(name) as plane:
                stop_a = plane.kubelet("node-a", lease_duration_s=LEASE_S,
                                       lease_renew_s=RENEW_S)
                plane.cs.tpujobs().create(_job(plane.P, "nl"))
                wait(lambda: plane.running("nl", "node-a"))
                stop_a.set()  # node-a dies: its lease stops, its pod thread is orphaned
                wait(lambda: any(e.reason == "NodeLost" for e in plane.events("nl")))
                plane.kubelet("node-b", lease_duration_s=LEASE_S, lease_renew_s=RENEW_S)
                wait(lambda: plane.running("nl", "node-b"))
                job = plane.cs.tpujobs().get("nl")
                lost = [e for e in plane.events("nl") if e.reason == "NodeLost"]
                return {
                    "node_lost": sorted({_STALE_FOR.sub("stale for <s>", e.message)
                                         for e in lost}),
                    "node_lost_pods_total": plane.ctrl.metrics.get_counter(
                        "tpujob.node_lost_pods_total"),
                    "restarted": job.status.gang_restarts >= 1,
                    "hosts": sorted(p.status.host for p in plane.pods("nl")
                                    if p.status.phase == plane.P.t.PodPhase.RUNNING),
                    "reasons_seen": sorted({"NodeLost", "GangRestart"}
                                           & {e.reason for e in plane.events("nl")}),
                }
        return run

    out = run_side_by_side({n: flow(n) for n in PACKAGES}, timeout=120)
    # the reference may count the pod again on a sync that read a stale
    # cache (test_a_sync_on_a_stale_cache_...): the port counts it once
    counts = {n: rec.pop("node_lost_pods_total") for n, rec in out.items()}
    assert out["port"] == out["reference"]
    assert counts["reference"] >= counts["port"] == 1
    rec = out["port"]
    assert rec["node_lost"] == ["nl-worker-0: NodeLost: node node-a lease stale for <s> "
                                f"(duration {LEASE_S}s)"]
    assert rec["restarted"]
    assert rec["hosts"] == ["node-b"]


def test_a_pod_whose_node_lease_was_deleted_is_left_alone_in_both_packages():
    def flow(name):
        def run():
            with _Plane(name) as plane:
                plane.kubelet("quiet-node", lease_renew_s=3600)
                plane.cs.tpujobs().create(_job(plane.P, "quiet"))
                wait(lambda: plane.running("quiet"))
                wait(lambda: _lease(plane, "quiet-node") is not None)
                plane.cs.generic("Lease", "default").delete(
                    plane.P.kubelet.NODE_LEASE_PREFIX + "quiet-node")
                time.sleep(2.5)  # several NODE_CHECK_PERIOD_S cycles
                return {"reasons": sorted({e.reason for e in plane.events("quiet")}),
                        "node_lost_pods_total": plane.ctrl.metrics.get_counter(
                            "tpujob.node_lost_pods_total"),
                        "phases": [p.status.phase.value for p in plane.pods("quiet")]}
        return run

    out = run_side_by_side({n: flow(n) for n in PACKAGES})
    assert out["port"] == out["reference"]
    assert "NodeLost" not in out["port"]["reasons"]
    assert out["port"]["phases"] == ["Running"]


def test_a_sync_on_a_stale_cache_counts_a_lost_pod_once_on_the_port_alone():
    """Two node checks of one job on the same cached pods, as when a sync
    reads the informer's cache before the first mark reaches it. Both
    packages mark the pod ``Failed`` once; the reference records
    ``NodeLost`` and counts ``tpujob.node_lost_pods_total`` on both checks,
    the port only where its mark landed. A known behaviour of the
    reference, which is not edited."""
    out = {}
    for name, P in PACKAGES.items():
        t, cs = P.t, P.FakeClientset()
        ctrl = P.trainer.TPUJobController(cs, allocator=P.trainer.SliceAllocator({"cpu-1": 1}))
        job = cs.tpujobs().create(_job(P, "nl"))
        pods = cs.pods("default")
        pods.create(t.Pod(metadata=t.ObjectMeta(name="nl-worker-0", namespace="default")))
        pods.patch_status("nl-worker-0", {"status": {"phase": "Running", "host": "node-x"}})
        stale = time.time() - 60
        cs.generic("Lease", "default").create(t.Lease(
            metadata=t.ObjectMeta(name=P.kubelet.NODE_LEASE_PREFIX + "node-x",
                                  namespace="default"),
            spec=t.LeaseSpec(holder="node-x", lease_duration_s=LEASE_S,
                             acquire_time=stale, renew_time=stale)))
        cached = {"nl-worker-0": pods.get("nl-worker-0")}
        for _ in range(2):
            ctrl._check_node_liveness(job, cached)
        out[name] = {"phase": pods.get("nl-worker-0").status.phase.value,
                     "events": [e.reason for e in ctrl.recorder.events(key="default/nl")],
                     "counted": ctrl.metrics.get_counter("tpujob.node_lost_pods_total")}
    assert out["port"] == {"phase": "Failed", "events": ["NodeLost"], "counted": 1}
    assert out["reference"] == {"phase": "Failed", "events": ["NodeLost"] * 2, "counted": 2}


# -- four processes, and a SIGKILL of the node mid-save -----------------------------

_MAIN = (
    "import runpy\n"
    "sys.argv = ['tfk8s_tpu_torch.cmd.main'] + sys.argv[1:]\n"
    "runpy.run_module('tfk8s_tpu_torch.cmd.main', run_name='__main__')\n")
# a node's runtime warmed (torch and the entry point imported) before its
# kubelet starts, so node-b's imports overlap node-a's run
_WARM = "import _torch_node_entry\n"
HOLD_AT = 3  # step 1 committed, step 2 written but unmarked, step 3 not saved
STEPS = 6
NODE_LEASE = {"TFK8S_NODE_LEASE_DURATION_S": "2", "TFK8S_NODE_LEASE_RENEW_S": "0.25"}


def _start(args, log, warm=False, **env):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join((REPO, TESTS)),
               OMP_NUM_THREADS="1", **env)
    main = _BLOCK + (_WARM if warm else "") + _MAIN
    return subprocess.Popen([sys.executable, "-c", main] + args, cwd=REPO, env=env,
                            stdout=log, stderr=subprocess.STDOUT)


def _listing(directory):
    """Every path under ``directory`` with its size and modification time."""
    out = {}
    for root, dirs, files in os.walk(directory):
        for name in dirs + files:
            path = os.path.join(root, name)
            try:
                st = os.lstat(path)
            except FileNotFoundError:
                continue
            out[os.path.relpath(path, directory)] = (st.st_size, st.st_mtime_ns)
    return out


def _alive(pid):
    """Whether ``pid`` runs (a zombie that no parent reaped does not)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (FileNotFoundError, ProcessLookupError):
        return False


def _read(path):
    with open(path) as f:
        return json.load(f)


def test_a_node_killed_mid_save_writes_nothing_more_and_the_job_resumes_on_a_second_node(
        tmp_path):
    from tfk8s_tpu_torch.client.remote import clientset_from_kubeconfig
    from tfk8s_tpu_torch.runtime.checkpoint import _COMMITS_DIRNAME
    from tfk8s_tpu_torch.trainer import labels as L
    from tfk8s_tpu_torch.trainer.replicas import CHECKPOINT_DIR_ANNOTATION

    P = PACKAGES["port"]
    kc, ckpt, records = (str(tmp_path / "kc.json"), str(tmp_path / "ckpt"),
                         str(tmp_path / "records"))
    os.makedirs(records)
    names = ("api", "op", "node-a", "node-b")
    logs = {n: open(tmp_path / f"{n}.log", "wb") for n in names}
    procs = {}

    def tails():
        return "\n".join(f"--- {n}\n" + (tmp_path / f"{n}.log").read_text()[-2500:]
                         for n in procs)

    try:
        procs["api"] = _start(["apiserver", "--port", "0", "--write-kubeconfig", kc],
                              logs["api"])
        assert wait_for(lambda: os.path.exists(kc) and os.path.getsize(kc) > 0,
                        timeout=90), tails()
        procs["op"] = _start(["operator", "--kubeconfig", kc, "--no-local-kubelet",
                              "--workers", "2"], logs["op"])
        procs["node-a"] = _start(["kubelet", "--kubeconfig", kc, "--name", "node-a"],
                                 logs["node-a"], warm=True, **NODE_LEASE)
        cs = clientset_from_kubeconfig(kc)
        env = {"TFK8S_DEVICE": "cpu", "TFK8S_MESH": json.dumps({"data": 2}),
               "TFK8S_TRAIN_STEPS": str(STEPS), "TFK8S_CHECKPOINT_EVERY": "1",
               "TFK8S_LOG_EVERY": "1", entry.HOLD_AT_ENV: str(HOLD_AT),
               entry.RECORD_DIR_ENV: records}
        t = P.t
        job = t.TPUJob(
            metadata=t.ObjectMeta(name="lost", annotations={CHECKPOINT_DIR_ANNOTATION: ckpt}),
            spec=t.TPUJobSpec(
                replica_specs={t.ReplicaType.WORKER: t.ReplicaSpec(
                    replicas=1, template=t.ContainerSpec(
                        entrypoint="_torch_node_entry:mlp_held", env=env))},
                tpu=t.TPUSpec(accelerator="cpu-2"),
                run_policy=t.RunPolicy(backoff_limit=1,
                                       scheduling=t.SchedulingPolicy(gang=True))))
        cs.tpujobs().create(job)

        def pods():
            return cs.pods().list(label_selector={L.JOB_NAME: "lost"})[0]

        def running_on(host):
            return any(p.status.phase.value == "Running" and p.status.host == host
                       for p in pods())

        assert wait_for(lambda: running_on("node-a"), timeout=90), tails()
        # node-b starts now, so its imports overlap the run; the pod is
        # Running, so only a replacement can be node-b's
        procs["node-b"] = _start(["kubelet", "--kubeconfig", kc, "--name", "node-b"],
                                 logs["node-b"], warm=True)
        marker = os.path.join(ckpt, _COMMITS_DIRNAME)
        held = [os.path.join(records, f"held-{r}.json") for r in range(2)]
        assert wait_for(lambda: all(map(os.path.exists, held))
                        and os.path.exists(os.path.join(ckpt, "2", "state.pt")),
                        timeout=90), tails()
        assert sorted(os.listdir(marker)) == ["1"], tails()
        before = _listing(ckpt)
        procs["node-a"].send_signal(signal.SIGKILL)
        procs["node-a"].wait(10)
        ranks = [_read(h)["pid"] for h in held]
        assert wait_for(lambda: not any(map(_alive, ranks)), timeout=90), (ranks, tails())
        # the node is gone: its ranks saved nothing after the kill
        assert _listing(ckpt) == before, (sorted(before), sorted(_listing(ckpt)))

        def ended():
            conds = {c.type.value for c in cs.tpujobs().get("lost").status.conditions
                     if c.status}
            return conds & {"Succeeded", "Failed"}

        assert wait_for(ended, timeout=120), tails()
        lost = cs.tpujobs().get("lost")
        assert ended() == {"Succeeded"}, (lost.status, tails())
        assert lost.status.gang_restarts == 1
        (pod,) = pods()
        assert (pod.status.phase.value, pod.status.host) == ("Succeeded", "node-b")
        # the operator mirrors its events into the cluster, one object a
        # reason counting its recordings
        events, _ = cs.generic("Event", "default").list()
        lost_events = [e.count for e in events
                       if e.involved_key == "default/lost" and e.reason == "NodeLost"]
        assert lost_events == [1], [(e.reason, e.count) for e in events]
        # the replacement resumed from the last committed step
        assert not os.path.exists(os.path.join(records, "run-0.json"))
        resumed = _read(os.path.join(records, "run-1.json"))
        assert resumed == {"found": 1, "steps": list(range(2, STEPS + 1))}, resumed
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
            p.wait(10)
        for f in logs.values():
            f.close()
