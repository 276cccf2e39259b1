"""Suspend and resume (``RunPolicy.suspend``) on the port's operator against
the reference's, on the CPU.

Both flows of ``tests/test_suspend.py`` run through both packages at once
(``_torch_control.side_by_side``): suspending a running job evicts its
gang (pods deleted, slices returned, the job parked with a ``Suspended``
condition), the freed capacity runs another job, and resuming re-admits it
with the eviction counter driving checkpoint resume; a job created
suspended parks and later starts fresh.

Layout: as in ``tests/test_torch_preemption.py``, one ``v5litepod-16``
slice for the reference and one ``h100-32`` slice for the port (4 hosts in
1 slice each: ``cpu-N`` admits without limit, so nothing is freed or
taken there). Held equal: the job's status fields and conditions, the
free slice counts, ``start_time`` cleared while parked, the event reasons
and the re-rendered pods' contract env. Every step waits on a condition,
not a sleep.

The reference's first flow fails now and then under ``-n 6``: a sync from
a job copy the cache has not updated with the controller's own suspension
write suspends the job a second time and patches the stale eviction
count back (the last test shows it on both controllers). The port's
controller waits for its own write, so the parked job's ``preemptions``
and ``tpujob.suspensions_total`` are checked on the port alone.
"""

import importlib

import pytest

from _torch_control import PACKAGES, Cluster, contract_env, side_by_side, wait
import _torch_threads  # noqa: F401  (torch's threads under xdist)

ACCELERATOR = {"reference": "v5litepod-16", "port": "h100-32"}
CAPACITY = {n: {a: 1} for n, a in ACCELERATOR.items()}


def _block(env, stop):
    stop.wait(30)


for _P in PACKAGES.values():
    _P.registry.register("tsuspend.block", _block)


def make_job(c, name, suspend=False):
    t = c.P.t
    job = t.TPUJob(
        metadata=t.ObjectMeta(name=name),
        spec=t.TPUJobSpec(
            replica_specs={t.ReplicaType.WORKER: t.ReplicaSpec(
                replicas=4, template=t.ContainerSpec(entrypoint="tsuspend.block"))},
            tpu=t.TPUSpec(accelerator=ACCELERATOR[c.name]),
            run_policy=t.RunPolicy(scheduling=t.SchedulingPolicy(gang=True)),
        ),
    )
    job.spec.run_policy.suspend = suspend
    return job


def free(c):
    """The free slices of the cluster's one-slice layout."""
    return c.ctrl.allocator.free_slices(ACCELERATOR[c.name])


def set_suspend(c, name, value):
    for _ in range(5):
        job = c.cs.tpujobs().get(name)
        job.spec.run_policy.suspend = value
        try:
            c.cs.tpujobs().update(job)
            return
        except c.P.store.Conflict:
            continue
    raise AssertionError("could not flip suspend")


def running_gang(c, name):
    """The job Running with its four pods, all of the latest incarnation."""
    def check():
        if not c.has(name, "Running"):
            return False
        pods = c.live_pods(name)
        gen = str(c.status(name).preemptions)
        return len(pods) == 4 and all(
            contract_env(p)["TFK8S_GANG_RESTARTS"] == gen for p in pods)
    return check


def test_suspend_frees_capacity_and_resume_restores():
    def flow(c):
        c.cs.tpujobs().create(make_job(c, "s1"))
        wait(running_gang(c, "s1"))
        wait(lambda: free(c) == 0)

        set_suspend(c, "s1", True)
        wait(lambda: c.has("s1", "Suspended"))
        wait(lambda: not c.live_pods("s1"))
        wait(lambda: free(c) == 1)
        parked = c.record("s1")
        out = {"parked": dict(parked, preemptions=None),
               "parked_preemptions": parked["preemptions"],
               "start_time": c.status("s1").start_time,
               "suspensions_total": c.counter("tpujob.suspensions_total")}

        # freed capacity is genuinely usable: another job runs meanwhile
        c.cs.tpujobs().create(make_job(c, "filler"))
        wait(running_gang(c, "filler"))
        c.cs.tpujobs().delete("filler")
        wait(lambda: c.status("filler") is None and free(c) == 1)

        # resume: re-admits, pods come back with the resume contract set
        set_suspend(c, "s1", False)
        wait(lambda: not c.has("s1", "Suspended") and running_gang(c, "s1")())
        out["resumed"] = c.record("s1")
        out["env"] = [contract_env(p) for p in c.live_pods("s1")]
        out["reasons"] = c.reasons("s1")
        return out

    out = side_by_side(flow, CAPACITY, port_only=("parked_preemptions", "suspensions_total"))
    assert (out["parked_preemptions"], out["parked"]["gang_restarts"]) == (1, 0)
    assert "Suspended" in out["parked"]["conditions"]
    # the active-deadline clock is paused while parked (kueue semantics)
    assert out["start_time"] is None
    assert out["suspensions_total"] == 1
    assert "Suspended" not in out["resumed"]["conditions"]
    assert [e["TFK8S_GANG_RESTARTS"] for e in out["env"]] == ["1"] * 4
    assert {"JobSuspended", "JobResumed"} <= set(out["reasons"])


def test_suspend_is_idempotent_and_created_suspended_jobs_park():
    def flow(c):
        c.cs.tpujobs().create(make_job(c, "born-parked", suspend=True))
        wait(lambda: c.has("born-parked", "Suspended"))
        # never admitted, never got pods; suspending an unstarted job does
        # not invent a resume incarnation
        out = {"parked": c.record("born-parked"), "pods": len(c.live_pods("born-parked")),
               "free": free(c)}
        set_suspend(c, "born-parked", False)
        wait(running_gang(c, "born-parked"))
        # fresh start, not a resume
        out["env"] = [contract_env(p) for p in c.live_pods("born-parked")]
        out["started"] = c.record("born-parked")
        return out

    out = side_by_side(flow, CAPACITY)
    assert (out["parked"]["preemptions"], out["pods"], out["free"]) == (0, 0, 1)
    assert [e["TFK8S_GANG_RESTARTS"] for e in out["env"]] == ["0"] * 4


def test_a_stale_resync_of_a_just_suspended_job_suspends_once():
    """The race behind ``-n 6`` failures of the reference's first flow: the
    evicted pods' events re-enqueue the job before the status event that
    carries its Suspended condition, so a sync suspends it again from the
    stale copy and patches the stale eviction count back (the status patch
    carries no resourceVersion). The port's controller waits for its own
    write instead. Both controllers get the same two copies of a job with a
    gang held: the fresh one, then the stale one."""
    out = {}
    for name, P in PACKAGES.items():
        c = Cluster(name, capacity={ACCELERATOR[name]: 1})
        job = c.cs.tpujobs().create(make_job(c, "racy", suspend=True))
        defaults = importlib.import_module(f"{P.root}.api.defaults")
        assert c.ctrl.allocator.admit(defaults.set_defaults(P.serde.roundtrip(job)))
        for _sync in range(2):
            c.ctrl._suspend(defaults.set_defaults(P.serde.roundtrip(job)))
        st = c.cs.tpujobs().get("racy").status
        out[name] = (st.preemptions, c.counter("tpujob.suspensions_total"),
                     free(c))
    assert out["port"] == (1, 1.0, 1)
    assert out["reference"] == (0, 2.0, 1)


def test_a_suspension_whose_status_write_failed_still_parks():
    """A suspension whose status write raised (the apiserver unreachable,
    ``Unavailable``) stored nothing, so the retried sync does the whole
    suspension again from the unchanged job: it parks with one eviction.
    Both controllers get the same failed first write and the same retry."""
    out = {}
    for name, P in PACKAGES.items():
        c = Cluster(name, capacity={ACCELERATOR[name]: 1})
        job = c.cs.tpujobs().create(make_job(c, "flaky", suspend=True))
        defaults = importlib.import_module(f"{P.root}.api.defaults")
        assert c.ctrl.allocator.admit(defaults.set_defaults(P.serde.roundtrip(job)))
        failures = [P.store.Unavailable("apiserver unreachable")]

        def fail_once(action, obj, failures=failures):
            if failures:
                raise failures.pop()
            return False, None

        c.cs.prepend_reactor("patch_status", "TPUJob", fail_once)
        with pytest.raises(P.store.Unavailable):
            c.ctrl._suspend(defaults.set_defaults(P.serde.roundtrip(job)))
        stored = c.cs.tpujobs().get("flaky")
        assert stored.status.preemptions == 0
        c.ctrl._suspend(defaults.set_defaults(P.serde.roundtrip(stored)))
        out[name] = (c.status("flaky").preemptions, c.has("flaky", "Suspended"),
                     c.counter("tpujob.suspensions_total"),
                     free(c))
    assert out["port"] == out["reference"] == (1, True, 1.0, 1)
