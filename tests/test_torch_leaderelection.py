"""The port's leader election against the reference's, on the CPU.

Each flow runs through both packages' objects and the records are held
equal, uids, resource versions and times masked:

- ``LeaderElector`` over a fake cluster and a fake clock
  (``tests/test_controller_core.py``): one winner among racing candidates;
  a takeover after expiry, the transitions counted; a release letting the
  standby take over at once; an unreachable apiserver raising out of an
  attempt, which in both packages ends an elector's thread;
- a leader-elected ``Server`` reconciling a job (``tests/test_cmd.py``);
- two leader-elected operators over one apiserver with a standalone
  kubelet (``tests/test_leaderelection_e2e.py``): one leads, the standby
  takes over when the leader stops, and drives the next job;
- the hand-over mid-job: the leader stops while a job's pod runs; the
  standby drives that job to ``Succeeded`` with the same restart count and
  conditions in both packages.

The two packages' flows of one test run side by side on threads.
"""

import re
import threading
import time

import pytest

from _torch_control import NAMES, PACKAGES, has, kubeconfig, make_job, run_side_by_side, wire
from conftest import wait_for
import _torch_threads  # noqa: F401  (torch's threads under xdist)

GATES = {name: threading.Event() for name in NAMES}  # releases a plane's le.block pods
CLUSTERS = {}  # plane -> the clientset its jobs are read through


def _echo(name):
    def run(env, stop):
        """Return once the job shows Running, so that both packages record
        that condition (a pod that ends first skips it)."""
        P, job = PACKAGES[name], env["TFK8S_JOB_NAME"]
        wait_for(lambda: has(P, CLUSTERS[name].tpujobs().get(job).status, "Running"), timeout=10)
    return run


def _block(name):
    def run(env, stop):
        GATES[name].wait(30)
    return run


for _name, _P in PACKAGES.items():
    _P.registry.register("torch_le.echo", _echo(_name))
    _P.registry.register("torch_le.block", _block(_name))


# -- the elector over a fake cluster ------------------------------------------------


def _racing(P):
    cs, clk = P.FakeClientset(), [0.0]
    a, b = (P.LeaderElector(cs.generic("Lease"), i, lease_duration_s=10, clock=lambda: clk[0])
            for i in "ab")
    got = [a.try_acquire_or_renew(), b.try_acquire_or_renew()]
    return got, [a.is_leader, b.is_leader], cs


def _expiry(P):
    cs, clk = P.FakeClientset(), [0.0]
    a, b = (P.LeaderElector(cs.generic("Lease"), i, lease_duration_s=10, clock=lambda: clk[0])
            for i in "ab")
    got = [a.try_acquire_or_renew()]
    clk[0] = 5.0
    got.append(b.try_acquire_or_renew())  # still held
    clk[0] = 20.0  # expired
    got.append(b.try_acquire_or_renew())
    got.append(a.try_acquire_or_renew())  # the old holder lost it
    return got, [a.is_leader, b.is_leader], cs


def _release(P):
    cs = P.FakeClientset()
    a, b = (P.LeaderElector(cs.generic("Lease"), i) for i in "ab")
    got = [a.try_acquire_or_renew()]
    a.release()
    got.append(b.try_acquire_or_renew())
    return got, [a.is_leader, b.is_leader], cs


@pytest.mark.parametrize("flow", [_racing, _expiry, _release], ids=lambda f: f.__name__[1:])
def test_the_elector_over_a_fake_cluster_matches_the_reference(flow):
    out = {}
    for name, P in PACKAGES.items():
        got, leading, cs = flow(P)
        lease = cs.generic("Lease").get("tfk8s-tpu-operator")
        out[name] = got, leading, wire(P, lease)
    assert out["port"] == out["reference"]
    got, leading, lease = out["port"]
    want = {_racing: ([True, False], [True, False], "a", 0),
            _expiry: ([True, False, True, False], [False, True], "b", 1),
            _release: ([True, True], [False, True], "b", 1)}[flow]
    assert (got, leading, lease["spec"]["holder"], lease["spec"]["leaseTransitions"]) == want


def test_an_unreachable_apiserver_raises_out_of_an_attempt_in_both_packages():
    """Known behaviour of both packages (ROADMAP queue 3): neither catches
    a transport error, so an outage of the apiserver ends the thread of
    whichever elector tries then."""
    out = {}
    for name, P in PACKAGES.items():
        store = P.remote.RemoteStore("http://127.0.0.1:9", timeout=1.0)
        elector = P.LeaderElector(P.Clientset.new_for_config(store).generic("Lease"), "a")
        with pytest.raises(P.store.Unavailable) as e:
            elector.try_acquire_or_renew()
        out[name] = type(e.value).__name__, elector.is_leader
        elector.release()  # best-effort: swallows the same error
    assert out["port"] == out["reference"] == ("Unavailable", False)


def test_the_default_identity_is_host_pid_and_a_random_suffix():
    shapes = {}
    for name, P in PACKAGES.items():
        a, b = P.Options(), P.Options()
        assert a.identity != b.identity
        shapes[name] = re.sub(r"[0-9a-f]{8}$", "<hex>", a.identity)
    assert shapes["port"] == shapes["reference"]


# -- a leader-elected server ----------------------------------------------------------


def _join(server, timeout=5.0):
    for t in getattr(server, "_threads", []):
        t.join(timeout)


def test_a_leader_elected_server_reconciles():
    def flow(name, P):
        def run():
            server = P.Server(P.Options(leader_elect=True, identity="op", workers=1))
            CLUSTERS[name] = server.clientset
            stop = threading.Event()
            server.run(stop, block=False)
            try:
                server.clientset.tpujobs("default").create(make_job(P, "lejob", "torch_le.echo"))
                assert wait_for(lambda: has(P, server.clientset.tpujobs().get("lejob").status,
                                            "Succeeded"), timeout=20)
                job = server.clientset.tpujobs().get("lejob")
                lease = server.clientset.generic("Lease").get("tfk8s-tpu-operator")
                return (server.elector.is_leader, job.status.gang_restarts,
                        [c.type.value for c in job.status.conditions], wire(P, lease))
            finally:
                stop.set()
                server.shutdown()
                _join(server)
        return run

    out = run_side_by_side({name: flow(name, P) for name, P in PACKAGES.items()})
    assert out["port"] == out["reference"]
    leading, restarts, conds, lease = out["port"]
    assert leading and restarts == 0 and conds[-1] == "Succeeded"
    assert lease["spec"]["holder"] == "op"


# -- two operators over one apiserver ---------------------------------------------


class HA:
    """One package's apiserver, a standalone kubelet and two leader-elected
    operators, op-a started first."""

    def __init__(self, name, tmp_path):
        self.P = P = PACKAGES[name]
        self.api = P.apiserver.APIServer(P.store.ClusterStore(), port=0)
        self.api.serve_background()
        kc = kubeconfig(tmp_path, self.api.url, f"kc-{P.root}.json")
        self.cs = CLUSTERS[name] = P.Clientset.new_for_config(P.remote.RemoteStore(self.api.url))
        self.kubelet_stop = threading.Event()
        self.stops = {i: threading.Event() for i in ("op-a", "op-b")}
        self.ops = {i: P.Server(P.Options(leader_elect=True, identity=i, lease_name="ha-test",
                                          lease_duration_s=8.0, local_kubelet=False,
                                          kubeconfig=kc, workers=1))
                    for i in self.stops}
        self.samples = []  # (op-a leads, op-b leads)

    def __enter__(self):
        kubelet_cs = self.P.Clientset.new_for_config(self.P.remote.RemoteStore(self.api.url))
        self.P.LocalKubelet(kubelet_cs, name="node-0").run(self.kubelet_stop)
        self.ops["op-a"].run(self.stops["op-a"], block=False)
        assert wait_for(lambda: self.leads("op-a"), timeout=10)
        self.ops["op-b"].run(self.stops["op-b"], block=False)
        return self

    def __exit__(self, *exc):
        self.kubelet_stop.set()
        for i, op in self.ops.items():
            self.stops[i].set()
            op.shutdown()
            _join(op)
        self.api.shutdown()
        self.api.server_close()

    def leads(self, ident):
        elector = getattr(self.ops[ident], "elector", None)
        return bool(elector and elector.is_leader)

    def sample(self):
        self.samples.append((self.leads("op-a"), self.leads("op-b")))

    def state(self, name):
        try:
            return self.cs.tpujobs().get(name)
        except self.P.store.NotFound:
            return None

    def wait(self, name, cond, timeout=30):
        def done():
            self.sample()
            job = self.state(name)
            return job is not None and has(self.P, job.status, cond)
        assert wait_for(done, timeout=timeout), (name, cond)

    def hand_over(self):
        """Stop op-a gracefully; the seconds until op-b leads."""
        t0 = time.monotonic()
        self.stops["op-a"].set()
        self.ops["op-a"].shutdown()
        assert wait_for(lambda: self.leads("op-b"), timeout=10), "the standby never took over"
        return time.monotonic() - t0

    def record(self, *names):
        lease = self.cs.generic("Lease").get("ha-test")
        jobs = {n: self.cs.tpujobs().get(n) for n in names}
        return ({n: ([c.type.value for c in j.status.conditions], j.status.gang_restarts)
                 for n, j in jobs.items()}, wire(self.P, lease))


def test_two_operators_one_leader_failover(tmp_path):
    def flow(name, P):
        def run():
            with HA(name, tmp_path) as ha:
                time.sleep(1.0)  # the standby must not grab the live lease
                ha.sample()
                ha.cs.tpujobs().create(make_job(P, "ha-1", "torch_le.echo"))
                ha.wait("ha-1", "Succeeded")
                failover_s = ha.hand_over()
                ha.cs.tpujobs().create(make_job(P, "ha-2", "torch_le.echo"))
                ha.wait("ha-2", "Succeeded")
                return ha.samples, failover_s, ha.record("ha-1", "ha-2")
        return run

    out = run_side_by_side({name: flow(name, P) for name, P in PACKAGES.items()})
    for name in NAMES:
        samples, failover_s, _record = out[name]
        before = samples[:samples.index((False, True))] if (False, True) in samples else samples
        assert before and all(s == (True, False) for s in before), samples
        assert (True, True) not in samples
        assert failover_s < 8.0
    assert out["port"][2] == out["reference"][2]
    jobs, lease = out["port"][2]
    assert all(conds[-1] == "Succeeded" and restarts == 0 for conds, restarts in jobs.values())
    assert (lease["spec"]["holder"], lease["spec"]["leaseTransitions"]) == ("op-b", 1)


def test_a_hand_over_mid_job_keeps_the_gang(tmp_path):
    def flow(P, name):
        def run():
            with HA(name, tmp_path) as ha:
                ha.cs.tpujobs().create(make_job(P, "mid", "torch_le.block"))
                ha.wait("mid", "Running")
                pods = ha.cs.pods().list(label_selector={ha.P.labels.JOB_NAME: "mid"})[0]
                assert [p.status.phase.value for p in pods] == ["Running"]
                failover_s = ha.hand_over()
                job = ha.state("mid")
                assert has(P, job.status, "Running"), "the job ended before the hand-over"
                GATES[name].set()
                ha.wait("mid", "Succeeded")
                pods_after = ha.cs.pods().list(label_selector={ha.P.labels.JOB_NAME: "mid"})[0]
                return (failover_s, [p.metadata.name for p in pods],
                        [p.metadata.name for p in pods_after], ha.record("mid"))
        return run

    for gate in GATES.values():
        gate.clear()
    try:
        out = run_side_by_side({name: flow(P, name) for name, P in PACKAGES.items()})
    finally:
        for gate in GATES.values():
            gate.set()
    assert out["port"][1:] == out["reference"][1:]
    failover_s, pods, pods_after, (jobs, lease) = out["port"]
    assert failover_s < 8.0 and pods == pods_after == ["mid-worker-0"]
    conds, restarts = jobs["mid"]
    assert restarts == 0 and conds[-1] == "Succeeded" and "Restarting" not in conds
    assert (lease["spec"]["holder"], lease["spec"]["leaseTransitions"]) == ("op-b", 1)
