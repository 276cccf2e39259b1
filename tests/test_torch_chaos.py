"""A replica crash under live traffic, with port replicas.

``TestSingleKill`` of ``tests/test_chaos_serving.py`` on a TPUServe whose
template pins the port's entrypoint: the reference's serve controller,
``LocalKubelet`` and a real ``GatewayServer`` on a socket, three port echo
replicas behind it, and ``tests/chaos.py``'s ``ChaosInjector`` killing one
out from under four client threads. The injector reaches the port replica
through the agent's table (``AgentReplica.chaos_crash``). The contract is
the reference's: zero failed requests (the gateway re-routes the corpse's
in-flight work), the corpse ejected by the health machinery before stale
aging, and the controller replacing it (the port's ``serve`` ends with the
fault, so the pod fails). Then the port's own ``chaos_crash_replica``
kills a replica of the same fleet.
"""

import threading
import time

import pytest

import tfk8s_tpu.runtime.kubelet as kubelet_mod
import tfk8s_tpu.runtime.server as server_mod
import tfk8s_tpu.trainer.serve_controller as sc_mod
from chaos import ChaosInjector
from conftest import wait_for
from test_chaos_serving import Hammer, ready_count
from tfk8s_tpu.api.types import BatchingPolicy, ObjectMeta, PodPhase, TPUServe, TPUServeSpec
from tfk8s_tpu.client import FakeClientset
from tfk8s_tpu.gateway.server import GatewayServer
from tfk8s_tpu.runtime import LocalKubelet
from tfk8s_tpu.utils.logging import Metrics
from tfk8s_tpu_torch.runtime import server as tserver
from tfk8s_tpu_torch.runtime.agent_replica import AgentReplica
import _torch_threads  # noqa: F401  (torch's threads under xdist)

PORT_ENTRY = "tfk8s_tpu_torch.runtime.server:serve"


def make_serve(name, replicas=3):
    serve = TPUServe(
        metadata=ObjectMeta(name=name),
        spec=TPUServeSpec(task="echo", checkpoint="v1", replicas=replicas,
                          batching=BatchingPolicy(max_batch_size=8, batch_timeout_ms=2.0,
                                                  queue_limit=256)),
    )
    serve.spec.template.entrypoint = PORT_ENTRY
    serve.spec.template.env.update({"TFK8S_SERVE_ECHO_DELAY_MS": "2", "TFK8S_DEVICE": "cpu"})
    return serve


@pytest.fixture
def cluster(monkeypatch):
    monkeypatch.setattr(kubelet_mod, "LOG_FLUSH_SECONDS", 0.05)
    monkeypatch.setattr(sc_mod, "AUTOSCALE_PERIOD_S", 0.1)
    # the reference's widened corpse window, on the port's entrypoint: the
    # gateway's ejection must stop traffic before the pod lifecycle does
    monkeypatch.setattr(server_mod, "PROGRESS_PERIOD_S", 1.5)
    monkeypatch.setattr(tserver, "PROGRESS_PERIOD_S", 1.5)
    cs = FakeClientset()
    ctrl = sc_mod.TPUServeController(cs)
    kubelet = LocalKubelet(cs)
    # every terminal phase the kubelet writes: (pod uid, phase, message)
    kubelet.phases = []
    set_phase = kubelet._set_phase

    def record(key, uid, phase, **kw):
        kubelet.phases.append((uid, phase, kw.get("message", "")))
        return set_phase(key, uid, phase, **kw)

    monkeypatch.setattr(kubelet, "_set_phase", record)
    stop = threading.Event()
    kubelet.run(stop)
    assert ctrl.run(workers=2, stop=stop, block=False)
    metrics = Metrics()
    gw = GatewayServer(cs, port=0, metrics=metrics)
    gw.serve_background()
    yield cs, kubelet, gw, metrics
    try:
        # the kubelet's stop ends no pod: delete the serves so their replicas
        # drain, or a port replica stays bound to the reference's node agent
        # (and its tracer) for the rest of the process
        for serve in cs.tpuserves().list()[0]:
            cs.tpuserves().delete(serve.metadata.name)
        assert wait_for(lambda: not kubelet._claimed, timeout=60)
    finally:
        stop.set()
        gw.shutdown()
        gw.server_close()
        ctrl.controller.shutdown()


EJECT_REASONS = ("errors", "deadline", "gray", "probe")


def _counter(metrics, name, serve, reasons, **labels):
    return sum(metrics.get_counter(name, {"serve": serve, "reason": r, **labels}) or 0.0
               for r in reasons)


def _kill_under_traffic(gw, name, kill):
    """Four client threads on ``name`` through the kill (``kill()``
    returns the victim pod); (the hammer, the victim)."""
    with Hammer(gw, name) as hammer:
        time.sleep(0.3)  # traffic established against all 3
        victim = kill()
        assert victim is not None
        time.sleep(1.2)  # traffic flows through the kill and the replacement
    return hammer, victim


def _replaced(cs, injector, name, uid):
    def done():
        uids = {p.metadata.uid for p in injector.running_replicas(name)}
        return uid not in uids and ready_count(cs, name) == 3
    return wait_for(done, timeout=60)


def test_port_replica_crash_costs_zero_failed_requests(cluster):
    cs, kubelet, gw, metrics = cluster
    cs.tpuserves().create(make_serve("tchaos"))
    assert wait_for(lambda: ready_count(cs, "tchaos") == 3, timeout=60)
    injector = ChaosInjector(cs, kubelet, seed=7)
    for pod in injector.running_replicas("tchaos"):
        held = server_mod.lookup_replica(pod.metadata.key)
        assert isinstance(held, AgentReplica) and isinstance(held.server, tserver.ModelServer)

    victims = []

    def kill():
        victim = injector.pick_replica("tchaos")
        assert injector.kill_replica(victim)
        victims.append(tserver.lookup_replica(victim.metadata.key))
        return victim

    hammer, victim = _kill_under_traffic(gw, "tchaos", kill)
    assert hammer.served > 20
    assert hammer.untyped == [], f"untyped failures: {hammer.untyped[:3]}"
    assert hammer.typed == [], f"requests failed during a single crash: {hammer.typed[:3]}"
    assert victims[0].fault is not None
    assert _counter(metrics, "tfk8s_gateway_ejections_total", "default/tchaos",
                    EJECT_REASONS) >= 1.0
    assert _counter(metrics, "tfk8s_gateway_retries_total", "default/tchaos", ("transport",),
                    tenant="default") >= 1.0
    assert _replaced(cs, injector, "tchaos", victim.metadata.uid)
    _assert_failed_with_the_fault(kubelet, victim)


def _assert_failed_with_the_fault(kubelet, victim):
    """The corpse's pod ended Failed, its ``serve()`` raising the fault."""
    ends = [(phase, msg) for uid, phase, msg in kubelet.phases
            if uid == victim.metadata.uid and phase != PodPhase.RUNNING]
    assert len(ends) == 1 and ends[0][0] == PodPhase.FAILED, ends
    assert "replica fault" in ends[0][1] and "chaos" in ends[0][1], ends


def test_the_ports_chaos_crash_replica_kills_a_port_replica(cluster):
    """The same kill through the port alone (``tserver.chaos_crash_replica``
    on the port's own table): zero failed requests, and the replacement."""
    cs, kubelet, gw, metrics = cluster
    cs.tpuserves().create(make_serve("tchaos-port"))
    assert wait_for(lambda: ready_count(cs, "tchaos-port") == 3, timeout=60)
    injector = ChaosInjector(cs, kubelet, seed=11)

    def kill():
        victim = injector.pick_replica("tchaos-port")
        assert tserver.chaos_crash_replica(victim.metadata.key)
        return victim

    hammer, victim = _kill_under_traffic(gw, "tchaos-port", kill)
    assert hammer.served > 20
    assert hammer.untyped == [] and hammer.typed == []
    assert _counter(metrics, "tfk8s_gateway_retries_total", "default/tchaos-port",
                    ("transport",), tenant="default") >= 1.0
    assert _replaced(cs, injector, "tchaos-port", victim.metadata.uid)
    _assert_failed_with_the_fault(kubelet, victim)
