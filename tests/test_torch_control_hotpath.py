"""The control plane's hot path on the port against the reference's, on the
CPU.

Each flow of ``tests/test_control_plane_hotpath.py`` runs through both
packages' objects, one test a flow with a reference case and a port case
(``_torch_control.held``): bounded watch queues with slow-watcher
coalescing (``tfk8s_watch_coalesced_total``), the informer's batched
per-key delta coalescing, ``TokenBucketRateLimiter.accept_n``'s one
batched wait, gang pod creation under one limiter acquire
(``create_many``), the controller's status deep-compare write skip
(``tfk8s_status_patches_skipped_total``) and the kubelet's stop-aware
status-retry wait. Held equal: return values, event types and order,
backlog sizes, ``FakeClientset`` action lists, counters and their labels,
limiter sleeps. The outage flow's elapsed time is bounded in each package
(under 1 s), not held equal.
"""

import importlib
import threading
import time

import pytest

from _torch_control import NAMES, PACKAGES, held


def _m(P, name):
    return importlib.import_module(f"{P.root}.{name}")


def _job(P, name="j"):
    t = P.t
    return t.TPUJob(
        metadata=t.ObjectMeta(name=name, namespace="default"),
        spec=t.TPUJobSpec(
            replica_specs={t.ReplicaType.WORKER: t.ReplicaSpec(
                replicas=2, template=t.ContainerSpec(entrypoint="e"))},
            tpu=t.TPUSpec(accelerator="cpu-1"),
        ),
    )


def _types(events):
    return [(ev.type.value, ev.object.metadata.name, ev.object.metadata.uid) for ev in events]


# -- watch queue: bound and coalescing ---------------------------------------


def _slow_watcher(P):
    s = P.store.ClusterStore()
    s.create(_job(P, "fan"))
    w = s.watch("TPUJob", queue_limit=4)
    cur = _m(P, "api.frozen").thaw(s.get("TPUJob", "default", "fan"))
    for _ in range(100):
        cur.status.gang_restarts += 1
        cur = s.update_status(cur)
    backlog = len(w._items)
    events = []
    while True:
        ev = w.next(timeout=0.05)
        if ev is None:
            break
        events.append(ev)
    s.stop_watch(w)
    return {"backlog": backlog, "coalesced": w.coalesced_total,
            "delivered": [ev.type.value for ev in events],
            "last_gang_restarts": events[-1].object.status.gang_restarts}


@pytest.mark.parametrize("name", NAMES)
def test_slow_watcher_backlog_bounded_and_converges(name):
    rec = held(_slow_watcher, name)
    # same-key events merged, the latest state wins
    assert rec["backlog"] <= 4 and rec["coalesced"] >= 96
    assert rec["last_gang_restarts"] == 100


def _fast_watcher(P):
    s = P.store.ClusterStore()
    w = s.watch("TPUJob")  # the default (large) bound
    s.create(_job(P, "a"))
    s.create(_job(P, "b"))
    got = [w.next(timeout=1) for _ in range(2)]
    s.stop_watch(w)
    return {"names": [ev.object.metadata.name for ev in got], "coalesced": w.coalesced_total}


@pytest.mark.parametrize("name", NAMES)
def test_fast_watcher_under_bound_never_coalesces(name):
    assert held(_fast_watcher, name) == {"names": ["a", "b"], "coalesced": 0}


def _merge_rules(P):
    E = _m(P, "client").EventType
    c = P.store._coalesce_type
    return [c(a, b).value for a, b in ((E.ADDED, E.MODIFIED), (E.MODIFIED, E.MODIFIED),
                                       (E.ADDED, E.DELETED), (E.MODIFIED, E.DELETED))]


@pytest.mark.parametrize("name", NAMES)
def test_coalesce_type_merge_rules(name):
    E = _m(PACKAGES[name], "client").EventType
    # an unseen add absorbs updates; a delete always wins
    assert held(_merge_rules, name) == [E.ADDED.value, E.MODIFIED.value, E.DELETED.value,
                                        E.DELETED.value]


def _delete_barrier(P):
    """A backlogged watcher still sees a delete and a re-create as TWO
    events (the kubelet stops the old pod's runner on the delete); a later
    update does coalesce into the pending re-ADD."""
    st, E = P.store, _m(P, "client").EventType
    w = st.Watch(queue_limit=1)
    w._push(st.WatchEvent(E.DELETED, _job(P, "x")))
    recreated = _job(P, "x")
    recreated.metadata.uid = "fresh"
    merged_recreate = w._push(st.WatchEvent(E.ADDED, recreated))
    first, second = w.next(timeout=0.1), w.next(timeout=0.1)
    w._push(st.WatchEvent(E.DELETED, _job(P, "y")))
    w._push(st.WatchEvent(E.ADDED, _job(P, "y")))
    merged_update = w._push(st.WatchEvent(E.MODIFIED, _job(P, "y")))
    return {"merged_recreate": merged_recreate, "events": _types([first, second]),
            "merged_update": merged_update}


@pytest.mark.parametrize("name", NAMES)
def test_pending_delete_is_a_coalescing_barrier(name):
    E = _m(PACKAGES[name], "client").EventType
    assert held(_delete_barrier, name) == {
        "merged_recreate": False,
        "events": [(E.DELETED.value, "x", ""), (E.ADDED.value, "x", "fresh")],
        "merged_update": True}


def _store_metric(P):
    m = _m(P, "utils.logging").Metrics()
    s = P.store.ClusterStore(metrics=m)
    s.create(_job(P, "fan"))
    w = s.watch("TPUJob", queue_limit=2)
    cur = _m(P, "api.frozen").thaw(s.get("TPUJob", "default", "fan"))
    for _ in range(10):
        cur.status.gang_restarts += 1
        cur = s.update_status(cur)
    s.stop_watch(w)
    return {"counter": m.get_counter("tfk8s_watch_coalesced_total", {"kind": "TPUJob"}),
            "exposed": [line for line in m.prometheus_text().splitlines()
                        if line.startswith("tfk8s_watch_coalesced_total")]}


@pytest.mark.parametrize("name", NAMES)
def test_coalesced_events_export_store_metric(name):
    rec = held(_store_metric, name)
    assert rec["counter"] >= 8
    assert rec["exposed"] == [f'tfk8s_watch_coalesced_total{{kind="TPUJob"}} {rec["counter"]}']


def _next_batch(P):
    st, E = P.store, _m(P, "client").EventType
    w = st.Watch()
    for i in range(5):
        w._push(st.WatchEvent(E.MODIFIED, _job(P, f"j{i}")))
    first = w.next_batch(max_items=3, timeout=0.1)
    rest = w.next_batch(max_items=10, timeout=0.1)
    return [[ev.object.metadata.name for ev in first], [ev.object.metadata.name for ev in rest],
            w.next_batch(max_items=10, timeout=0.02)]


@pytest.mark.parametrize("name", NAMES)
def test_next_batch_drains_a_burst(name):
    assert held(_next_batch, name) == [["j0", "j1", "j2"], ["j3", "j4"], []]


# -- informer: per-key delta coalescing --------------------------------------


def _informer(P, metrics=None):
    client = _m(P, "client")
    cs = P.FakeClientset()
    kw = {} if metrics is None else {"metrics": metrics}
    inf = client.SharedIndexInformer(cs.tpujobs(namespace=None), name="t", **kw)
    calls = []
    inf.add_event_handler(client.ResourceEventHandler(
        on_add=lambda o: calls.append(("add", o.metadata.name, o.metadata.uid)),
        on_update=lambda o, n: calls.append(("upd", n.metadata.name, n.metadata.uid)),
        on_delete=lambda o: calls.append(("del", o.metadata.name, o.metadata.uid)),
    ))
    return inf, calls


def _same_key(P):
    st, E = P.store, _m(P, "client").EventType
    m = _m(P, "utils.logging").Metrics()
    inf, calls = _informer(P, m)
    j1, j2, j3 = _job(P, "x"), _job(P, "x"), _job(P, "x")
    j1.status.gang_restarts, j2.status.gang_restarts, j3.status.gang_restarts = 1, 2, 3
    inf._handle_batch([st.WatchEvent(E.ADDED, j1), st.WatchEvent(E.MODIFIED, j2),
                       st.WatchEvent(E.ADDED, _job(P, "y")), st.WatchEvent(E.MODIFIED, j3)])
    return {"calls": calls,
            "cached": inf.indexer.get_by_key("default/x").status.gang_restarts,
            "coalesced": m.get_counter("informer.coalesced_deltas_total", {"informer": "t"})}


@pytest.mark.parametrize("name", NAMES)
def test_informer_batch_coalesces_same_key_updates(name):
    """Three events of default/x in one batch are ONE dispatch (an add: the
    cache never saw x) carrying the last state."""
    assert held(_same_key, name) == {
        "calls": [("add", "y", ""), ("add", "x", "")], "cached": 3, "coalesced": 2.0}


def _delete_wins(P):
    st, E = P.store, _m(P, "client").EventType
    inf, calls = _informer(P)
    inf._handle_batch([st.WatchEvent(E.ADDED, _job(P, "x")),
                       st.WatchEvent(E.DELETED, _job(P, "x"))])
    return {"calls": calls, "cached": inf.indexer.get_by_key("default/x")}


@pytest.mark.parametrize("name", NAMES)
def test_informer_batch_delete_wins(name):
    assert held(_delete_wins, name)["cached"] is None


def _recreate(P):
    st, E = P.store, _m(P, "client").EventType
    inf, calls = _informer(P)
    old, new, newer = _job(P, "x"), _job(P, "x"), _job(P, "x")
    old.metadata.uid, new.metadata.uid, newer.metadata.uid = "old", "new", "new"
    newer.status.gang_restarts = 1
    inf._handle_batch([st.WatchEvent(E.ADDED, old), st.WatchEvent(E.DELETED, old),
                       st.WatchEvent(E.ADDED, new), st.WatchEvent(E.MODIFIED, newer)])
    return {"calls": calls,
            "cached": inf.indexer.get_by_key("default/x").status.gang_restarts}


@pytest.mark.parametrize("name", NAMES)
def test_informer_batch_never_drops_delete_of_a_recreate(name):
    """A delete and a re-create in one drained batch dispatch BOTH (the
    kubelet's on_delete stops the old pod's runner); the add and modify
    after the delete coalesce into one dispatch with the final state."""
    rec = held(_recreate, name)
    assert ("del", "x", "old") in rec["calls"]
    assert rec["calls"][-1] == ("add", "x", "new") and rec["cached"] == 1


# -- rate limiter: one batched acquire ---------------------------------------


def _accept_n(P):
    t, sleeps = [0.0], []

    def sleep(d):
        sleeps.append(d)
        t[0] += d

    rl = _m(P, "client.ratelimit").TokenBucketRateLimiter(
        qps=10, burst=2, clock=lambda: t[0], sleep=sleep)
    rl.accept(5)  # 2 banked + 3 owed: ONE 0.3 s sleep
    after_burst = list(sleeps)
    rl.accept()  # the debt queues later callers at the overall rate
    return {"sleeps": [round(s, 9) for s in after_burst], "clock": round(t[0], 9)}


@pytest.mark.parametrize("name", NAMES)
def test_accept_n_is_one_batched_wait(name):
    assert held(_accept_n, name) == {"sleeps": [0.3], "clock": 0.4}


def _create_many(P):
    calls = []

    class RecordingLimiter:
        def accept(self, n=1):
            calls.append(n)

    store = P.store.ClusterStore()
    c = _m(P, "client.clientset").TypedClient(store, "TPUJob", "default", RecordingLimiter())
    c.create(_job(P, "pre"))
    created = c.create_many([_job(P, "pre"), _job(P, "a"), _job(P, "b")])
    return {"acquires": calls, "created": [o.metadata.name for o in created],
            "stored": sorted(o.metadata.name for o in store.list("TPUJob")[0])}


@pytest.mark.parametrize("name", NAMES)
def test_create_many_single_acquire_and_already_exists_skip(name):
    """One batched acquire for the gang; the existing object is skipped."""
    assert held(_create_many, name) == {
        "acquires": [1, 3], "created": ["a", "b"], "stored": ["a", "b", "pre"]}


def _fake_create_many(P):
    cs = P.FakeClientset()
    cs.pods().create_many([P.t.Pod(metadata=P.t.ObjectMeta(name=f"p{i}")) for i in range(3)])
    return [(a.verb, a.kind, a.name) for a in cs.actions(kind="Pod")]


@pytest.mark.parametrize("name", NAMES)
def test_fake_create_many_records_per_object_actions(name):
    assert [v for v, _, _ in held(_fake_create_many, name)] == ["create"] * 3


# -- controller: status deep-compare skip ------------------------------------


def _write_status(P):
    cs = P.FakeClientset()
    ctrl = _m(P, "trainer.tpujob_controller").TPUJobController(cs)
    created = cs.tpujobs().create(_job(P, "skipme"))
    j = P.serde.roundtrip(created)
    j._status_baseline = P.serde.to_wire(created.status)
    cs.clear_actions()
    skipped = lambda: ctrl.metrics.get_counter("tfk8s_status_patches_skipped_total")  # noqa: E731
    rec = {"unchanged": ctrl._write_status(j), "patches": len(cs.actions(verb="patch_status")),
           "skipped": skipped()}
    # a real change writes, and refreshes the baseline for the next call
    j.status.gang_restarts = 2
    rec["changed"] = ctrl._write_status(j)
    rec["patches_after_change"] = len(cs.actions(verb="patch_status"))
    rec["again"] = ctrl._write_status(j)
    rec["patches_after_again"] = len(cs.actions(verb="patch_status"))
    rec["skipped_after"] = skipped()
    return rec


@pytest.mark.parametrize("name", NAMES)
def test_write_status_skips_unchanged_and_counts(name):
    assert held(_write_status, name) == {
        "unchanged": True, "patches": 0, "skipped": 1.0, "changed": True,
        "patches_after_change": 1, "again": True, "patches_after_again": 1,
        "skipped_after": 2.0}


# -- kubelet: stop-aware status-retry wait -----------------------------------


def _outage(P):
    cs = P.FakeClientset()

    def outage(action, obj):
        raise P.store.Unavailable("injected outage")

    cs.prepend_reactor("get", "Pod", outage)
    kubelet = P.LocalKubelet(cs)
    stop = threading.Event()
    kubelet._stop = stop
    result = {}

    def write():
        result["ok"] = kubelet._set_phase("default/p", "uid", P.t.PodPhase.RUNNING)

    t = threading.Thread(target=write, daemon=True)
    t0 = time.monotonic()
    t.start()
    time.sleep(0.15)  # inside the 1.0 s retry wait
    stop.set()
    t.join(timeout=2.0)
    elapsed = time.monotonic() - t0
    # the stop interrupted the wait instead of riding out the full second
    assert not t.is_alive() and elapsed < 1.0, elapsed
    return {"ok": result["ok"], "gets": [a.verb for a in cs.actions(kind="Pod")][:1]}


@pytest.mark.parametrize("name", NAMES)
def test_kubelet_outage_retry_stops_promptly(name):
    assert held(_outage, name) == {"ok": False, "gets": ["get"]}
