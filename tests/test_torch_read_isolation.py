"""Read isolation of the port's copy-on-write control plane against the
reference's, on the CPU.

Each flow of ``tests/test_read_isolation.py`` runs through both packages'
``ClusterStore``, typed client, ``SharedIndexInformer``, ``Lister`` and
``Indexer``, one test a flow with a reference case and a port case
(``_torch_control.held``). The store and the informer share ONE frozen
instance of each object among their readers: a mutation of a shared read
raises the package's own ``FrozenObjectError`` and reaches neither the
cache nor the store; ``thaw`` and the write verbs give private mutable
copies; objects restored from the journal, delivered to handlers or fed
to the indexer from a remote list are frozen. Held equal: which mutations
raise and the class they raise (by name, each the case's own package's),
whether reads share an instance, and the values read back after.
"""

import importlib
import threading

import pytest

from _torch_control import NAMES, PACKAGES, held, raised


def _m(P, name):
    return importlib.import_module(f"{P.root}.{name}")


def _job(P, name="iso", labels=None):
    t = P.t
    return t.TPUJob(
        metadata=t.ObjectMeta(name=name, namespace="default", labels=dict(labels or {})),
        spec=t.TPUJobSpec(replica_specs={t.ReplicaType.WORKER: t.ReplicaSpec(
            replicas=1, template=t.ContainerSpec(entrypoint="e"))}),
    )


def _setattr(obj, attr, value):
    return lambda: setattr(obj, attr, value)


def _setitem(mapping, key, value):
    return lambda: mapping.__setitem__(key, value)


FROZEN = "tfk8s_tpu.api.frozen.FrozenObjectError"


def _worker(P, job):
    return job.spec.replica_specs[P.t.ReplicaType.WORKER]


# -- the store (frozen path) -------------------------------------------------


def _shared_get(P):
    s = P.store.ClusterStore()
    s.create(_job(P))
    a, b = s.get("TPUJob", "default", "iso"), s.get("TPUJob", "default", "iso")
    return {"same": a is b, "frozen": _m(P, "api.frozen").is_frozen(a)}


@pytest.mark.parametrize("name", NAMES)
def test_store_get_returns_shared_frozen_instance(name):
    # a zero-copy shared read
    assert held(_shared_get, name) == {"same": True, "frozen": True}


def _frozen_get(P):
    s = P.store.ClusterStore()
    s.create(_job(P, labels={"team": "x"}))
    got = s.get("TPUJob", "default", "iso")
    writes = [raised(P, w) for w in (
        _setattr(got.metadata, "name", "evil"),
        _setitem(got.metadata.labels, "team", "evil"),
        lambda: got.metadata.finalizers.append("evil"),
        lambda: got.status.conditions.append(object()),
        _setattr(_worker(P, got), "replicas", 99))]
    fresh = s.get("TPUJob", "default", "iso")
    return {"writes": writes, "name": fresh.metadata.name, "labels": dict(fresh.metadata.labels),
            "finalizers": list(fresh.metadata.finalizers), "replicas": _worker(P, fresh).replicas}


@pytest.mark.parametrize("name", NAMES)
def test_frozen_get_mutation_raises_and_store_unaffected(name):
    assert held(_frozen_get, name) == {"writes": [FROZEN] * 5, "name": "iso",
                                       "labels": {"team": "x"}, "finalizers": [], "replicas": 1}


def _list_filters(P):
    s = P.store.ClusterStore()
    s.create(_job(P, "a", labels={"pick": "1"}))
    s.create(_job(P, "b"))
    items, _rv = s.list("TPUJob", "default", {"pick": "1"})
    return {"names": [o.metadata.name for o in items],
            "shared": items[0] is s.get("TPUJob", "default", "a"),
            "write": raised(P, _setitem(items[0].metadata.labels, "pick", "2"))}


@pytest.mark.parametrize("name", NAMES)
def test_list_filters_before_any_copy_and_shares_instances(name):
    assert held(_list_filters, name) == {"names": ["a"], "shared": True, "write": FROZEN}


def _watch_event(P):
    s = P.store.ClusterStore()
    w = s.watch("TPUJob")
    s.create(_job(P))
    ev = w.next(timeout=1)
    rec = {"frozen": _m(P, "api.frozen").is_frozen(ev.object),
           "writes": [raised(P, _setattr(ev.object.status, "gang_restarts", 99)),
                      raised(P, _setitem(ev.object.metadata.labels, "x", "y"))],
           "stored": s.get("TPUJob", "default", "iso").status.gang_restarts}
    s.stop_watch(w)
    return rec


@pytest.mark.parametrize("name", NAMES)
def test_watch_event_mutation_raises_and_store_unaffected(name):
    assert held(_watch_event, name) == {"frozen": True, "writes": [FROZEN] * 2, "stored": 0}


def _shared_fanout(P):
    s = P.store.ClusterStore()
    w1, w2 = s.watch("TPUJob"), s.watch("TPUJob")
    s.create(_job(P))
    same = w1.next(timeout=1).object is w2.next(timeout=1).object
    s.stop_watch(w1)
    s.stop_watch(w2)
    return same


@pytest.mark.parametrize("name", NAMES)
def test_watchers_share_one_frozen_event_object(name):
    # a shared fan-out, no copy a watcher
    assert held(_shared_fanout, name) is True


def _thaw(P):
    s = P.store.ClusterStore()
    s.create(_job(P, labels={"a": "1"}))
    mine = _m(P, "api.frozen").thaw(s.get("TPUJob", "default", "iso"))
    mine.metadata.labels["a"] = "2"
    mine.status.gang_restarts = 7
    cur = s.get("TPUJob", "default", "iso")
    return {"mine": (dict(mine.metadata.labels), mine.status.gang_restarts),
            "stored": (dict(cur.metadata.labels), cur.status.gang_restarts)}


@pytest.mark.parametrize("name", NAMES)
def test_thaw_gives_independent_mutable_copy(name):
    assert held(_thaw, name) == {"mine": ({"a": "2"}, 7), "stored": ({"a": "1"}, 0)}


def _write_verbs(P):
    s = P.store.ClusterStore()
    created = s.create(_job(P))
    created.metadata.labels["w"] = "1"  # must not raise
    _worker(P, created).replicas = 2
    updated = s.update(created)
    updated.status.gang_restarts = 3  # must not raise
    cur = s.get("TPUJob", "default", "iso")
    return {"gang_restarts": cur.status.gang_restarts, "replicas": _worker(P, cur).replicas,
            "labels": dict(cur.metadata.labels)}


@pytest.mark.parametrize("name", NAMES)
def test_write_verbs_return_private_mutable_copies(name):
    assert held(_write_verbs, name) == {"gang_restarts": 0, "replicas": 2, "labels": {"w": "1"}}


def _journal(P, tmp_path):
    d = str(tmp_path / P.root / "j")
    s = P.store.ClusterStore(journal_dir=d, fsync=False)
    s.create(_job(P))
    s.close()
    got = P.store.ClusterStore(journal_dir=d, fsync=False).get("TPUJob", "default", "iso")
    return {"frozen": _m(P, "api.frozen").is_frozen(got),
            "write": raised(P, _setattr(got.metadata, "name", "evil"))}


@pytest.mark.parametrize("name", NAMES)
def test_journal_restored_objects_are_frozen(name, tmp_path):
    assert held(_journal, name, tmp_path) == {"frozen": True, "write": FROZEN}


# -- the typed client's boundary (the mutable path) --------------------------


def _typed_get(P):
    """``TypedClient.get`` thaws, so a read-modify-write client (the
    kubelet) mutates its own copy and the store is unaffected."""
    cs = P.FakeClientset()
    cs.tpujobs().create(_job(P))
    mine = cs.tpujobs().get("iso")
    writes = [raised(P, _setattr(mine.status, "gang_restarts", 9)),
              raised(P, _setitem(mine.metadata.labels, "x", "y"))]
    cur = cs.store.get("TPUJob", "default", "iso")
    return {"writes": writes, "stored": (cur.status.gang_restarts, dict(cur.metadata.labels))}


@pytest.mark.parametrize("name", NAMES)
def test_typed_client_get_is_copy_on_read(name):
    assert held(_typed_get, name) == {"writes": [None, None], "stored": (0, {})}


def _typed_list(P):
    cs = P.FakeClientset()
    cs.tpujobs().create(_job(P))
    items, _ = cs.tpujobs().list()
    return {"frozen": _m(P, "api.frozen").is_frozen(items[0]),
            "write": raised(P, _setitem(items[0].metadata.labels, "x", "y"))}


@pytest.mark.parametrize("name", NAMES)
def test_typed_client_list_shares_frozen_instances(name):
    assert held(_typed_list, name) == {"frozen": True, "write": FROZEN}


# -- the informer's cache and listers ----------------------------------------


def _synced_informer(P, cs):
    client = _m(P, "client")
    inf = client.SharedIndexInformer(cs.tpujobs(namespace=None), name="iso")
    stop = threading.Event()
    inf.run(stop)
    assert client.wait_for_cache_sync(stop, inf, timeout=5)
    return inf, stop


def _lister(P):
    cs = P.FakeClientset()
    cs.tpujobs().create(_job(P, labels={"keep": "1"}))
    inf, stop = _synced_informer(P, cs)
    try:
        lister = _m(P, "client.listers").Lister(inf.indexer, "TPUJob")
        got = lister.get("default", "iso")
        return {"frozen": _m(P, "api.frozen").is_frozen(got),
                "writes": [raised(P, _setitem(got.metadata.labels, "keep", "evil")),
                           raised(P, _setattr(got.status, "gang_restarts", 5))],
                "cached": dict(lister.get("default", "iso").metadata.labels),
                "stored": dict(cs.store.get("TPUJob", "default", "iso").metadata.labels),
                # zero-copy: repeated cache reads share the instance
                "shared": lister.get("default", "iso") is lister.get("default", "iso")}
    finally:
        stop.set()
        inf.join(2)


@pytest.mark.parametrize("name", NAMES)
def test_lister_results_cannot_alias_corrupt_the_cache_or_store(name):
    assert held(_lister, name) == {"frozen": True, "writes": [FROZEN] * 2,
                                   "cached": {"keep": "1"}, "stored": {"keep": "1"},
                                   "shared": True}


def _handler(P):
    client = _m(P, "client")
    cs = P.FakeClientset()
    inf, stop = _synced_informer(P, cs)
    try:
        seen = []
        inf.add_event_handler(client.ResourceEventHandler(on_add=seen.append))
        cs.tpujobs().create(_job(P, "live"))
        pause = threading.Event()
        for _ in range(500):
            if seen:
                break
            pause.wait(0.01)
        return {"seen": len(seen), "frozen": _m(P, "api.frozen").is_frozen(seen[0]),
                "write": raised(P, _setitem(seen[0].metadata.labels, "x", "y")),
                "stored": dict(cs.store.get("TPUJob", "default", "live").metadata.labels)}
    finally:
        stop.set()
        inf.join(2)


@pytest.mark.parametrize("name", NAMES)
def test_handler_delivered_objects_are_frozen(name):
    assert held(_handler, name) == {"seen": 1, "frozen": True, "write": FROZEN, "stored": {}}


def _indexer(P):
    """An object fed from a remote (unfrozen) list or watch is frozen once,
    at cache admission."""
    frozen = _m(P, "api.frozen")
    idx = _m(P, "client").Indexer()
    mutable = P.serde.roundtrip(_job(P))  # a fresh, unfrozen decode
    before = frozen.is_frozen(mutable)
    idx.add(mutable)
    cached = idx.get_by_key("default/iso")
    return {"before": before, "cached": frozen.is_frozen(cached),
            "write": raised(P, _setattr(cached.metadata, "name", "evil"))}


@pytest.mark.parametrize("name", NAMES)
def test_indexer_freezes_old_style_mutable_objects_on_admission(name):
    assert held(_indexer, name) == {"before": False, "cached": True, "write": FROZEN}


@pytest.mark.parametrize("name", NAMES)
def test_frozen_object_error_is_each_packages_own(name):
    """A port object's frozen read raises the port's ``FrozenObjectError``,
    not the reference's: an ``except`` of one package's class does not
    catch the other's."""
    P = PACKAGES[name]
    other = PACKAGES["port" if name == "reference" else "reference"]
    s = P.store.ClusterStore()
    s.create(_job(P))
    got = s.get("TPUJob", "default", "iso")
    with pytest.raises(_m(P, "api.frozen").FrozenObjectError) as info:
        got.metadata.name = "evil"
    assert not isinstance(info.value, _m(other, "api.frozen").FrozenObjectError)
