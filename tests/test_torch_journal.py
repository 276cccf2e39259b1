"""The port's durable store against the reference's, on the CPU.

Every flow of ``tests/test_journal.py`` but the cross-process kill -9 runs
once through each package's ``ClusterStore``: the same writes, the same
assertions. Two more cases hold the journal format itself: a journal
directory written by one package replays in the other's store to the
same objects in wire form and the same resource_version.
"""

import json
import os
import threading
import types

import pytest

from tfk8s_tpu.api import frozen as rfrozen
from tfk8s_tpu.api import serde as rserde
from tfk8s_tpu.api import types as rtypes
from tfk8s_tpu.client import store as rstore
from tfk8s_tpu_torch.api import frozen as tfrozen
from tfk8s_tpu_torch.api import serde as tserde
from tfk8s_tpu_torch.api import types as ttypes
from tfk8s_tpu_torch.client import store as tstore
import _torch_threads  # noqa: F401  (torch's threads under xdist)

PACKAGES = {
    "reference": types.SimpleNamespace(t=rtypes, s=rstore, thaw=rfrozen.thaw, serde=rserde),
    "port": types.SimpleNamespace(t=ttypes, s=tstore, thaw=tfrozen.thaw, serde=tserde),
}


@pytest.fixture(params=sorted(PACKAGES))
def P(request):
    return PACKAGES[request.param]


def make_job(P, name, finalizers=()):
    t = P.t
    return t.TPUJob(
        metadata=t.ObjectMeta(name=name, namespace="default", finalizers=list(finalizers)),
        spec=t.TPUJobSpec(
            replica_specs={t.ReplicaType.WORKER: t.ReplicaSpec(
                replicas=2, template=t.ContainerSpec(entrypoint="m:f"))},
            tpu=t.TPUSpec(accelerator="cpu-1"),
            run_policy=t.RunPolicy(scheduling=t.SchedulingPolicy(gang=True)),
        ),
    )


def make_pod(P, name):
    return P.t.Pod(metadata=P.t.ObjectMeta(name=name, namespace="default"))


def store(P, d, **kw):
    return P.s.ClusterStore(journal_dir=d, fsync=False, **kw)


# -- round trip --------------------------------------------------------------------


def test_state_and_rv_survive_reopen(P, tmp_path):
    d = str(tmp_path / "j")
    s = store(P, d)
    created = s.create(make_job(P, "a"))
    b = s.create(make_job(P, "b"))
    b.spec.replica_specs[P.t.ReplicaType.WORKER].replicas = 4
    s.update(b)
    s.create(make_job(P, "victim"))
    s.delete("TPUJob", "default", "victim")
    last_rv = s.resource_version
    s.close()

    r = store(P, d)
    assert r.resource_version == last_rv
    items, rv = r.list("TPUJob")
    assert rv == last_rv
    assert sorted(o.metadata.name for o in items) == ["a", "b"]
    assert r.get("TPUJob", "default", "b").spec.replica_specs[
        P.t.ReplicaType.WORKER].replicas == 4
    got_a = r.get("TPUJob", "default", "a")
    assert got_a.metadata.uid == created.metadata.uid
    assert got_a.metadata.creation_timestamp == created.metadata.creation_timestamp
    assert r.create(make_job(P, "c")).metadata.resource_version == last_rv + 1


def test_status_subresource_and_finalizer_gate_replay(P, tmp_path):
    d = str(tmp_path / "j")
    s = store(P, d)
    s.create(make_job(P, "gated", finalizers=["tfk8s.dev/teardown"]))
    s.delete("TPUJob", "default", "gated")  # only marks deletion
    s.close()

    r = store(P, d)
    got = P.thaw(r.get("TPUJob", "default", "gated"))
    assert got.metadata.deletion_timestamp is not None
    assert got.metadata.finalizers == ["tfk8s.dev/teardown"]
    got.metadata.finalizers = []
    r.update(got)
    assert r.list("TPUJob")[0] == []


def test_watch_events_replay_from_wal(P, tmp_path):
    d = str(tmp_path / "j")
    s = store(P, d)
    s.create(make_job(P, "early"))
    rv_bookmark = s.resource_version
    s.create(make_job(P, "late"))
    s.close()

    w = store(P, d).watch("TPUJob", since_rv=rv_bookmark)
    ev = w.next(timeout=1)
    assert ev is not None and ev.type == P.s.EventType.ADDED
    assert ev.object.metadata.name == "late"


def test_leases_survive(P, tmp_path):
    d = str(tmp_path / "j")
    s = store(P, d)
    s.create(P.t.Lease(
        metadata=P.t.ObjectMeta(name="node-n0", namespace="default"),
        spec=P.t.LeaseSpec(holder="n0", lease_duration_s=20.0, renew_time=123.0)))
    s.close()
    lease = store(P, d).get("Lease", "default", "node-n0")
    assert (lease.spec.holder, lease.spec.renew_time) == ("n0", 123.0)


# -- per-kind segments -------------------------------------------------------------


def test_writes_land_in_per_kind_segments(P, tmp_path):
    d = str(tmp_path / "j")
    s = store(P, d)
    s.create(make_job(P, "a"))
    s.create(make_pod(P, "p0"))
    s.close()
    assert os.path.exists(os.path.join(d, "wal-TPUJob.jsonl"))
    assert os.path.exists(os.path.join(d, "wal-Pod.jsonl"))
    assert not os.path.exists(os.path.join(d, "wal.jsonl"))
    with open(os.path.join(d, "wal-TPUJob.jsonl")) as f:
        assert {json.loads(line)["obj"]["kind"] for line in f} == {"TPUJob"}


def test_restore_merges_segments_by_rv(P, tmp_path):
    d = str(tmp_path / "j")
    s = store(P, d)
    s.create(make_job(P, "j1"))
    pod = s.create(make_pod(P, "p1"))
    bookmark = s.resource_version
    j = P.thaw(s.get("TPUJob", "default", "j1"))
    j.spec.replica_specs[P.t.ReplicaType.WORKER].replicas = 8
    s.update(j)
    s.delete("Pod", "default", "p1")
    last_rv = s.resource_version
    s.close()

    r = store(P, d)
    assert r.resource_version == last_rv
    assert r.get("TPUJob", "default", "j1").spec.replica_specs[
        P.t.ReplicaType.WORKER].replicas == 8
    assert r.list("Pod")[0] == []
    ev = r.watch("Pod", since_rv=bookmark).next(timeout=1)
    assert ev is not None and ev.type == P.s.EventType.DELETED
    assert ev.object.metadata.uid == pod.metadata.uid


def test_legacy_single_stream_wal_still_replays(P, tmp_path):
    d = str(tmp_path / "j")
    os.makedirs(d)
    legacy = os.path.join(d, "wal.jsonl")
    s = store(P, d)
    s.create(make_job(P, "old-style"))
    s.close()
    os.replace(os.path.join(d, "wal-TPUJob.jsonl"), legacy)

    r = store(P, d, compact_every=2)
    assert r.get("TPUJob", "default", "old-style").metadata.name == "old-style"
    r.create(make_job(P, "x1"))
    r.create(make_job(P, "x2"))  # crosses compact_every -> compaction
    r.close()
    assert not os.path.exists(legacy), "compaction must retire the legacy WAL"
    assert len(store(P, d).list("TPUJob")[0]) == 3


# -- compaction --------------------------------------------------------------------


def test_snapshot_written_and_wal_truncated(P, tmp_path):
    d = str(tmp_path / "j")
    s = store(P, d, compact_every=5)
    for i in range(12):
        s.create(make_job(P, f"job-{i:02d}"))
    assert os.path.exists(os.path.join(d, "snapshot.json"))
    with open(os.path.join(d, "wal-TPUJob.jsonl")) as f:
        assert len(f.readlines()) < 5
    last_rv = s.resource_version
    s.close()
    r = store(P, d)
    assert len(r.list("TPUJob")[0]) == 12
    assert r.resource_version == last_rv


def test_forced_compaction_bounds_wal_under_overlapping_commits(P, tmp_path):
    """Past FORCE_COMPACT_FACTOR x compact_every the store stalls new
    commits, drains the in-flight set and compacts; no acked write is
    lost across the forced snapshot."""
    d = str(tmp_path / "j")
    s = store(P, d, compact_every=4)
    s.create(make_pod(P, "p0"))
    seg = s._segments["Pod"]
    entered, release = threading.Event(), threading.Event()
    orig_append = seg.append

    def gated_append(line):
        entered.set()
        assert release.wait(10)
        orig_append(line)

    seg.append = gated_append
    t = threading.Thread(target=s.create, args=(make_pod(P, "p1"),), daemon=True)
    t.start()
    assert entered.wait(10)

    n = 0
    while s._wal_records < 4 * P.s.FORCE_COMPACT_FACTOR:
        s.create(make_job(P, f"flood-{n}"))
        n += 1
    assert s._compact_pending
    assert not os.path.exists(os.path.join(d, "snapshot.json"))

    stalled_done = threading.Event()
    t2 = threading.Thread(
        target=lambda: (s.create(make_job(P, "stalled")), stalled_done.set()), daemon=True)
    t2.start()
    assert not stalled_done.wait(0.3)

    release.set()
    t.join(10)
    assert stalled_done.wait(10)
    t2.join(10)
    assert not s._compact_pending
    assert os.path.exists(os.path.join(d, "snapshot.json"))
    assert s._wal_records == 1
    s.close()

    r = store(P, d)
    assert {p.metadata.name for p in r.list("Pod")[0]} == {"p0", "p1"}
    assert {j.metadata.name for j in r.list("TPUJob")[0]} == (
        {f"flood-{i}" for i in range(n)} | {"stalled"})


def test_pre_compaction_watch_rv_gets_410(P, tmp_path):
    d = str(tmp_path / "j")
    s = store(P, d, compact_every=4)
    s.create(make_job(P, "old"))
    old_rv = s.resource_version
    for i in range(8):
        s.create(make_job(P, f"churn-{i}"))
    s.close()
    r = store(P, d)
    with pytest.raises(P.s.Gone):
        r.watch("TPUJob", since_rv=old_rv)
    items, rv = r.list("TPUJob")
    assert len(items) == 9
    r.watch("TPUJob", since_rv=rv)  # no Gone


# -- torn tails and corruption -----------------------------------------------------


def test_partial_final_line_truncated(P, tmp_path):
    d = str(tmp_path / "j")
    s = store(P, d)
    s.create(make_job(P, "kept"))
    last_rv = s.resource_version
    s.close()
    wal = os.path.join(d, "wal-TPUJob.jsonl")
    with open(wal, "ab") as f:
        f.write(b'{"rv": 99, "type": "ADDED", "obj": {"kind": "TPU')  # torn

    r = store(P, d)
    assert r.resource_version == last_rv
    assert r.get("TPUJob", "default", "kept").metadata.name == "kept"
    r.create(make_job(P, "after"))
    r.close()
    with open(wal) as f:
        recs = [json.loads(line) for line in f]
    assert [rec["obj"]["metadata"]["name"] for rec in recs] == ["kept", "after"]


def test_midfile_corruption_refuses_to_start(P, tmp_path):
    d = str(tmp_path / "j")
    s = store(P, d)
    s.create(make_job(P, "first"))
    s.create(make_job(P, "second"))
    s.close()
    wal = os.path.join(d, "wal-TPUJob.jsonl")
    lines = open(wal, "rb").read().splitlines(keepends=True)
    corrupted = lines[0] + b'{"rv": 99, "type": "ADDED", "obj": {"kind": "Nope"}}\n' + lines[1]
    with open(wal, "wb") as f:
        f.write(corrupted)
    with pytest.raises(P.s.JournalCorrupt):
        store(P, d)
    assert open(wal, "rb").read() == corrupted


def test_wal_only_no_snapshot(P, tmp_path):
    d = str(tmp_path / "j")
    s = store(P, d)
    s.create(make_job(P, "solo"))
    s.close()
    assert not os.path.exists(os.path.join(d, "snapshot.json"))
    assert store(P, d).get("TPUJob", "default", "solo").metadata.name == "solo"


# -- failed appends ----------------------------------------------------------------


class _TornFile:
    """Writes half a record, then fails as a full disk does."""

    def __init__(self, inner, torn=True):
        self._inner, self._torn = inner, torn

    def tell(self):
        return self._inner.tell()

    def write(self, data):
        if self._torn:
            self._inner.write(data[: len(data) // 2])
        raise OSError(28, "No space left on device")

    def __getattr__(self, name):
        return getattr(self._inner, name)


def test_failed_append_commits_nothing_and_rolls_back(P, tmp_path):
    d = str(tmp_path / "j")
    s = store(P, d)
    s.create(make_job(P, "good"))
    seg = s._segments["TPUJob"]
    good_bytes = open(seg.path, "rb").read()
    seg._f = _TornFile(seg._f)
    with pytest.raises(OSError):
        s.create(make_job(P, "doomed"))
    with pytest.raises(P.s.StoreError):
        s.get("TPUJob", "default", "doomed")
    assert open(seg.path, "rb").read() == good_bytes
    s.create(make_job(P, "after-enospc"))
    s.close()
    r = store(P, d)
    assert sorted(o.metadata.name for o in r.list("TPUJob")[0]) == ["after-enospc", "good"]
    r.close()


def test_failed_append_on_one_kind_leaves_other_kinds_writable(P, tmp_path):
    d = str(tmp_path / "j")
    s = store(P, d)
    s.create(make_job(P, "good"))
    s._segments["TPUJob"]._f = _TornFile(s._segments["TPUJob"]._f, torn=False)
    with pytest.raises(OSError):
        s.create(make_job(P, "doomed"))
    s.create(make_pod(P, "p0"))
    s.close()
    r = store(P, d)
    assert [o.metadata.name for o in r.list("TPUJob")[0]] == ["good"]
    assert [o.metadata.name for o in r.list("Pod")[0]] == ["p0"]
    r.close()


def test_unrecoverable_append_poisons_the_store(P, tmp_path, monkeypatch):
    d = str(tmp_path / "j")
    s = store(P, d)
    s.create(make_job(P, "good"))

    class DoomedFile:
        def tell(self):
            return 0

        def write(self, data):
            raise OSError(5, "I/O error")

        def close(self):
            raise OSError(5, "I/O error")

    s._segments["TPUJob"]._f = DoomedFile()
    real_open = open

    def failing_open(path, *a, **kw):
        if str(path).endswith("wal-TPUJob.jsonl") and "a" in (a[0] if a else kw.get("mode", "")):
            raise OSError(5, "I/O error")
        return real_open(path, *a, **kw)

    monkeypatch.setattr("builtins.open", failing_open)
    with pytest.raises(OSError):
        s.create(make_job(P, "doomed"))
    monkeypatch.undo()
    with pytest.raises(P.s.StoreError, match="poisoned"):
        s.create(make_job(P, "rejected"))
    s._segments.pop("TPUJob")  # DoomedFile.close raises; drop it instead
    r = store(P, d)
    assert [o.metadata.name for o in r.list("TPUJob")[0]] == ["good"]
    r.close()


# -- one journal, either package ---------------------------------------------------


def _write_mixed(P, d):
    """Jobs, a pod, a lease, an update, a status write, a finalizer-marked
    delete and a real delete, with a compaction in the middle."""
    s = store(P, d, compact_every=6)
    for i in range(4):
        s.create(make_job(P, f"job-{i}", finalizers=["tfk8s.dev/teardown"] if i == 0 else ()))
    s.create(make_pod(P, "pod-0"))
    s.create(P.t.Lease(metadata=P.t.ObjectMeta(name="node-a", namespace="default"),
                       spec=P.t.LeaseSpec(holder="a", lease_duration_s=15.0, renew_time=7.5)))
    j = P.thaw(s.get("TPUJob", "default", "job-1"))
    j.spec.replica_specs[P.t.ReplicaType.WORKER].replicas = 3
    s.update(j)
    j = P.thaw(s.get("TPUJob", "default", "job-2"))
    j.status.gang_restarts = 2
    s.update_status(j)
    s.delete("TPUJob", "default", "job-0")  # marks: the finalizer holds it
    s.delete("TPUJob", "default", "job-3")
    rv = s.resource_version
    s.close()
    return rv


def _state(P, d):
    s = store(P, d)
    out = {kind: sorted((json.dumps(P.serde.to_wire(o), sort_keys=True)
                         for o in s.list(kind)[0]))
           for kind in ("TPUJob", "Pod", "Lease")}
    rv = s.resource_version
    s.close()
    return rv, out


@pytest.mark.parametrize("writer,reader", [("reference", "port"), ("port", "reference")])
def test_a_journal_replays_in_the_other_package(tmp_path, writer, reader):
    d = str(tmp_path / "j")
    rv = _write_mixed(PACKAGES[writer], d)
    assert os.path.exists(os.path.join(d, "snapshot.json"))
    written_rv, written = _state(PACKAGES[writer], d)
    read_rv, read = _state(PACKAGES[reader], d)
    assert written_rv == read_rv == rv
    assert read == written
    assert len(read["TPUJob"]) == 3 and len(read["Pod"]) == 1 and len(read["Lease"]) == 1
    # the reader goes on from the writer's rv, in the writer's format
    r = store(PACKAGES[reader], d)
    assert r.create(make_job(PACKAGES[reader], "next")).metadata.resource_version == rv + 1
    r.close()
    assert _state(PACKAGES[writer], d)[0] == rv + 1
