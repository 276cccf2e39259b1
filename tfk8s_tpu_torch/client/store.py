"""In-memory cluster state store with List/Watch — the L0 substrate.

This is the apiserver-shaped object store the whole control plane runs
against hermetically, the way the reference's operator family tests
"multi-node" against a fake clientset serving CRUD + watch from an
in-memory tracker (SURVEY.md §4). It implements the semantics the reference
documents for the real apiserver:

- **Optimistic concurrency**: every write bumps a store-wide monotonic
  ``resource_version``; updates carrying a stale version fail with
  :class:`Conflict` (the requeue-on-conflict path, SURVEY.md §7 hard part 2).
- **Watch streams**: ``watch(kind, since_rv)`` replays buffered events after
  ``since_rv`` then streams live — the List/Watch contract the Reflector
  consumes (images/informer1.png at k8s-operator.md:60). A ``since_rv``
  older than the history window raises :class:`Gone` (HTTP 410), forcing
  the reflector to relist — exactly the real protocol.
- **Finalizer-gated deletion**: deleting an object with finalizers only sets
  ``metadata.deletion_timestamp``; the object is removed when a controller
  strips the last finalizer (k8s-operator.md:36-43).
- **Durability** (``journal_dir``): every mutation appends one JSONL record
  to a write-ahead log before it is acknowledged; a snapshot compacts the
  log periodically. The WAL is **segmented per kind**
  (``wal-<Kind>.jsonl``): each record carries its resource_version, and
  replay merges every segment (plus a legacy single-stream ``wal.jsonl``
  if present) in rv order — so concurrent writers of DIFFERENT kinds
  serialize+append in parallel under their own kind locks instead of all
  funnelling one append stream through the store-wide commit lock (the
  durable-store counterpart of the per-kind-lock read/write split). A
  restarted store replays snapshot+segments and resumes the SAME
  resource_version sequence — the etcd-backed persistence the reference's
  REST contract presupposes (k8s-operator.md:33-43: deletion timestamps
  and finalizers only make sense on objects that survive a control-plane
  restart). Watchers reconnecting from a pre-restart rv that the replayed
  WAL no longer covers get :class:`Gone` and relist — the same recovery
  path as a compacted etcd.

**Copy-on-write** (client-go's shared-informer discipline, enforced via
``api/frozen.py``): every stored object is FROZEN once at the write
barrier; ``get``/``list``/watch events then share that frozen instance
by reference — zero copies on the read path, label-selector filtering
runs on the stored objects before anything is materialized, and a
consumer mutation raises :class:`~tfk8s_tpu_torch.api.frozen.FrozenObjectError`
instead of silently corrupting shared state. Write verbs still RETURN a
private mutable copy (the pre-existing contract: callers edit the return
and send it back as the next update). Mutating clients go through
``thaw()`` (the typed client's ``get()`` does this for them).

**Locking** is two-level: one lock per kind serializes that kind's
bucket (so TPUJob status patches stop contending with Pod creates — the
expensive merge/encode/decode work runs under the kind lock only), and a
short store-wide commit lock orders rv assignment, the WAL append,
history, and watch fanout.
"""

from __future__ import annotations

import copy
import enum
import itertools
import json
import logging
import os
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass
from typing import Any, Deque, Dict, Iterator, List, Optional, Tuple

from tfk8s_tpu_torch.api.frozen import FrozenObjectError, freeze, thaw  # noqa: F401

log = logging.getLogger(__name__)


class StoreError(Exception):
    pass


class NotFound(StoreError):
    pass


class AlreadyExists(StoreError):
    pass


class Conflict(StoreError):
    """Stale resource_version on update (optimistic-concurrency failure)."""


class Gone(StoreError):
    """Watch requested from a resource_version older than the event buffer —
    the client must relist (HTTP 410 semantics)."""


class Invalid(StoreError):
    """A syntactically well-formed request whose CONTENT cannot be
    processed (HTTP 422 semantics): e.g. a merge-patch carrying a
    non-numeric ``metadata.resourceVersion`` precondition. Distinct from
    admission rejection (which validates the merged OBJECT); this
    rejects the request itself."""


class Unavailable(StoreError):
    """The apiserver cannot be reached (connection refused/reset, 5xx) —
    transient by nature; callers with durable obligations (the kubelet's
    terminal phase writes) retry these, and ONLY these."""


class JournalCorrupt(StoreError):
    """A complete (newline-terminated) WAL record failed to decode —
    mid-file corruption or a schema break. Refusing to start is the only
    safe response: truncating would destroy acked records written after
    the bad one."""


class Unauthorized(StoreError):
    """No/invalid credentials against a secured apiserver (HTTP 401)."""


class Forbidden(StoreError):
    """Authenticated but not permitted — e.g. a read-only credential
    attempting a write (HTTP 403)."""


class EventType(str, enum.Enum):
    ADDED = "ADDED"
    MODIFIED = "MODIFIED"
    DELETED = "DELETED"


@dataclass
class WatchEvent:
    type: EventType
    # The SHARED frozen stored instance — do not mutate; thaw() for a
    # private mutable copy. (The event wrapper itself is per-watcher.)
    object: Any

    @property
    def kind(self) -> str:
        return self.object.kind


# Per-watcher pending-event bound: past it, same-key events coalesce
# (the slow-watcher policy below) so one stalled consumer's backlog is
# bounded by the number of DISTINCT live objects, not by event rate.
DEFAULT_WATCH_QUEUE = 1024

# Compaction normally runs opportunistically when a commit applies with no
# other commit in its journal window (_inflight == 0). Under sustained
# overlapping writes that moment may never come; once the WAL reaches this
# multiple of compact_every, new commits stall until the in-flight set
# drains and the compaction runs, bounding WAL growth.
FORCE_COMPACT_FACTOR = 2


def _coalesce_type(pending: EventType, new: EventType) -> EventType:
    """Merge two pending event types for one object so the consumer still
    converges to the right level-triggered state: anything followed by
    DELETED is a delete; an unseen ADDED absorbing updates stays ADDED.
    A pending DELETED is never merged INTO (the push path treats it as a
    barrier): collapsing delete+recreate would hide the deletion — and
    the identity (uid) change — from consumers whose delete path does
    real work (the kubelet stops the old pod's runner on delete)."""
    if new == EventType.DELETED:
        return EventType.DELETED
    if pending == EventType.ADDED:
        return EventType.ADDED
    return EventType.MODIFIED


class Watch:
    """One consumer's event stream. Iterate to receive events; ``stop()``
    ends the iteration (the stopCh analogue, k8s-operator.md:200-203).

    The queue holds per-watcher event WRAPPERS around shared frozen
    objects (no per-watcher deep copies). When a slow consumer's backlog
    reaches ``queue_limit``, further events for an object that already
    has one pending COALESCE into it (latest state wins — the informer
    contract is level-triggered, so intermediate states are droppable);
    events for new objects still append, bounding the backlog by the
    live-object count. ``coalesced_total`` counts the merges."""

    def __init__(self, queue_limit: int = DEFAULT_WATCH_QUEUE) -> None:
        self._cond = threading.Condition()
        self._items: Deque[WatchEvent] = deque()
        # object key -> its (single) pending event, for O(1) coalescing
        self._pending: Dict[str, WatchEvent] = {}
        self._queue_limit = queue_limit
        self._stopped = False
        self.coalesced_total = 0

    @staticmethod
    def _event_key(ev: WatchEvent) -> Optional[str]:
        try:
            return f"{ev.object.kind}/{ev.object.metadata.key}"
        except AttributeError:
            return None

    def _push(self, ev: WatchEvent) -> bool:
        """Enqueue one event (the wrapper becomes watcher-owned). Returns
        True when it coalesced into an already-pending event."""
        with self._cond:
            if self._stopped:
                return False
            key = self._event_key(ev)
            if (
                self._queue_limit
                and len(self._items) >= self._queue_limit
                and key is not None
            ):
                pending = self._pending.get(key)
                # a pending DELETED is a barrier: a re-ADD after it must
                # be delivered separately or the consumer never sees the
                # deletion (and the uid change) at all
                if pending is not None and pending.type != EventType.DELETED:
                    pending.type = _coalesce_type(pending.type, ev.type)
                    pending.object = ev.object
                    self.coalesced_total += 1
                    return True
            self._items.append(ev)
            if key is not None:
                self._pending[key] = ev
            self._cond.notify()
            return False

    def _pop_locked(self) -> WatchEvent:
        ev = self._items.popleft()
        key = self._event_key(ev)
        if key is not None and self._pending.get(key) is ev:
            del self._pending[key]
        return ev

    def stop(self) -> None:
        with self._cond:
            self._stopped = True
            self._cond.notify_all()

    def __iter__(self) -> Iterator[WatchEvent]:
        while True:
            with self._cond:
                while not self._items and not self._stopped:
                    self._cond.wait()
                if self._stopped:
                    return
                ev = self._pop_locked()
            yield ev

    def next(self, timeout: Optional[float] = None) -> Optional[WatchEvent]:
        """Blocking pop with timeout; None on timeout or stop (already-
        queued events are still drained after stop)."""
        with self._cond:
            deadline = None if timeout is None else time.monotonic() + timeout
            while not self._items and not self._stopped:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return None
                self._cond.wait(remaining)
            if self._items:
                return self._pop_locked()
            return None

    def next_batch(
        self, max_items: int = 256, timeout: Optional[float] = None
    ) -> List[WatchEvent]:
        """Blocking pop of up to ``max_items`` already-queued events — one
        wakeup drains a burst, which is what lets the Reflector apply N
        rapid updates as one batch. Empty list on timeout or stop."""
        with self._cond:
            deadline = None if timeout is None else time.monotonic() + timeout
            while not self._items and not self._stopped:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return []
                self._cond.wait(remaining)
            out: List[WatchEvent] = []
            while self._items and len(out) < max_items:
                out.append(self._pop_locked())
            return out


class _Segment:
    """One kind's WAL segment file. Appends are serialized by a private
    IO mutex (NOT the kind lock — compaction must be able to truncate a
    segment it couldn't take the kind lock for without deadlocking the
    kind→commit lock order). A failed append rolls the file back to its
    last good byte (the write-AHEAD contract: nothing half-written may
    survive to fuse with the next record)."""

    def __init__(self, path: str, fsync: bool):
        self.path = path
        self._fsync = fsync
        self._lock = threading.Lock()
        self._f = open(path, "ab")

    def append(self, line: bytes) -> None:
        """Append one complete record line, or raise leaving the file
        byte-identical to its pre-call state. OSError on unrecoverable
        rollback failure carries ``.rollback_failed = True``."""
        with self._lock:
            start = self._f.tell()
            try:
                self._f.write(line)
                self._f.flush()
                if self._fsync:
                    os.fsync(self._f.fileno())
            # ValueError = closed handle (an append racing close() past
            # the _closed check): same rollback treatment — the on-disk
            # bytes are already consistent, the reopen restores a handle
            except (OSError, ValueError) as e:
                try:
                    self._f.close()  # may raise re-flushing; superseded below
                except OSError:
                    pass
                try:
                    with open(self.path, "ab") as fix:
                        fix.truncate(start)
                    self._f = open(self.path, "ab")
                except OSError:
                    e.rollback_failed = True
                raise

    def truncate(self) -> None:
        with self._lock:
            self._f.truncate(0)
            self._f.seek(0)

    def close(self) -> None:
        with self._lock:
            try:
                self._f.close()
            except OSError:
                pass


def _key(namespace: str, name: str) -> str:
    return f"{namespace}/{name}"


def match_labels(selector: Dict[str, str], labels: Dict[str, str]) -> bool:
    return all(labels.get(k) == v for k, v in selector.items())


def merge_patch(target: Any, patch: Any) -> Any:
    """RFC 7386 JSON merge-patch: dicts merge recursively, ``null`` deletes
    a key, everything else (including lists) replaces wholesale."""
    if not isinstance(patch, dict):
        return copy.deepcopy(patch)
    result = dict(target) if isinstance(target, dict) else {}
    for k, v in patch.items():
        if v is None:
            result.pop(k, None)
        else:
            result[k] = merge_patch(result.get(k), v)
    return result


_MISSING = object()


def replace_patch(current: Any, desired: Any) -> Dict[str, Any]:
    """The inverse of :func:`merge_patch`: the smallest merge-patch that
    transforms ``current`` into exactly ``desired`` — keys present in
    current but absent from desired become explicit ``null`` deletions.
    This is how `apply` gets REPLACE semantics (a field removed from the
    manifest really goes away) over the merge-patch wire verb. Returns
    ``{}`` when nothing differs."""
    p = _replace_patch(current, desired)
    return {} if p is _MISSING else p


def _replace_patch(current: Any, desired: Any) -> Any:
    if isinstance(desired, dict) and isinstance(current, dict):
        patch = {}
        for k, v in desired.items():
            cv = current.get(k, _MISSING)
            if cv is _MISSING:
                patch[k] = copy.deepcopy(v)
            else:
                sub = _replace_patch(cv, v)
                if sub is not _MISSING:
                    patch[k] = sub
        for k in current:
            if k not in desired:
                patch[k] = None
        return patch if patch else _MISSING
    if current == desired:
        return _MISSING
    return copy.deepcopy(desired)


class ClusterStore:
    """Thread-safe object store keyed by (kind, namespace/name).

    With ``journal_dir`` set, the store is durable: ``snapshot.json`` holds
    a compacted full state, per-kind ``wal-<Kind>.jsonl`` segments the
    event log since; construction replays snapshot + segments (merged by
    rv; a legacy single-stream ``wal.jsonl`` is honored and retired at
    the next compaction) and resumes the rv sequence. ``fsync=False``
    trades power-loss durability for write latency (kill -9 survival only
    needs the page cache, so tests and the control-plane bench may
    disable it).

    Read contract (copy-on-write, module docstring): ``get``/``list``
    return the SHARED frozen stored instance; mutating it raises
    ``FrozenObjectError``. Write verbs return a private mutable copy.

    ``metrics`` (optional registry) exports
    ``tfk8s_watch_coalesced_total{kind}`` — events merged into a slow
    watcher's pending backlog instead of delivered individually.
    """

    def __init__(
        self,
        history_limit: int = 4096,
        journal_dir: Optional[str] = None,
        compact_every: int = 4096,
        fsync: bool = True,
        metrics=None,
        watch_queue_limit: int = DEFAULT_WATCH_QUEUE,
    ) -> None:
        # Store-wide commit lock: rv sequence, WAL, history ring, watcher
        # registry, fanout. Held only for the (cheap) commit step; the
        # expensive per-object work runs under the kind lock.
        self._lock = threading.RLock()
        # One lock per kind serializes that kind's bucket: a TPUJob
        # status patch (encode+merge+decode under its kind lock) no
        # longer blocks a concurrent Pod create. Lock order is ALWAYS
        # kind lock -> commit lock, never the reverse.
        self._kind_locks: Dict[str, threading.RLock] = {}
        self._objects: Dict[str, Dict[str, Any]] = {}
        self._rv = itertools.count(1)
        self._last_rv = 0
        # ring buffer of (rv, WatchEvent) for replay
        self._history: "deque[Tuple[int, WatchEvent]]" = deque(maxlen=history_limit)
        self._watchers: List[Tuple[str, Watch]] = []
        self._journal_dir = journal_dir
        self._compact_every = compact_every
        self._fsync = fsync
        self._metrics = metrics
        self._watch_queue_limit = watch_queue_limit
        # per-kind WAL segments (wal-<Kind>.jsonl), opened lazily on the
        # kind's first journaled write; replay merges them all by rv
        self._segments: Dict[str, _Segment] = {}
        self._wal_records = 0  # total records across all segments
        # commits between rv-assign and bucket-apply: compaction must not
        # run (and truncate a journaled-but-unapplied record) while any
        # are in flight
        self._inflight = 0
        # Set when the WAL outgrows FORCE_COMPACT_FACTOR x compact_every
        # while commits kept overlapping (the opportunistic
        # ``_inflight == 0`` check alone can starve forever under
        # sustained concurrent multi-kind writes). New commits then stall
        # at rv-assign until the last in-flight commit compacts, so WAL
        # growth is bounded at ~FORCE_COMPACT_FACTOR x the threshold.
        self._compact_pending = False
        self._compact_cv = threading.Condition(self._lock)
        # events at/below this rv are unreplayable (compacted away before
        # this process started); watchers older than it must relist
        self._base_rv = 0
        self._poisoned = False
        # close() flips this (under the commit lock): later writes skip
        # journaling instead of lazily re-opening a segment past close —
        # the pre-segment `_wal = None` semantics
        self._closed = False
        if metrics is not None:
            metrics.describe(
                "tfk8s_watch_coalesced_total",
                "Watch events merged into a slow watcher's pending "
                "backlog (latest state wins) instead of delivered "
                "individually.",
            )
        if journal_dir is not None:
            self._open_journal()

    def _kind_lock(self, kind: str) -> threading.RLock:
        lock = self._kind_locks.get(kind)
        if lock is None:
            with self._lock:
                lock = self._kind_locks.setdefault(kind, threading.RLock())
        return lock

    # -- journal ------------------------------------------------------------

    @property
    def _snapshot_path(self) -> str:
        return os.path.join(self._journal_dir, "snapshot.json")

    # single-stream WAL from pre-segment builds: replayed (merged by rv)
    # and removed at the next compaction
    @property
    def _legacy_wal_path(self) -> str:
        return os.path.join(self._journal_dir, "wal.jsonl")

    def _segment_path(self, kind: str) -> str:
        return os.path.join(self._journal_dir, f"wal-{kind}.jsonl")

    def _segment_paths_on_disk(self) -> List[str]:
        out = []
        for n in sorted(os.listdir(self._journal_dir)):
            if n == "wal.jsonl" or (n.startswith("wal-") and n.endswith(".jsonl")):
                out.append(os.path.join(self._journal_dir, n))
        return out

    def _read_segment(self, path: str) -> List[Tuple[int, EventType, Any]]:
        """Parse one WAL file into (rv, type, frozen obj) records. A torn
        FINAL line (kill -9 mid-write) is truncated away — everything
        before it was acknowledged with a complete line, so nothing acked
        is lost. A COMPLETE line that fails to decode is mid-file
        corruption (or a schema break); acked records may follow it, so
        refuse to start instead of truncating them away (etcd does the
        same)."""
        from tfk8s_tpu_torch.api import serde  # api layer; no import cycle

        records: List[Tuple[int, EventType, Any]] = []
        good_end = 0
        with open(path, "rb") as f:
            for line in f:
                if not line.endswith(b"\n"):
                    log.warning(
                        "journal: truncating torn WAL tail of %s (%d bytes)",
                        os.path.basename(path), len(line),
                    )
                    break
                try:
                    rec = json.loads(line)
                    obj = freeze(serde.decode_object(rec["obj"]))
                    records.append((rec["rv"], EventType(rec["type"]), obj))
                except (ValueError, KeyError) as e:
                    raise JournalCorrupt(
                        f"{path} byte {good_end}: undecodable complete "
                        f"record: {e}"
                    ) from e
                good_end += len(line)
        with open(path, "ab") as fix:  # drop the torn tail on disk too
            fix.truncate(good_end)
        return records

    def _open_journal(self) -> None:
        """Replay snapshot + every WAL segment (merged by rv), then open
        segments for append lazily. Records at/below the snapshot rv are
        skipped — a legacy or straggler file can never roll applied state
        backwards."""
        from tfk8s_tpu_torch.api import serde  # api layer; no import cycle

        os.makedirs(self._journal_dir, exist_ok=True)
        snap_rv = 0
        if os.path.exists(self._snapshot_path):
            with open(self._snapshot_path) as f:
                snap = json.load(f)
            snap_rv = snap["rv"]
            self._last_rv = snap_rv
            for data in snap["objects"]:
                obj = freeze(serde.decode_object(data))
                self._bucket(obj.kind)[obj.metadata.key] = obj
        self._base_rv = snap_rv
        records: List[Tuple[int, EventType, Any]] = []
        for path in self._segment_paths_on_disk():
            records.extend(self._read_segment(path))
        records.sort(key=lambda r: r[0])
        for rv, etype, obj in records:
            if rv <= snap_rv:
                continue  # already folded into the snapshot
            bucket = self._bucket(obj.kind)
            if etype == EventType.DELETED:
                bucket.pop(obj.metadata.key, None)
            else:
                bucket[obj.metadata.key] = obj
            self._last_rv = max(self._last_rv, rv)
            self._history.append((rv, WatchEvent(etype, obj)))
            self._wal_records += 1
        self._rv = itertools.count(self._last_rv + 1)

    def _segment(self, kind: str) -> _Segment:
        seg = self._segments.get(kind)
        if seg is None:
            with self._lock:
                if self._closed:
                    # a commit that captured journaling=True just before
                    # close() must fail loudly, not lazily re-create a
                    # segment file in a directory the owner believes dead
                    raise StoreError("store closed; refusing journal append")
                seg = self._segments.get(kind)
                if seg is None:
                    seg = _Segment(self._segment_path(kind), self._fsync)
                    self._segments[kind] = seg
        return seg

    def _journal(self, etype: EventType, obj: Any) -> None:
        """Append one event record to the object's KIND segment — called
        under the kind lock (not the store-wide commit lock), BEFORE the
        mutation is applied or fanned out, so nothing observable ever
        precedes the WAL. Per-kind segments mean two kinds' writers
        serialize and append concurrently; within a segment rv order holds
        because the kind lock covers the whole write.

        A failed append leaves the segment byte-identical to its last good
        state (see :class:`_Segment`). If even the rollback fails, the
        journal is poisoned and every further mutation is refused —
        availability is the right thing to sacrifice for a store whose
        point is durability."""
        from tfk8s_tpu_torch.api import serde

        if self._poisoned:
            raise StoreError(
                "journal poisoned by an earlier unrecoverable write error; "
                "refusing mutations (restart the apiserver to re-replay)"
            )
        rec = {
            "rv": obj.metadata.resource_version,
            "type": etype.value,
            "obj": serde.to_dict(obj),
        }
        try:
            self._segment(obj.kind).append((json.dumps(rec) + "\n").encode())
        except (OSError, ValueError) as e:
            if getattr(e, "rollback_failed", False):
                self._poisoned = True
                log.error(
                    "journal: could not roll back failed append; poisoning "
                    "the store (segments intact through rv %d)", self._last_rv,
                )
            raise
        with self._lock:
            self._wal_records += 1

    def _compact(self) -> None:
        """Atomic snapshot of full state, then truncate every segment (and
        drop a legacy single-stream WAL). Watchers holding pre-snapshot
        rvs will relist via Gone after a restart — exactly etcd compaction
        semantics.

        Ordering matters: the snapshot (and, under fsync, its directory
        entry) must be durable BEFORE any segment is truncated, or a power
        cut between the two could leave the old snapshot + empty segments
        — losing everything since the previous compaction.

        Runs synchronously under the store lock with ``_inflight == 0``
        (enforced by the caller): a commit that journaled but has not yet
        applied would otherwise have its record truncated while missing
        from the snapshot — an acked-write hole. The pause is single-digit
        ms at this store's scale every ``compact_every`` writes."""
        from tfk8s_tpu_torch.api import serde

        snap = {
            "rv": self._last_rv,
            "objects": [
                serde.to_dict(obj)
                for bucket in self._objects.values()
                for obj in bucket.values()
            ],
        }
        tmp = self._snapshot_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(snap, f)
            f.flush()
            if self._fsync:
                os.fsync(f.fileno())
        os.replace(tmp, self._snapshot_path)
        if self._fsync:
            # persist the rename itself before dropping the segments
            dir_fd = os.open(self._journal_dir, os.O_RDONLY)
            try:
                os.fsync(dir_fd)
            finally:
                os.close(dir_fd)
        # truncate through the live handles — no close/reopen window in
        # which a failure could leave the store without a WAL handle
        for seg in self._segments.values():
            seg.truncate()
        # stale on-disk files with no live handle (a kind not written
        # since restart, or the legacy single-stream WAL): their records
        # are all <= the snapshot rv now — remove them so replay never
        # re-reads them
        open_paths = {seg.path for seg in self._segments.values()}
        for path in self._segment_paths_on_disk():
            if path not in open_paths:
                try:
                    os.remove(path)
                except OSError:
                    pass  # replay skips <=snapshot-rv records anyway
        self._wal_records = 0

    def close(self) -> None:
        with self._lock:
            self._closed = True
            for seg in self._segments.values():
                seg.close()  # takes each segment's IO mutex: in-flight
                # appends finish before their handle closes
            self._segments = {}

    # -- internals ----------------------------------------------------------

    def _bump(self) -> int:
        self._last_rv = next(self._rv)
        return self._last_rv

    def _insert_history(self, rv: int, ev: WatchEvent) -> None:
        """Keep the replay ring rv-ascending. Commits of DIFFERENT kinds
        can reach the apply step out of rv order (rv assignment and apply
        are separate commit-lock sections, with the kind-parallel journal
        append between them); a short bubble from the tail restores order.
        Called under the commit lock."""
        h = self._history
        h.append((rv, ev))
        i = len(h) - 1
        while i > 0 and h[i - 1][0] > rv:
            h[i - 1], h[i] = h[i], h[i - 1]
            i -= 1

    def _commit(self, etype: EventType, stored: Any, apply) -> Any:
        """The write barrier: assign the rv (commit lock), FREEZE the
        object (the one structural walk per write — every read after this
        shares the frozen instance), journal to the kind's WAL segment
        (kind-parallel: only the kind lock is held), then apply the bucket
        mutation + history + watch fanout (commit lock again).
        Journal-before-apply keeps the log write-AHEAD: a failed append
        (ENOSPC, dead disk) raises to the client with NO state change, so
        readers can never observe an object that a restart would forget.
        Returns the frozen stored object."""
        with self._lock:
            # a forced compaction is waiting for in-flight commits to
            # drain: don't start a new journal window until it has run
            # (in-flight commits themselves never wait here, so the
            # drain — and this stall — is bounded)
            while self._compact_pending:
                self._compact_cv.wait()
            journaling = self._journal_dir is not None and not self._closed
            stored.metadata.resource_version = self._bump()
            if journaling:
                self._inflight += 1
        frozen_obj = freeze(stored)
        if journaling:
            try:
                self._journal(etype, frozen_obj)
            except BaseException:
                with self._lock:
                    self._inflight -= 1
                    if self._inflight == 0 and self._compact_pending:
                        # the commit this forced compaction was waiting on
                        # failed its append: unstall writers; the next
                        # successful write re-triggers compaction
                        # (_wal_records is still over threshold)
                        self._compact_pending = False
                        self._compact_cv.notify_all()
                raise
        with self._lock:
            apply()
            if journaling:
                self._inflight -= 1
                # compact only AFTER the mutation is applied, and only
                # with no other commit mid-flight — a snapshot taken while
                # a journaled-but-unapplied record exists would miss it
                # and the truncation would destroy its only copy. A
                # compaction failure must NOT fail the (already committed
                # and journaled) mutation: log it and retry at the next
                # write, when _wal_records will still be over threshold.
                if self._wal_records >= self._compact_every:
                    if self._inflight == 0:
                        try:
                            self._compact()
                        except OSError as e:
                            log.warning(
                                "journal: compaction failed (will retry): %s",
                                e,
                            )
                        finally:
                            if self._compact_pending:
                                self._compact_pending = False
                                self._compact_cv.notify_all()
                    elif self._wal_records >= (
                        self._compact_every * FORCE_COMPACT_FACTOR
                    ):
                        # overlapping commits have starved the
                        # opportunistic check past FORCE_COMPACT_FACTOR x
                        # the threshold: stall new commits at rv-assign so
                        # the in-flight set drains; the last one to apply
                        # takes the _inflight == 0 branch above and
                        # releases the waiters
                        self._compact_pending = True
            self._insert_history(
                stored.metadata.resource_version, WatchEvent(etype, frozen_obj)
            )
            kind = frozen_obj.kind
            for wkind, w in self._watchers:
                if wkind == kind:
                    # one shared frozen object; only the tiny per-watcher
                    # event wrapper is allocated here
                    if w._push(WatchEvent(etype, frozen_obj)) and (
                        self._metrics is not None
                    ):
                        self._metrics.inc(
                            "tfk8s_watch_coalesced_total", 1.0, {"kind": kind}
                        )
        return frozen_obj

    def _bucket(self, kind: str) -> Dict[str, Any]:
        bucket = self._objects.get(kind)
        if bucket is None:
            bucket = self._objects.setdefault(kind, {})
        return bucket

    # -- CRUD ---------------------------------------------------------------

    def create(self, obj: Any) -> Any:
        with self._kind_lock(obj.kind):
            bucket = self._bucket(obj.kind)
            k = obj.metadata.key
            if k in bucket:
                raise AlreadyExists(f"{obj.kind} {k} already exists")
            stored = copy.deepcopy(obj)  # the write-barrier copy
            stored.metadata.uid = stored.metadata.uid or uuid.uuid4().hex
            stored.metadata.creation_timestamp = (
                stored.metadata.creation_timestamp or time.time()
            )
            self._commit(
                EventType.ADDED, stored, apply=lambda: bucket.__setitem__(k, stored)
            )
            return copy.deepcopy(stored)

    def get(self, kind: str, namespace: str, name: str) -> Any:
        """Returns the SHARED frozen stored instance (zero-copy read);
        mutate via ``thaw()`` only."""
        with self._kind_lock(kind):
            try:
                return self._bucket(kind)[_key(namespace, name)]
            except KeyError:
                raise NotFound(f"{kind} {namespace}/{name} not found") from None

    def list(
        self,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[Dict[str, str]] = None,
    ) -> Tuple[List[Any], int]:
        """Returns (items, resource_version) — the rv is the point to start
        watching from (List-then-Watch, images/informer1.png). Items are
        the SHARED frozen stored instances: the namespace/label filter
        runs directly on stored objects and nothing is copied — a
        selective list over a large bucket costs only the matches'
        references."""
        with self._kind_lock(kind):
            items = [
                obj
                for obj in self._bucket(kind).values()
                if (namespace is None or obj.metadata.namespace == namespace)
                and (
                    not label_selector
                    or match_labels(label_selector, obj.metadata.labels)
                )
            ]
            return items, self._last_rv

    def update(self, obj: Any) -> Any:
        """Write with optimistic-concurrency check. Clearing the last
        finalizer on a deletion-marked object completes the delete."""
        with self._kind_lock(obj.kind):
            bucket = self._bucket(obj.kind)
            k = obj.metadata.key
            if k not in bucket:
                raise NotFound(f"{obj.kind} {k} not found")
            current = bucket[k]
            if obj.metadata.resource_version != current.metadata.resource_version:
                raise Conflict(
                    f"{obj.kind} {k}: resource_version "
                    f"{obj.metadata.resource_version} != {current.metadata.resource_version}"
                )
            stored = copy.deepcopy(obj)  # the write-barrier copy
            stored.metadata.uid = current.metadata.uid
            stored.metadata.creation_timestamp = current.metadata.creation_timestamp
            # deletion_timestamp is set by delete(), never by clients
            stored.metadata.deletion_timestamp = current.metadata.deletion_timestamp
            if (
                stored.metadata.deletion_timestamp is not None
                and not stored.metadata.finalizers
            ):
                self._commit(
                    EventType.DELETED, stored, apply=lambda: bucket.pop(k)
                )
                return copy.deepcopy(stored)
            self._commit(
                EventType.MODIFIED, stored, apply=lambda: bucket.__setitem__(k, stored)
            )
            return copy.deepcopy(stored)

    def update_status(self, obj: Any) -> Any:
        """Status-subresource write: applies ONLY ``obj.status`` (same
        optimistic-concurrency rules as update). Spec and metadata edits
        riding along are discarded — the real apiserver's subresource
        isolation, so a status writer can never clobber a concurrent spec
        change it hasn't seen."""
        with self._kind_lock(obj.kind):
            bucket = self._bucket(obj.kind)
            k = obj.metadata.key
            if k not in bucket:
                raise NotFound(f"{obj.kind} {k} not found")
            current = bucket[k]
            if obj.metadata.resource_version != current.metadata.resource_version:
                raise Conflict(
                    f"{obj.kind} {k}: resource_version "
                    f"{obj.metadata.resource_version} != {current.metadata.resource_version}"
                )
            if not hasattr(current, "status"):
                raise StoreError(f"{obj.kind} has no status subresource")
            stored = copy.deepcopy(current)  # thaws the frozen current
            stored.status = copy.deepcopy(obj.status)
            self._commit(
                EventType.MODIFIED, stored, apply=lambda: bucket.__setitem__(k, stored)
            )
            return copy.deepcopy(stored)

    def patch(
        self,
        kind: str,
        namespace: str,
        name: str,
        patch: Dict[str, Any],
        subresource: Optional[str] = None,
        admit=None,
    ) -> Any:
        """JSON merge-patch (RFC 7386) against the stored object — the
        PATCH verb the reference's typed client is built on
        (k8s-operator.md:33-34): writers touch only the fields they own,
        so an operator's status write and a CLI spec write never fight
        over resourceVersion the way whole-object PUTs do.

        ``patch`` is in the Kubernetes WIRE form (camelCase keys, as
        ``serde.to_wire`` produces). Unlike update(), no resourceVersion
        is required — last-writer-wins on the touched fields; a patch
        that DOES carry ``metadata.resourceVersion`` turns it into an
        optimistic precondition (k8s semantics). Server-owned metadata
        (uid, creationTimestamp, deletionTimestamp) cannot be patched.
        ``subresource='status'`` confines the patch to ``status`` exactly
        as update_status confines PUT. ``admit`` (server-side) runs on the
        MERGED object before anything commits — a rejected patch leaves no
        trace, the same boundary a validating webhook gives PUT."""
        from tfk8s_tpu_torch.api import serde

        with self._kind_lock(kind):
            bucket = self._bucket(kind)
            k = _key(namespace, name)
            if k not in bucket:
                raise NotFound(f"{kind} {k} not found")
            current = bucket[k]
            md = patch.get("metadata")
            if md is not None and not isinstance(md, dict):
                # the apiserver rejects non-object ROOTS with 400; a
                # non-object metadata SUBTREE would otherwise crash the
                # resourceVersion read below as a 500 — same
                # request-content class: 422
                raise Invalid(
                    f"{kind} {k}: patch metadata must be an object, got "
                    f"{type(md).__name__}"
                )
            # the caller's patch is never mutated (no defensive deepcopy
            # needed): the rv precondition is read in place — if it rides
            # into the merge it is overwritten by the commit's fresh rv
            pre_rv = (md or {}).get("resourceVersion")
            if pre_rv is not None:
                try:
                    pre_rv = int(pre_rv)
                except (TypeError, ValueError):
                    # malformed precondition is a 422 on the request, not
                    # a 500 out of int() (ADVICE r5)
                    raise Invalid(
                        f"{kind} {k}: metadata.resourceVersion precondition "
                        f"must be numeric, got {pre_rv!r}"
                    ) from None
                if pre_rv != current.metadata.resource_version:
                    raise Conflict(
                        f"{kind} {k}: resourceVersion precondition {pre_rv} "
                        f"!= {current.metadata.resource_version}"
                    )
            if subresource == "status":
                # fast path: merge ONLY the status subtree — the
                # controller's per-reconcile write rides this, and a
                # full-object encode→merge→decode measured ~3x slower
                # than the subtree (control_plane bench, status_patches
                # vs creates). Identity/metadata/spec are untouched by
                # construction, so none of the protections below apply.
                if not hasattr(current, "status"):
                    raise StoreError(f"{kind} has no status subresource")
                merged_status = merge_patch(
                    serde.to_wire(current.status), patch.get("status", {})
                )
                stored = copy.deepcopy(current)  # thaws the frozen current
                # an explicit {"status": null} resets to the DEFAULT
                # status (key deletion semantics), never to None — a
                # None status would crash every later status reader
                stored.status = serde.from_dict(
                    type(current.status), merged_status or {}
                )
                self._commit(
                    EventType.MODIFIED, stored,
                    apply=lambda: bucket.__setitem__(k, stored),
                )
                return copy.deepcopy(stored)
            if subresource is not None:
                raise StoreError(f"unknown subresource {subresource!r}")
            # main-resource writes never touch status (subresource
            # isolation, mirroring update()); shallow-copy instead of
            # mutating the caller's patch
            if "status" in patch:
                patch = {pk: pv for pk, pv in patch.items() if pk != "status"}
            cur_wire = serde.to_wire(current)
            merged = merge_patch(cur_wire, patch)
            # identity is immutable under PATCH (the real apiserver rejects
            # name changes): restore kind/apiVersion/name/namespace BEFORE
            # decoding — a patched kind would otherwise re-type the object
            # into the wrong dataclass inside the old kind's bucket
            merged["kind"] = current.kind
            merged["apiVersion"] = cur_wire["apiVersion"]
            merged.setdefault("metadata", {})
            merged["metadata"]["name"] = current.metadata.name
            merged["metadata"]["namespace"] = current.metadata.namespace
            stored = serde.decode_object(merged)
            stored.metadata.uid = current.metadata.uid
            stored.metadata.creation_timestamp = current.metadata.creation_timestamp
            stored.metadata.deletion_timestamp = current.metadata.deletion_timestamp
            if admit is not None and subresource is None:
                admit(stored)  # raises -> nothing committed
            if (
                stored.metadata.deletion_timestamp is not None
                and not stored.metadata.finalizers
            ):
                # stripping the last finalizer via PATCH completes the
                # delete, exactly like update()
                self._commit(EventType.DELETED, stored, apply=lambda: bucket.pop(k))
                return copy.deepcopy(stored)
            self._commit(
                EventType.MODIFIED, stored, apply=lambda: bucket.__setitem__(k, stored)
            )
            return copy.deepcopy(stored)

    def delete(self, kind: str, namespace: str, name: str) -> Any:
        """Finalizer-aware delete (k8s-operator.md:36-43): with finalizers
        present only ``deletion_timestamp`` is set; otherwise remove."""
        with self._kind_lock(kind):
            bucket = self._bucket(kind)
            k = _key(namespace, name)
            if k not in bucket:
                raise NotFound(f"{kind} {k} not found")
            current = bucket[k]
            if current.metadata.finalizers:
                if current.metadata.deletion_timestamp is None:
                    marked = copy.deepcopy(current)  # thaws the frozen current
                    marked.metadata.deletion_timestamp = time.time()
                    self._commit(
                        EventType.MODIFIED, marked,
                        apply=lambda: bucket.__setitem__(k, marked),
                    )
                    return copy.deepcopy(marked)
                return copy.deepcopy(current)
            removed = copy.deepcopy(current)  # thaws the frozen current
            self._commit(EventType.DELETED, removed, apply=lambda: bucket.pop(k))
            return copy.deepcopy(removed)

    # -- watch --------------------------------------------------------------

    def watch(
        self,
        kind: str,
        since_rv: Optional[int] = None,
        queue_limit: Optional[int] = None,
    ) -> Watch:
        """Open an event stream for ``kind``. With ``since_rv``, replay
        buffered events with rv > since_rv first; raise :class:`Gone` if the
        buffer no longer reaches back that far. Delivered event objects are
        the shared frozen stored instances (WatchEvent docstring);
        ``queue_limit`` overrides the store's per-watcher pending bound."""
        with self._kind_lock(kind), self._lock:
            w = Watch(
                queue_limit=self._watch_queue_limit
                if queue_limit is None
                else queue_limit
            )
            if since_rv is not None and since_rv < self._last_rv:
                oldest_buffered = self._history[0][0] if self._history else None
                # Unreplayable when the bookmark predates the compaction
                # floor (_base_rv: events folded into the snapshot before
                # this process started) or fell off the history ring — the
                # client must relist (410), the same contract as a
                # compacted etcd. An empty ring above the floor is NOT
                # Gone: the only missing events are commits still
                # mid-flight, and this watcher (registered under the
                # commit lock) receives them at their fanout.
                if since_rv < self._base_rv or (
                    oldest_buffered is not None and since_rv < oldest_buffered - 1
                ):
                    raise Gone(
                        f"resource_version {since_rv} is too old "
                        f"(oldest buffered: {oldest_buffered})"
                    )
                for rv, ev in self._history:
                    if rv > since_rv and ev.object.kind == kind:
                        w._push(WatchEvent(ev.type, ev.object))
            self._watchers.append((kind, w))
            return w

    def stop_watch(self, w: Watch) -> None:
        with self._lock:
            self._watchers = [(k, x) for k, x in self._watchers if x is not w]
        w.stop()

    @property
    def resource_version(self) -> int:
        with self._lock:
            return self._last_rv
