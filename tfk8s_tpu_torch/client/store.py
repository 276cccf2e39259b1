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

The reference's durable journal (``journal_dir``: a write-ahead log and
snapshots) serves its HTTP apiserver and comes with the port's (ROADMAP
item 19); this store lives and dies with its process.

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
short store-wide commit lock orders rv assignment, history, and watch
fanout.
"""

from __future__ import annotations

import copy
import enum
import itertools
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass
from typing import Any, Deque, Dict, Iterator, List, Optional, Tuple

from tfk8s_tpu_torch.api.frozen import FrozenObjectError, freeze, thaw  # noqa: F401


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


class ClusterStore:
    """Thread-safe object store keyed by (kind, namespace/name).

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
        metrics=None,
        watch_queue_limit: int = DEFAULT_WATCH_QUEUE,
    ) -> None:
        # Store-wide commit lock: rv sequence, history ring, watcher
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
        self._metrics = metrics
        self._watch_queue_limit = watch_queue_limit
        if metrics is not None:
            metrics.describe(
                "tfk8s_watch_coalesced_total",
                "Watch events merged into a slow watcher's pending "
                "backlog (latest state wins) instead of delivered "
                "individually.",
            )

    def _kind_lock(self, kind: str) -> threading.RLock:
        lock = self._kind_locks.get(kind)
        if lock is None:
            with self._lock:
                lock = self._kind_locks.setdefault(kind, threading.RLock())
        return lock

    # -- internals ----------------------------------------------------------

    def _bump(self) -> int:
        self._last_rv = next(self._rv)
        return self._last_rv

    def _insert_history(self, rv: int, ev: WatchEvent) -> None:
        """Keep the replay ring rv-ascending. Commits of DIFFERENT kinds
        can reach the apply step out of rv order (rv assignment and apply
        are separate commit-lock sections, with the kind-parallel freeze
        between them); a short bubble from the tail restores order.
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
        shares the frozen instance; only the kind lock is held), then
        apply the bucket mutation + history + watch fanout (commit lock
        again). Returns the frozen stored object."""
        with self._lock:
            stored.metadata.resource_version = self._bump()
        frozen_obj = freeze(stored)
        with self._lock:
            apply()
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
                # Unreplayable when the bookmark fell off the history ring
                # — the client must relist (410), the same contract as a
                # compacted etcd. An empty ring is NOT Gone: the only
                # missing events are commits still mid-flight, and this
                # watcher (registered under the commit lock) receives them
                # at their fanout.
                if oldest_buffered is not None and since_rv < oldest_buffered - 1:
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
