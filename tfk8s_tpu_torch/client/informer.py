"""Shared informer machinery — SURVEY.md C13.

The architecture is the reference's exactly (images/informer1.png at
k8s-operator.md:60): a **Reflector** List/Watches the (fake) apiserver,
feeds a local **indexed store**, and dispatches OnAdd/OnUpdate/OnDelete
callbacks from which controllers enqueue keys. Reads during reconcile hit
the local store, never the server (k8s-operator.md:160).

Protocol details carried over:

- List-then-Watch from the returned resource_version; on a ``Gone`` (410)
  the reflector **relists** and the store ``replace()`` computes the diff —
  items that vanished during the gap are delivered as deletions with the
  last-known state (the DeletedFinalStateUnknown path,
  k8s-operator.md:162-164 'deleted-object handling').
- ``wait_for_cache_sync`` blocks until the initial list has been replayed
  into handlers (cache.WaitForCacheSync, k8s-operator.md:192).
- Optional periodic **resync** re-delivers OnUpdate for every cached object
  — the level-triggered safety net.

Copy-on-write (client-go's shared-informer discipline, enforced by
``api/frozen.py``): the indexer stores FROZEN objects and every read —
``get_by_key``, ``list``, handler dispatch — returns the shared frozen
instance by reference. Handlers and lister consumers must treat objects
as read-only (mutation raises ``FrozenObjectError``); a consumer that
needs a mutable view thaws its own copy. Objects arriving from a local
:class:`~tfk8s_tpu_torch.client.store.ClusterStore` are already frozen (no-op);
objects decoded off a remote watch are frozen once on cache admission.

The reflector consumes the watch in BATCHES (``Watch.next_batch``) and
coalesces per object key before touching the cache: N rapid pod updates
for one job collapse into one cache apply + one handler dispatch (one
workqueue add) instead of N — the burst behavior that kept the
workqueue's mean depth pinned at ~54 in the pre-COW bench.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from tfk8s_tpu_torch.api.frozen import freeze
from tfk8s_tpu_torch.client.store import EventType, Gone, WatchEvent
from tfk8s_tpu_torch.utils.logging import get_logger

log = get_logger("informer")

# how many queued watch events one reflector wakeup drains at most
_BATCH_MAX = 256


def meta_namespace_key(obj: Any) -> str:
    """MetaNamespaceKeyFunc: ``namespace/name``."""
    return obj.metadata.key


@dataclasses.dataclass
class DeletedFinalStateUnknown:
    """Wrapper delivered to OnDelete when the deletion was observed via a
    relist gap rather than a watch event (cache.DeletionHandlingMeta-
    NamespaceKeyFunc's reason to exist, k8s-operator.md:132-139)."""

    key: str
    obj: Any


def deletion_handling_key(obj: Any) -> str:
    if isinstance(obj, DeletedFinalStateUnknown):
        return obj.key
    return meta_namespace_key(obj)


class Indexer:
    """Thread-safe keyed cache with a namespace index — the informer's local
    store (``GetByKey`` read path, k8s-operator.md:160). Stores frozen
    objects and shares them by reference on every read (module
    docstring): a cache hit costs a dict lookup, never a deep copy."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._items: Dict[str, Any] = {}

    def get_by_key(self, key: str) -> Optional[Any]:
        with self._lock:
            return self._items.get(key)

    def list(self, namespace: Optional[str] = None) -> List[Any]:
        with self._lock:
            return [
                o
                for o in self._items.values()
                if namespace is None or o.metadata.namespace == namespace
            ]

    def keys(self) -> List[str]:
        with self._lock:
            return list(self._items)

    def add(self, obj: Any) -> None:
        with self._lock:
            self._items[meta_namespace_key(obj)] = freeze(obj)

    def delete(self, key: str) -> None:
        with self._lock:
            self._items.pop(key, None)

    def replace(self, objs: List[Any]) -> List[Any]:
        """Atomically swap contents; returns the displaced objects that are
        absent from the new set (for DeletedFinalStateUnknown delivery)."""
        with self._lock:
            new = {meta_namespace_key(o): freeze(o) for o in objs}
            gone = [o for k, o in self._items.items() if k not in new]
            self._items = new
            return gone


@dataclasses.dataclass
class ResourceEventHandler:
    """OnAdd/OnUpdate/OnDelete callback set (k8s-operator.md:121-128).
    Handlers receive the SHARED frozen cached objects — read-only."""

    on_add: Optional[Callable[[Any], None]] = None
    on_update: Optional[Callable[[Any, Any], None]] = None
    on_delete: Optional[Callable[[Any], None]] = None


class SharedIndexInformer:
    """Reflector + indexer + handler dispatch for one kind."""

    def __init__(
        self, client, resync_period: float = 0.0, name: str = "", metrics=None
    ):
        """``client`` is a TypedClient-shaped object with ``list()`` and
        ``watch(since_rv)`` — the ListWatch pair (k8s-operator.md:110-118).
        With a ``metrics`` registry the informer counts delivered deltas
        by type, per-key coalesced deltas, resync sweeps, and relists,
        labeled ``{informer="<name>"}`` — a relist storm or resync flood
        shows up on /metrics instead of only in latency."""
        self._client = client
        self._resync_period = resync_period
        self.name = name or getattr(client, "kind", "informer")
        self._metrics = metrics
        if metrics is not None:
            metrics.describe(
                "informer.deltas_total",
                "Watch/list deltas delivered to handlers, by type.",
            )
            metrics.describe(
                "informer.coalesced_deltas_total",
                "Same-key watch events collapsed into one cache apply + "
                "one dispatch by reflector batching.",
            )
            metrics.describe(
                "informer.resyncs_total",
                "Periodic resync sweeps re-delivering the cached set.",
            )
            metrics.describe(
                "informer.relists_total",
                "Full relists (initial sync, 410 Gone, error recovery).",
            )
        self.indexer = Indexer()
        self._handlers: List[ResourceEventHandler] = []
        self._synced = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._stop: Optional[threading.Event] = None
        self._watch = None
        self._lock = threading.Lock()

    # -- public api ---------------------------------------------------------

    def add_event_handler(self, handler: ResourceEventHandler) -> None:
        with self._lock:
            self._handlers.append(handler)

    @property
    def has_synced(self) -> bool:
        return self._synced.is_set()

    def run(self, stop: threading.Event) -> None:
        """Start the reflector loop in its own thread (the ``go
        informer.Run(stopCh)`` of k8s-operator.md:189)."""
        self._stop = stop
        self._thread = threading.Thread(
            target=self._reflector_loop, name=f"reflector-{self.name}", daemon=True
        )
        self._thread.start()

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            # unblock a pending watch read
            if self._watch is not None:
                self._watch.stop()
            self._thread.join(timeout)

    # -- handler dispatch ---------------------------------------------------

    def _count_delta(self, delta_type: str) -> None:
        if self._metrics is not None:
            self._metrics.inc(
                "informer.deltas_total", 1.0,
                {"informer": self.name, "type": delta_type},
            )

    def _dispatch_add(self, obj: Any) -> None:
        self._count_delta("add")
        for h in list(self._handlers):
            if h.on_add:
                self._guard(h.on_add, obj)

    def _dispatch_update(self, old: Any, new: Any) -> None:
        self._count_delta("update")
        for h in list(self._handlers):
            if h.on_update:
                self._guard(h.on_update, old, new)

    def _dispatch_delete(self, obj: Any) -> None:
        self._count_delta("delete")
        for h in list(self._handlers):
            if h.on_delete:
                self._guard(h.on_delete, obj)

    def _guard(self, fn, *args) -> None:
        # A handler exception must not kill the reflector (which would force
        # a relist storm); handlers are not this thread's code.
        try:
            fn(*args)
        except Exception:  # noqa: BLE001
            log.exception("%s: event handler raised", self.name)

    # -- reflector ----------------------------------------------------------

    def _list_and_sync(self) -> int:
        """Initial (or recovery) List: replace the cache, emit synthetic
        events for the diff, return the rv to watch from. Objects already
        cached are delivered as updates (old, new) — not as adds — so
        update filters keep working across relists; objects that vanished
        during a watch gap are delivered as DeletedFinalStateUnknown."""
        if self._metrics is not None:
            self._metrics.inc(
                "informer.relists_total", 1.0, {"informer": self.name}
            )
        items, rv = self._client.list()
        old_objs = {k: self.indexer.get_by_key(k) for k in self.indexer.keys()}
        displaced = self.indexer.replace(items)
        for obj in displaced:
            self._dispatch_delete(DeletedFinalStateUnknown(meta_namespace_key(obj), obj))
        # dispatch the frozen CACHED instances, not the raw list items —
        # one freeze on admission, shared everywhere after
        for obj in items:
            key = meta_namespace_key(obj)
            cached = self.indexer.get_by_key(key)
            old = old_objs.get(key)
            if old is None:
                self._dispatch_add(cached)
            else:
                self._dispatch_update(old, cached)
        return rv

    def _reflector_loop(self) -> None:
        assert self._stop is not None
        backoff = 0.05
        rv: Optional[int] = None
        last_resync = time.monotonic()
        while not self._stop.is_set():
            try:
                if rv is None:
                    rv = self._list_and_sync()
                    self._synced.set()
                try:
                    self._watch = self._client.watch(since_rv=rv)
                except Gone:
                    log.info("%s: watch rv %s too old; relisting", self.name, rv)
                    rv = None
                    continue
                backoff = 0.05
                while not self._stop.is_set():
                    evs = self._watch.next_batch(_BATCH_MAX, timeout=0.2)
                    if not evs:
                        if self._watch._stopped:  # server closed the stream
                            break
                        if (
                            self._resync_period
                            and time.monotonic() - last_resync > self._resync_period
                        ):
                            last_resync = time.monotonic()
                            if self._metrics is not None:
                                self._metrics.inc(
                                    "informer.resyncs_total", 1.0,
                                    {"informer": self.name},
                                )
                            for obj in self.indexer.list():
                                self._dispatch_update(obj, obj)
                        continue
                    rv = max(
                        rv or 0,
                        max(ev.object.metadata.resource_version for ev in evs),
                    )
                    self._handle_batch(evs)
            except Exception:  # noqa: BLE001 — reflector must survive anything
                log.exception("%s: reflector error; backing off %.2fs", self.name, backoff)
                self._stop.wait(backoff)
                backoff = min(backoff * 2, 5.0)
                rv = None  # full relist on recovery
            finally:
                if self._watch is not None:
                    self._watch.stop()
                    self._watch = None

    def _handle_batch(self, evs: List[WatchEvent]) -> None:
        """Per-key delta coalescing: within one drained batch a newer
        event for a key SUPERSEDES its older pending one — N rapid status
        updates for one pod become one cache apply + one handler pass
        (one workqueue add downstream). A DELETED is a barrier in both
        directions of a recreate: a delete is never superseded by the
        re-ADD that follows it (consumers' delete paths do real work —
        the kubelet stops the old pod's runner on delete, and the uid
        changes across the gap), so delete+recreate dispatches BOTH.
        Ordering follows each surviving event's position, with superseded
        keys moving to their last occurrence — causal order of what is
        actually delivered is preserved."""
        if len(evs) == 1:
            self._handle_event(evs[0])
            return
        out: List[Optional[WatchEvent]] = []
        last_idx: Dict[str, int] = {}
        coalesced = 0
        for ev in evs:
            key = meta_namespace_key(ev.object)
            idx = last_idx.get(key)
            if idx is not None and out[idx] is not None and (
                out[idx].type != EventType.DELETED
            ):
                out[idx] = None  # superseded by the newer event
                coalesced += 1
            out.append(ev)
            last_idx[key] = len(out) - 1
        if coalesced and self._metrics is not None:
            self._metrics.inc(
                "informer.coalesced_deltas_total", float(coalesced),
                {"informer": self.name},
            )
        for ev in out:
            if ev is not None:
                self._handle_event(ev)

    def _handle_event(self, ev) -> None:
        key = meta_namespace_key(ev.object)
        if ev.type == EventType.ADDED:
            old = self.indexer.get_by_key(key)
            self.indexer.add(ev.object)
            if old is None:
                self._dispatch_add(ev.object)
            else:  # replayed ADD for an object we already have
                self._dispatch_update(old, ev.object)
        elif ev.type == EventType.MODIFIED:
            old = self.indexer.get_by_key(key)
            self.indexer.add(ev.object)
            if old is None:
                # a coalesced ADD+MODIFY (or a modify for an object the
                # cache never saw): the consumer-visible delta is an add
                self._dispatch_add(ev.object)
            else:
                self._dispatch_update(old, ev.object)
        elif ev.type == EventType.DELETED:
            self.indexer.delete(key)
            self._dispatch_delete(ev.object)


def wait_for_cache_sync(
    stop: threading.Event, *informers: SharedIndexInformer, timeout: float = 30.0
) -> bool:
    """Block until every informer has replayed its initial List
    (cache.WaitForCacheSync, k8s-operator.md:192)."""
    deadline = time.monotonic() + timeout
    for inf in informers:
        remaining = deadline - time.monotonic()
        if remaining <= 0 or stop.is_set():
            return False
        if not inf._synced.wait(remaining):
            return False
    return True
