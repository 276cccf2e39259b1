"""Fake clientset — the test double of the L2 clients (SURVEY.md C12).

Like the reference's ``clientset/versioned/fake`` package, this serves CRUD
+ watch from an in-memory tracker and **records every action** so tests
assert on what the controller *did* (create/update/delete verbs) rather
than on cluster state alone — the exact hermetic-test shape of SURVEY.md §4.
Reactors let tests inject failures (conflicts, transient errors) to drive
the controller's retry paths.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from tfk8s_tpu_torch.client.clientset import Clientset, RESTConfig, TypedClient
from tfk8s_tpu_torch.client.store import ClusterStore, Watch


@dataclasses.dataclass
class Action:
    verb: str  # create | get | list | update | update_status | delete | watch
    kind: str
    namespace: str
    name: str = ""


# A reactor receives the Action and may raise, or return (handled, result).
Reactor = Callable[[Action, Any], Tuple[bool, Any]]


class _RecordingClient(TypedClient):
    def __init__(self, parent: "FakeClientset", *args, **kw):
        super().__init__(*args, **kw)
        self._parent = parent

    def _react(self, action: Action, obj: Any = None):
        return self._parent._dispatch(action, obj)

    def _do_create(self, obj: Any) -> Any:
        # Overriding the unmetered body (not create itself) keeps
        # per-object action records and reactors working when the
        # controller batches a gang through create_many.
        a = Action("create", self.kind, self._ns(obj), obj.metadata.name)
        handled, result = self._react(a, obj)
        if handled:
            return result
        if obj.kind == "TPUJob":
            # admission parity with the real apiserver (_admit): defaults
            # are applied by the API machinery before persisting, so the
            # STORED object carries them — controllers must not need a
            # whole-object write to make defaults durable. (Validation is
            # deliberately skipped: tests create odd specs on purpose.)
            from tfk8s_tpu_torch.api import set_defaults

            set_defaults(obj)
        elif obj.kind == "TPUServe":
            from tfk8s_tpu_torch.api import set_serve_defaults

            set_serve_defaults(obj)
        return super()._do_create(obj)

    def get(self, name: str) -> Any:
        a = Action("get", self.kind, self._ns(), name)
        handled, result = self._react(a)
        return result if handled else super().get(name)

    def list(self, label_selector: Optional[Dict[str, str]] = None):
        a = Action("list", self.kind, self.namespace or "*")
        handled, result = self._react(a)
        return result if handled else super().list(label_selector)

    def update(self, obj: Any) -> Any:
        a = Action("update", self.kind, self._ns(obj), obj.metadata.name)
        handled, result = self._react(a, obj)
        return result if handled else super().update(obj)

    def update_status(self, obj: Any) -> Any:
        a = Action("update_status", self.kind, self._ns(obj), obj.metadata.name)
        handled, result = self._react(a, obj)
        return result if handled else super().update_status(obj)

    def patch(self, name: str, patch) -> Any:
        a = Action("patch", self.kind, self._ns(), name)
        handled, result = self._react(a, patch)
        return result if handled else super().patch(name, patch)

    def patch_status(self, name: str, patch) -> Any:
        a = Action("patch_status", self.kind, self._ns(), name)
        handled, result = self._react(a, patch)
        return result if handled else super().patch_status(name, patch)

    def delete(self, name: str) -> Any:
        a = Action("delete", self.kind, self._ns(), name)
        handled, result = self._react(a)
        return result if handled else super().delete(name)

    def watch(self, since_rv: Optional[int] = None) -> Watch:
        a = Action("watch", self.kind, self.namespace or "*")
        self._react(a)
        return super().watch(since_rv)


class FakeClientset(Clientset):
    """Clientset over a private store, with action recording + reactors."""

    def __init__(self, store: Optional[ClusterStore] = None):
        # Generous limits: fakes shouldn't slow tests down.
        super().__init__(store or ClusterStore(), RESTConfig(qps=1e6, burst=1_000_000))
        self._actions: List[Action] = []
        self._reactors: List[Tuple[str, str, Reactor]] = []
        self._lock = threading.Lock()

    @property
    def store(self) -> ClusterStore:
        return self._store

    def _dispatch(self, action: Action, obj: Any) -> Tuple[bool, Any]:
        with self._lock:
            self._actions.append(action)
            reactors = list(self._reactors)
        for verb, kind, fn in reactors:
            if verb in ("*", action.verb) and kind in ("*", action.kind):
                handled, result = fn(action, obj)
                if handled:
                    return True, result
        return False, None

    def prepend_reactor(self, verb: str, kind: str, fn: Reactor) -> None:
        with self._lock:
            self._reactors.insert(0, (verb, kind, fn))

    def actions(self, verb: Optional[str] = None, kind: Optional[str] = None) -> List[Action]:
        with self._lock:
            return [
                a
                for a in self._actions
                if (verb is None or a.verb == verb) and (kind is None or a.kind == kind)
            ]

    def clear_actions(self) -> None:
        with self._lock:
            self._actions.clear()

    def _client(self, kind: str, namespace: Optional[str]) -> _RecordingClient:
        return _RecordingClient(self, self._store, kind, namespace, self._limiter)

    def tpujobs(self, namespace: Optional[str] = "default"):
        return self._client("TPUJob", namespace)

    def tpuserves(self, namespace: Optional[str] = "default"):
        return self._client("TPUServe", namespace)

    def pods(self, namespace: Optional[str] = "default"):
        return self._client("Pod", namespace)

    def services(self, namespace: Optional[str] = "default"):
        return self._client("Service", namespace)

    def generic(self, kind: str, namespace: Optional[str] = "default"):
        return self._client(kind, namespace)
