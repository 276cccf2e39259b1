"""Typed, rate-limited clients — the L2 clientset.

Mirrors the reference's generated client stack (SURVEY.md C10/C11):
``Clientset.NewForConfig`` installs a token-bucket rate limiter and hands
out per-group typed clients (images/tf4.PNG); each typed client is built
from config defaults — group/version, API path, codec, user agent — then a
REST client (``setConfigDefaults`` → ``rest.RESTClientFor``, images/tf5.PNG
/ tf6.PNG). Here the transport is the in-memory :class:`ClusterStore`
(process-local today; the seam where a real apiserver transport would slot
in), but the client surface — create/get/list/update/update_status/delete/
watch per kind, every call metered — is the same contract the reference
says must be implemented per resource (k8s-operator.md:228).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from tfk8s_tpu_torch import API_VERSION, GROUP, VERSION
from tfk8s_tpu_torch.api.frozen import thaw
from tfk8s_tpu_torch.client.ratelimit import TokenBucketRateLimiter
from tfk8s_tpu_torch.client.store import AlreadyExists, ClusterStore, Watch


@dataclasses.dataclass
class RESTConfig:
    """Client configuration (the rest.Config analogue, images/tf6.PNG)."""

    qps: float = 50.0
    burst: int = 100
    user_agent: str = "tfk8s-tpu-operator"
    api_path: str = "/apis"
    group_version: str = API_VERSION


class TypedClient:
    """CRUD + watch for one kind in one namespace (the
    ``typed/tensorflow/v1alpha1/tfjob.go`` analogue, SURVEY.md C11)."""

    def __init__(
        self,
        store: ClusterStore,
        kind: str,
        namespace: Optional[str],
        limiter: TokenBucketRateLimiter,
    ):
        self._store = store
        self.kind = kind
        self.namespace = namespace
        self._limiter = limiter

    def _ns(self, obj: Any = None) -> str:
        if self.namespace is not None:
            return self.namespace
        if obj is not None:
            return obj.metadata.namespace
        return "default"

    def create(self, obj: Any) -> Any:
        self._limiter.accept()
        return self._do_create(obj)

    def _do_create(self, obj: Any) -> Any:
        """The unmetered create body — ``create``/``create_many`` meter
        around it; the recording fake overrides it to keep per-object
        action records and reactors working under batching."""
        if self.namespace is not None:
            obj.metadata.namespace = self.namespace
        return self._store.create(obj)

    def create_many(self, objs: List[Any]) -> List[Any]:
        """Create a batch under ONE rate-limiter acquire (a single
        reservation of ``len(objs)`` tokens — one sleep instead of one
        per object; the gang-pod creation path). AlreadyExists is
        skipped per object (idempotent, level-triggered create — the
        caller recomputes desired state next sync anyway). Returns the
        objects actually created."""
        if not objs:
            return []
        self._limiter.accept(len(objs))
        created: List[Any] = []
        for obj in objs:
            try:
                created.append(self._do_create(obj))
            except AlreadyExists:
                continue
        return created

    def get(self, name: str) -> Any:
        """Read one object. Returns a PRIVATE MUTABLE copy (copy-on-read
        at the client boundary): the store's frozen shared instance is
        thawed here, because typed-client readers are exactly the
        mutating clients — the kubelet's read-modify-write status loop,
        the event recorder's aggregation. Zero-copy shared reads are the
        lister/informer path."""
        self._limiter.accept()
        return thaw(self._store.get(self.kind, self._ns(), name))

    def list(self, label_selector: Optional[Dict[str, str]] = None) -> Tuple[List[Any], int]:
        """List (items, rv). Items from a local store are the SHARED
        frozen instances — read-only; thaw() any you need to edit."""
        self._limiter.accept()
        return self._store.list(self.kind, self.namespace, label_selector)

    def update(self, obj: Any) -> Any:
        self._limiter.accept()
        return self._store.update(obj)

    def update_status(self, obj: Any) -> Any:
        """Status-subresource write: only ``obj.status`` is applied, under
        the same optimistic-concurrency rules as update (over the wire
        this is the ``PUT .../{name}/status`` route)."""
        self._limiter.accept()
        return self._store.update_status(obj)

    def patch(self, name: str, patch: Dict[str, Any]) -> Any:
        """JSON merge-patch (wire-form keys): write only the fields you
        own; no resourceVersion needed, so concurrent writers touching
        disjoint fields never conflict (over the wire: ``PATCH
        .../{name}`` with application/merge-patch+json)."""
        self._limiter.accept()
        return self._store.patch(self.kind, self._ns(), name, patch)

    def patch_status(self, name: str, patch: Dict[str, Any]) -> Any:
        """Merge-patch confined to ``status`` (``PATCH .../{name}/status``).
        ``patch`` may be the full wire object or just ``{"status": ...}``;
        only its status applies."""
        self._limiter.accept()
        return self._store.patch(
            self.kind, self._ns(), name, patch, subresource="status"
        )

    def delete(self, name: str) -> Any:
        self._limiter.accept()
        return self._store.delete(self.kind, self._ns(), name)

    def watch(self, since_rv: Optional[int] = None) -> Watch:
        # Watches are long-lived streams, not discrete requests: one token
        # to open, none per event.
        self._limiter.accept()
        return self._store.watch(self.kind, since_rv)


class Clientset:
    """Per-kind typed clients sharing one rate limiter, built from a config
    — ``NewForConfig`` parity (images/tf4.PNG)."""

    def __init__(self, store: ClusterStore, config: Optional[RESTConfig] = None):
        self.config = config or RESTConfig()
        self._store = store
        self._limiter = TokenBucketRateLimiter(self.config.qps, self.config.burst)

    @classmethod
    def new_for_config(cls, store: ClusterStore, config: Optional[RESTConfig] = None) -> "Clientset":
        return cls(store, config)

    def tpujobs(self, namespace: Optional[str] = "default") -> TypedClient:
        return TypedClient(self._store, "TPUJob", namespace, self._limiter)

    def tpuserves(self, namespace: Optional[str] = "default") -> TypedClient:
        return TypedClient(self._store, "TPUServe", namespace, self._limiter)

    def pods(self, namespace: Optional[str] = "default") -> TypedClient:
        return TypedClient(self._store, "Pod", namespace, self._limiter)

    def services(self, namespace: Optional[str] = "default") -> TypedClient:
        return TypedClient(self._store, "Service", namespace, self._limiter)

    def generic(self, kind: str, namespace: Optional[str] = "default") -> TypedClient:
        return TypedClient(self._store, kind, namespace, self._limiter)

    def discovery(self) -> Dict[str, Any]:
        """Served group/version info (DiscoveryClient parity, images/tf4.PNG)."""
        return {
            "group": GROUP,
            "version": VERSION,
            "api_path": self.config.api_path,
            "kinds": ["TPUJob", "TPUServe", "Pod", "Service"],
        }
