"""Listers: read-only indexed access over an informer's cache — SURVEY.md
C14 (``pkg/client/listers/tensorflow/v1alpha1/tfjob.go``; the
``store.Indexer.GetByKey(key)`` read path at k8s-operator.md:160).

Results are the SHARED frozen cached instances (copy-on-write contract,
``api/frozen.py``): a lister read costs a dict lookup, and mutating a
result raises ``FrozenObjectError`` instead of corrupting the cache.
Controllers that edit an object first take a private copy (the TPUJob
controller's ``serde.roundtrip`` / ``thaw``).
"""

from __future__ import annotations

from typing import Any, List, Optional

from tfk8s_tpu_torch.client.informer import Indexer
from tfk8s_tpu_torch.client.store import NotFound, match_labels


class Lister:
    def __init__(self, indexer: Indexer, kind: str = ""):
        self._indexer = indexer
        self.kind = kind

    def get(self, namespace: str, name: str) -> Any:
        obj = self._indexer.get_by_key(f"{namespace}/{name}")
        if obj is None:
            raise NotFound(f"{self.kind} {namespace}/{name} not in cache")
        return obj

    def get_by_key(self, key: str) -> Optional[Any]:
        """Cache read; None means 'object deleted' — the branch the sample
        worker takes at k8s-operator.md:162-164."""
        return self._indexer.get_by_key(key)

    def list(
        self,
        namespace: Optional[str] = None,
        label_selector: Optional[dict] = None,
    ) -> List[Any]:
        items = self._indexer.list(namespace)
        if label_selector:
            items = [o for o in items if match_labels(label_selector, o.metadata.labels)]
        return items
