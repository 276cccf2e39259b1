"""The KV economy: tiered prefix-cache residency.

At fleet scale the shared system prompt IS the working set, but before
this subsystem a cached prefix lived and died inside one replica's
device page pool: ``PageAllocator._evict_idle`` dropped idle pages on
the floor, and a replica that missed a hot prefix re-prefilled from
scratch even when a peer held it warm. This package composes three
primitives that already existed — the content-hashed prefix cache
(runtime/paging.py), verified cross-replica page movement
(``KVHandoffBuffer``/``KVTransport``, runtime/handoff.py), and the
scheduler's spill/serialize path — into three residency tiers:

- **device** (tier 0): the page pool itself; unchanged hot path.
- **host** (tier 1, :mod:`.host`): a byte-bounded LRU of serialized
  prefix buffers behind the pool. Eviction demotes instead of drops; a
  later hit restores through the handoff-import path, bit-identical to
  an uninterrupted device hit.
- **peer** (tier 2, :mod:`.peer`): a replica that misses locally pulls
  warm pages from a peer over ``KVTransport``, digest-chain-verified,
  falling back to plain prefill on any ``HandoffError``.

The gateway side (:mod:`.directory`) aggregates per-replica digest
reports so prefix-affinity routing targets *actual* cache contents:
a directory hit overrides the consistent-hash guess, and staleness
bounds mean a wrong entry costs only a fallback prefill.

Everything here is plain Python under the executor's lock — no jax;
the executor owns the device <-> host/peer K/V movement
(``model.export_kv``/``import_kv``).

A copy of the JAX package's ``runtime/kvtier`` (pure Python; only the
imports changed), driven by the port's decode loop.
"""

from tfk8s_tpu_torch.runtime.kvtier.directory import (
    DIRECTORY_STALE_S,
    CacheDirectory,
)
from tfk8s_tpu_torch.runtime.kvtier.host import HostKVCache
from tfk8s_tpu_torch.runtime.kvtier.peer import fetch_prefix

__all__ = [
    "CacheDirectory",
    "DIRECTORY_STALE_S",
    "HostKVCache",
    "fetch_prefix",
]
