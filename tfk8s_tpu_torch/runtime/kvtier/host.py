"""Host tier: a byte-bounded LRU of serialized prefix buffers.

Sits BEHIND the device page pool. When ``PageAllocator._evict_idle``
would drop an idle cached prefix, the executor exports the chain's K/V
(``model.export_kv``) into a ``KVHandoffBuffer.prefix`` buffer and
parks the wire bytes here; a later prompt whose digest chain hits an
entry restores through the handoff-import path (``model.import_kv`` +
``PageAllocator.restore_prefix``) — the same lossless byte round trip
the disaggregation seam uses, so a restored hit is bit-identical to an
uninterrupted device hit (test-pinned in tests/test_kv_tier.py).

Capacity is BYTES (``TFK8S_KV_HOST_BYTES``), not entries: entries are
whole serialized chains of very different sizes, and host RAM is the
budgeted resource. Overflow evicts LRU-oldest first, with its own
eviction accounting (``tier="host"`` on the shared eviction counter —
the executor owns metric emission; this class just counts).

Plain Python, no locking of its own: the owning executor calls every
method under its admission lock.

A copy of the JAX package's ``runtime/kvtier/host.py`` (only the
imports changed).
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

from tfk8s_tpu_torch.runtime.handoff import HandoffError


class HostKVCache:
    """LRU map: chain-final digest -> serialized prefix buffer bytes.

    Each entry also remembers the chain's FIRST-page digest (its
    affinity key) so the cache directory can advertise host-resident
    prefixes the same way it advertises device-resident ones, and a
    sha256 of the wire bytes taken at demotion time: the buffer's own
    digest chain covers the TOKEN pages (prefix identity), not the K/V
    payload, so without this check host-RAM corruption would restore
    silently wrong K/V and the bit-identity promise would be a lie.
    A ``get`` whose bytes no longer match raises
    :class:`~tfk8s_tpu_torch.runtime.handoff.HandoffError` and drops the
    entry — the caller falls back to plain prefill.
    """

    def __init__(self, capacity_bytes: int,
                 on_evict: Optional[Callable[[str, int], None]] = None):
        if capacity_bytes < 0:
            raise ValueError(
                f"capacity_bytes must be >= 0, got {capacity_bytes}"
            )
        self.capacity_bytes = capacity_bytes
        #: final digest -> (wire bytes, affinity key, sha256-at-demote)
        #: — LRU oldest first
        self._entries: "OrderedDict[str, Tuple[bytes, str, bytes]]" = (
            OrderedDict()
        )
        self._bytes = 0
        self._on_evict = on_evict
        self.demotions = 0
        self.restores = 0
        self.evictions = 0

    # -- occupancy ----------------------------------------------------------

    @property
    def bytes_used(self) -> int:
        return self._bytes

    def __len__(self) -> int:
        return len(self._entries)

    def has(self, key: str) -> bool:
        """Membership WITHOUT touching LRU order (the demotion path asks
        before exporting; asking must not make an entry look hot)."""
        return key in self._entries

    def akeys(self) -> List[str]:
        """Affinity keys (first-page digests) of every resident entry,
        LRU-oldest first — the host half of the directory report."""
        return [akey for _wire, akey, _sum in self._entries.values()]

    def stats(self) -> Dict[str, int]:
        """Occupancy block for /debug/state and the directory report."""
        return {
            "bytes": self._bytes,
            "capacity_bytes": self.capacity_bytes,
            "cached_prefixes": len(self._entries),
            "demotions": self.demotions,
            "restores": self.restores,
            "evictions": self.evictions,
        }

    # -- demote / restore ---------------------------------------------------

    def put(self, key: str, wire: bytes, akey: str) -> bool:
        """Demote a serialized chain under its final digest. An entry
        larger than the whole budget is refused (it could only live by
        evicting everything, then immediately thrash). Returns whether
        the entry was admitted."""
        if len(wire) > self.capacity_bytes:
            return False
        old = self._entries.pop(key, None)
        if old is not None:
            self._bytes -= len(old[0])
        self._entries[key] = (wire, akey, hashlib.sha256(wire).digest())
        self._bytes += len(wire)
        self.demotions += 1
        while self._bytes > self.capacity_bytes:
            evicted_key, (evicted_wire, _akey, _sum) = self._entries.popitem(
                last=False
            )
            self._bytes -= len(evicted_wire)
            self.evictions += 1
            if self._on_evict is not None:
                self._on_evict(evicted_key, len(evicted_wire))
        return True

    def get(self, key: str) -> Optional[bytes]:
        """Wire bytes for a chain-final digest, refreshing LRU order on
        hit. The entry STAYS resident — the device copy it restores is
        itself evictable, and keeping the host copy makes the next
        demotion of the same chain a no-op. The owning executor bumps
        :attr:`restores` itself, AFTER the restore actually lands (a
        corrupt entry that fails to scatter is not a restore).

        Raises :class:`HandoffError` (and drops the entry) when the
        bytes no longer match their demotion-time checksum."""
        entry = self._entries.get(key)
        if entry is None:
            return None
        wire, _akey, checksum = entry
        if hashlib.sha256(wire).digest() != checksum:
            self.discard(key)
            raise HandoffError(
                f"host K/V entry {key[:12]} corrupted in RAM "
                "(checksum mismatch)"
            )
        self._entries.move_to_end(key)
        return wire

    def discard(self, key: str) -> None:
        """Drop an entry that failed verification on restore — a corrupt
        buffer must not be offered twice."""
        entry = self._entries.pop(key, None)
        if entry is not None:
            self._bytes -= len(entry[0])


__all__ = ["HostKVCache"]
