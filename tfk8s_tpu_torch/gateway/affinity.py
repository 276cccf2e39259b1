"""Prefix-affinity routing: a consistent-hash ring over the replica set.

Multi-turn sessions win when every turn lands on the replica that
already holds their history's KV pages (the per-replica prefix cache,
runtime/paging.py). The RouteTable's depth-only pick scatters turns
across the fleet and re-prefills the whole history each time; this
module adds the cache-aware layer UNDER the existing health machinery:

- the **affinity key** is the page-aligned prefix digest chain the
  replica's cache will compute for the same prompt — specifically the
  FIRST full page's digest, which is stable as a session's history
  grows (history is append-only, so page 0 never changes) and shared by
  sessions with a common system prefix, co-locating exactly the
  requests whose pages dedup. Follow-up turns carry an explicit
  ``x-tfk8s-session`` token instead (the gateway echoes the key it
  routed by; :class:`~tfk8s_tpu_torch.gateway.client.GatewayClient` sends it
  back), so a session stays pinned even where prompt hashing would
  drift.
- the **ring** (:class:`AffinityRing`) maps keys to replicas with
  ``vnodes`` points per member, so membership churn reassigns only the
  leaving member's keys (the consistent-hash property, test-pinned).
  The ring tracks MEMBERSHIP only; health and load stay the
  RouteTable's: a pick walks the ring successors and takes the first
  ROUTABLE candidate (an Ejected replica falls off the walk and its
  keys land on its successor), and spills to plain least-depth when the
  affine choice is more than ``AFFINITY_SPILL_DEPTH`` effective
  requests deeper than the least-loaded replica — cache hits are worth
  a bounded wait, never a hot spot.
- the **cache directory** (runtime/kvtier/directory.py) sits
  ABOVE the ring: when a serve carries a ``KVTierPolicy``, the gateway
  aggregates per-replica digest reports and a fresh directory hit
  overrides the consistent-hash guess — the ring predicts where a
  prefix SHOULD be, the directory knows where it IS (scale-ups remap
  the ring, evictions drop entries, disagg imports warm replicas the
  ring never chose). The override obeys its own depth bound,
  ``DIRECTORY_SPILL_DEPTH``: slightly looser than the affine bound,
  because a KNOWN warm cache saves a whole prefill while the ring's
  guess only probably does — but still bounded, for the same
  no-hot-spot reason.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Any, Dict, List, Optional, Sequence

from tfk8s_tpu_torch.runtime.paging import prefix_digest_chain

#: hash points per ring member — enough that one member's share of the
#: key space stays near 1/n with low variance at fleet sizes this
#: operator runs (single digits)
VNODES = 64
#: effective-depth gap (vs the least-loaded routable replica) past which
#: an affine pick spills to least-depth: a cache hit saves one prefill,
#: not unbounded queueing behind a hot key
AFFINITY_SPILL_DEPTH = 4.0
#: the same bound for a cache-DIRECTORY override (runtime/kvtier): a
#: confirmed-warm replica is worth a little more queueing than the
#: ring's statistical guess, but a hot prefix still must not melt one
#: replica while the rest idle
DIRECTORY_SPILL_DEPTH = 6.0


def _point(s: str) -> int:
    """A stable 64-bit ring position for a member vnode or a key."""
    return int.from_bytes(hashlib.sha256(s.encode()).digest()[:8], "big")


def affinity_key_of(tokens: Sequence[int], page_size: int) -> str:
    """The routing key for a prompt: the first FULL page's digest from
    the same chain the replica's prefix cache computes (stable across a
    session's turns; shared across sessions with a common first page).
    Prompts shorter than one full page hash whole — no cached pages to
    be affine to, but the key still pins retries of the same prompt."""
    chain = prefix_digest_chain(tokens, page_size, max(len(tokens) - 1, 0) // page_size)
    if chain:
        return chain[0]
    return hashlib.sha256(
        repr([int(t) for t in tokens]).encode()
    ).hexdigest()


class AffinityRing:
    """Consistent-hash ring over replica keys. Not thread-safe — the
    RouteTable mutates and reads it under its own lock, like every other
    routing structure."""

    def __init__(self, vnodes: int = VNODES):
        self._vnodes = max(1, int(vnodes))
        self._members: Dict[str, List[int]] = {}
        self._points: List[int] = []          # sorted vnode positions
        self._owner: Dict[int, str] = {}      # position -> member

    def __contains__(self, member: str) -> bool:
        return member in self._members

    def __len__(self) -> int:
        return len(self._members)

    def members(self) -> List[str]:
        return sorted(self._members)

    def add(self, member: str) -> None:
        if member in self._members:
            return
        pts = []
        for i in range(self._vnodes):
            p = _point(f"{member}#{i}")
            if p in self._owner:  # vanishing-probability collision
                continue
            self._owner[p] = member
            bisect.insort(self._points, p)
            pts.append(p)
        self._members[member] = pts

    def remove(self, member: str) -> None:
        for p in self._members.pop(member, []):
            del self._owner[p]
            i = bisect.bisect_left(self._points, p)
            del self._points[i]

    def candidates(self, key: str, limit: Optional[int] = None) -> List[str]:
        """Members in successor order from the key's ring position —
        the first is the owner; each later one is where the keys land
        when everything before it is unroutable. Distinct members only."""
        if not self._points:
            return []
        limit = len(self._members) if limit is None else limit
        start = bisect.bisect_right(self._points, _point(key))
        seen: List[str] = []
        for off in range(len(self._points)):
            owner = self._owner[self._points[(start + off) % len(self._points)]]
            if owner not in seen:
                seen.append(owner)
                if len(seen) >= limit:
                    break
        return seen

    def owner(self, key: str) -> Optional[str]:
        c = self.candidates(key, limit=1)
        return c[0] if c else None

    def describe(self) -> Dict[str, Any]:
        """Ownership view for ``/debug/routes``: per member, the arc
        count and the fraction of the 64-bit key space it owns."""
        span = 1 << 64
        owned: Dict[str, Dict[str, Any]] = {
            m: {"vnodes": len(pts), "owned_fraction": 0.0}
            for m, pts in self._members.items()
        }
        n = len(self._points)
        for i, p in enumerate(self._points):
            nxt = self._points[(i + 1) % n]
            arc = (nxt - p) % span or span
            # keys in (p, nxt] belong to nxt's owner
            owned[self._owner[nxt]]["owned_fraction"] += arc / span
        for info in owned.values():
            info["owned_fraction"] = round(info["owned_fraction"], 4)
        return {
            "vnodes_per_member": self._vnodes,
            "members": {m: owned[m] for m in sorted(owned)},
        }


__all__ = [
    "AFFINITY_SPILL_DEPTH",
    "DIRECTORY_SPILL_DEPTH",
    "AffinityRing",
    "VNODES",
    "affinity_key_of",
]
