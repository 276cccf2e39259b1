"""Gateway cache directory: route on actual cache contents.

Prefix-affinity routing (gateway/affinity.py) GUESSES which replica
holds a prefix warm — the consistent hash sends same-prefix traffic to
the same place, so the guess is usually right, but it is blind to what
replicas actually cached (scale-ups remap the ring, evictions drop
entries, disagg imports warm replicas the ring never chose). The
directory closes that loop: each replica periodically reports the
digest keys resident in its device cache plus the affinity keys of its
host-tier entries (the /debug/routes hit/miss plumbing generalized
into a digest-summary report, ``DecodeLoopExecutor.kv_digest_report``),
and the gateway consults :meth:`CacheDirectory.lookup` before the ring
walk — a fresh directory hit overrides the consistent-hash guess.

Staleness is bounded, not prevented: a report older than ``ttl_s`` is
ignored (the replica may have evicted, drained, or died since), and
even a FRESH entry can be wrong by one eviction. That is safe by
construction — the route override only changes WHERE the request
lands; a replica that turns out cold just runs a plain prefill, and a
peer fetch that fails mid-flight degrades the same way. A wrong
directory entry costs a fallback prefill, never a failed request.

Plain data under the gateway's state lock; the injected clock keeps it
deterministic in tests (seeded-determinism lint scope).

A copy of the JAX package's ``runtime/kvtier/directory.py``.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

#: default report freshness bound — older reports are routing noise
#: (TPUServe ``kvTier.directoryTtlS`` overrides per serve)
DIRECTORY_STALE_S = 5.0


class _Report:
    __slots__ = ("digests", "host", "prefix_cache", "stamp")

    def __init__(self, digests: frozenset, host: Dict[str, int],
                 prefix_cache: Dict[str, Any], stamp: float):
        self.digests = digests
        self.host = host
        self.prefix_cache = prefix_cache
        self.stamp = stamp


class CacheDirectory:
    """Per-serve aggregate of replica digest reports."""

    def __init__(self, ttl_s: float = DIRECTORY_STALE_S,
                 clock: Callable[[], float] = time.monotonic):
        if ttl_s <= 0:
            raise ValueError(f"ttl_s must be > 0, got {ttl_s}")
        self.ttl_s = ttl_s
        self._clock = clock
        self._replicas: Dict[str, _Report] = {}
        self._last_poll = float("-inf")
        self.hits = 0
        self.misses = 0
        self.stale = 0

    # -- report ingestion ---------------------------------------------------

    def should_poll(self) -> bool:
        """Rate-limit report collection to twice per TTL — fresh enough
        that entries outlive their collection cadence, cheap enough that
        the dispatch path can call this inline."""
        now = self._clock()
        if now - self._last_poll < self.ttl_s / 2.0:
            return False
        self._last_poll = now
        return True

    def report(self, replica: str, report: Optional[Dict[str, Any]]) -> None:
        """Ingest one replica's digest summary (``kv_digest_report``
        shape: ``{"digests": [...], "host": {...}, "prefix_cache":
        {...}}``). ``None`` — replica gone or reporting unsupported —
        forgets it."""
        if not report:
            self._replicas.pop(replica, None)
            return
        self._replicas[replica] = _Report(
            digests=frozenset(report.get("digests", ())),
            host=dict(report.get("host") or {}),
            prefix_cache=dict(report.get("prefix_cache") or {}),
            stamp=self._clock(),
        )

    def forget(self, replica: str) -> None:
        """Drop a replica's entries (ejected/removed — its cache is no
        longer reachable, so advertising it would only buy fallbacks)."""
        self._replicas.pop(replica, None)

    # -- lookup -------------------------------------------------------------

    def lookup(self, akey: str) -> Tuple[Optional[str], str]:
        """Who holds ``akey`` warm? Returns ``(owner, outcome)`` where
        outcome is ``hit`` (fresh owner found), ``stale`` (only expired
        reports claim it), or ``miss``. Ties break to the freshest
        report, then lexicographically — deterministic, so repeated
        same-prefix requests pile onto ONE warm replica instead of
        spraying."""
        now = self._clock()
        best: Optional[str] = None
        best_stamp = float("-inf")
        saw_stale = False
        for replica, rep in self._replicas.items():
            if akey not in rep.digests:
                continue
            if now - rep.stamp > self.ttl_s:
                saw_stale = True
                continue
            if best is None or rep.stamp > best_stamp or (
                rep.stamp == best_stamp and replica < best
            ):
                best, best_stamp = replica, rep.stamp
        if best is not None:
            self.hits += 1
            return best, "hit"
        if saw_stale:
            self.stale += 1
            return None, "stale"
        self.misses += 1
        return None, "miss"

    def owner_of(self, akey: str) -> Optional[str]:
        owner, _outcome = self.lookup(akey)
        return owner

    # -- introspection ------------------------------------------------------

    def describe(self) -> Dict[str, Any]:
        """/debug/routes block: per-replica digest counts, host-tier
        occupancy, report age, plus directory-level lookup counters."""
        now = self._clock()
        replicas = {}
        for replica, rep in sorted(self._replicas.items()):
            replicas[replica] = {
                "digests": len(rep.digests),
                "host": rep.host,
                "prefix_cache": rep.prefix_cache,
                "age_s": round(max(now - rep.stamp, 0.0), 3),
                "fresh": (now - rep.stamp) <= self.ttl_s,
            }
        return {
            "ttl_s": self.ttl_s,
            "replicas": replicas,
            "lookups": {
                "hit": self.hits, "miss": self.misses, "stale": self.stale,
            },
        }


__all__ = ["CacheDirectory", "DIRECTORY_STALE_S"]
