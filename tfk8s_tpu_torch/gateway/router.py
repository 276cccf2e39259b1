"""Least-queue-depth routing for the serving front door.

Replaces the client-side round-robin-over-Ready with load-aware
selection fed by the signal the replicas ALREADY publish: each model
server reports ``serving_queue_depth`` through ``runtime/progress.py``
→ kubelet flush → ``pod.status.training`` — the channel the autoscaler
consumes. The route table EMA-smooths the per-replica depth with the
autoscaler's own alpha (one smoothing constant, two consumers — the two
views of "how loaded is this replica" can never disagree on dynamics)
and corrects for publication lag by adding the requests IT has in
flight to each replica (least-outstanding-requests on top of the
published base, so a burst between kubelet flushes doesn't pile onto
the momentarily-least-loaded replica).

Replica lifecycle in the table:

- **discovery**: a clientset pod list (label selector, TTL-cached like
  ``ServeClient``) admits Ready replicas and refreshes their depth;
- **stale aging**: an entry not re-observed within ``stale_after_s``
  (vanished pod, wedged kubelet) silently leaves the routing set;
- **draining**: ``mark_draining`` removes a replica the instant its
  drain starts — the gateway subscribes to
  ``runtime.server.add_drain_hook``, which fires when the replica
  unregisters, BEFORE the kubelet would publish anything — preserving
  the zero-failed-request rollout contract on the wire path;
- **health ejection** (gateway/health.py): the dispatch loop
  feeds per-replica outcomes back through ``report_outcome`` — Healthy
  → Suspect → Ejected → half-open probe re-admit, driven by consecutive
  transport errors, the deadline-exceeded ratio, and the gray-failure
  latency detector. An UNPLANNED failure (crash, wire cut, slow box) is
  therefore discovered actively, well before passive stale aging; the
  availability floor degrades the last routable replica to
  Suspect-with-traffic instead of ejecting it.

Every removal — stale-aged, drain-purged, or discovered vanished by an
in-flight request — is counted in
``tfk8s_gateway_replica_removed_total{reason=stale|drained|ejected}``;
ejections in ``tfk8s_gateway_ejections_total{reason}``.
"""

from __future__ import annotations

import statistics
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

from tfk8s_tpu_torch.gateway import health as _health
from tfk8s_tpu_torch.gateway.affinity import (
    AFFINITY_SPILL_DEPTH,
    DIRECTORY_SPILL_DEPTH,
    AffinityRing,
)
from tfk8s_tpu_torch.obs.trace import get_tracer
from tfk8s_tpu_torch.trainer.serve_controller import EMA_ALPHA
from tfk8s_tpu_torch.utils.logging import get_logger

log = get_logger("gateway.router")

# an entry not re-observed within this window is presumed vanished
STALE_AFTER_S = 3.0
# discovery refresh cadence (matches ServeClient's endpoint cache TTL)
CACHE_TTL_S = 0.25


class _Entry:
    __slots__ = ("depth", "seen", "health")

    def __init__(self, depth: float, seen: float):
        self.depth = depth
        self.seen = seen
        self.health = _health.ReplicaHealth()


class RouteTable:
    """Load-aware route table for ONE TPUServe. ``pick`` returns the
    least-loaded routable replica key and leases an in-flight slot on
    it; ``release`` returns the slot when the dispatch finishes either
    way. ``clientset=None`` disables discovery — unit tests (and any
    out-of-band feed) drive the table through ``observe`` directly."""

    def __init__(
        self,
        clientset=None,
        name: str = "",
        namespace: str = "default",
        cache_ttl_s: float = CACHE_TTL_S,
        stale_after_s: float = STALE_AFTER_S,
        metrics=None,
        clock=time.monotonic,
        phase: str = "",
        affinity: bool = False,
    ):
        self._cs = clientset
        self.name = name
        self.namespace = namespace
        # disaggregated serves run one table per phase pool; discovery
        # then selects on the pool's phase label so prefill traffic can
        # never land on a decode replica (and vice versa)
        self.phase = phase
        # prefix-affinity: membership mirrors the entry set (added on
        # first observe, dropped with every removal), so ring state needs
        # no separate lifecycle. Guarded by self._lock like everything
        # else — AffinityRing itself is not thread-safe.
        self._ring: Optional[AffinityRing] = AffinityRing() if affinity else None
        self._cache_ttl = cache_ttl_s
        self._stale_after = stale_after_s
        self._metrics = metrics
        self._clock = clock
        self._lock = threading.Lock()
        self._entries: Dict[str, _Entry] = {}
        self._inflight: Dict[str, int] = {}
        # key -> when the drain was observed (purged once stale: by then
        # the pod is gone from every discovery source)
        self._draining: Dict[str, float] = {}
        self._last_refresh = 0.0
        # key -> clock stamp of the last pick (kept past removal: the
        # chaos bench reads kill->last-routed as ejection_time_ms)
        self._last_pick: Dict[str, float] = {}

    # -- feeds ---------------------------------------------------------------

    def observe(self, key: str, depth: float) -> None:
        """Fold one published depth sample into the table (EMA-smoothed,
        the autoscaler's alpha)."""
        now = self._clock()
        with self._lock:
            if key in self._draining:
                return
            e = self._entries.get(key)
            if e is None:
                self._entries[key] = _Entry(float(depth), now)
                if self._ring is not None:
                    self._ring.add(key)
            else:
                e.depth = EMA_ALPHA * float(depth) + (1 - EMA_ALPHA) * e.depth
                e.seen = now

    def mark_draining(self, key: str) -> None:
        """Remove a replica from the routing set at drain START (the
        in-process drain hook) — requests already dispatched to it finish
        (the replica drains its queue); nothing new routes to it."""
        now = self._clock()
        with self._lock:
            if key not in self._entries and key not in self._draining:
                return
            self._removed_locked(key, "drained")
            self._draining[key] = now

    def remove(self, key: str, reason: str = "ejected") -> None:
        """Drop a replica an in-flight request DISCOVERED gone (its
        registry entry vanished mid-dispatch) — counted in the removal
        metric so a vanished replica is visible without a debugger."""
        with self._lock:
            if key not in self._entries:
                return
            self._removed_locked(key, reason)

    def refresh(self, force: bool = False) -> None:
        """Re-discover Ready replicas and their published depths through
        the clientset (no-op within the TTL, or with no clientset)."""
        if self._cs is None:
            return
        now = self._clock()
        with self._lock:
            if not force and now - self._last_refresh < self._cache_ttl:
                return
            self._last_refresh = now
        # the list (rate-limited client call) runs OUTSIDE the table lock
        from tfk8s_tpu_torch.runtime.server import replica_is_ready
        from tfk8s_tpu_torch.trainer import labels as L

        selector = (
            L.serve_phase_selector(self.name, self.phase)
            if self.phase else L.serve_selector(self.name)
        )
        pods, _rv = self._cs.pods(self.namespace).list(label_selector=selector)
        for p in pods:
            if replica_is_ready(p):
                self.observe(
                    p.metadata.key,
                    float(p.status.training.get("serving_queue_depth", 0.0)),
                )
        self._publish_gauges()

    # -- routing -------------------------------------------------------------

    def pick(
        self,
        exclude: Optional[Set[str]] = None,
        affinity_key: Optional[str] = None,
        preferred: Optional[str] = None,
    ) -> Optional[str]:
        """Least effective depth (published EMA + local in-flight +
        Suspect penalty) among fresh, non-draining, non-excluded,
        ROUTABLE replicas; leases an in-flight slot on the winner. An
        Ejected replica is routable only as a half-open probe (cooldown
        elapsed, probe circuit open) — the pick leases its probe slot.
        None when nothing is routable.

        With ``affinity_key`` (and the ring enabled), the consistent-hash
        owner of the key wins INSTEAD of the least-loaded replica —
        unless the owner is non-routable (ejected/draining replicas fall
        off the ring walk and their keys rebalance to the successor) or
        more than ``AFFINITY_SPILL_DEPTH`` effective requests deeper than
        the fleet minimum, in which case the request spills to the
        least-depth pick (warm KV is worth a bounded queue, not an
        unbounded one).

        ``preferred`` is the cache directory's answer (runtime/kvtier):
        a replica CONFIRMED to hold the prompt's prefix warm. It
        outranks the ring's guess — route ``directory`` — under its own
        slightly looser bound (``DIRECTORY_SPILL_DEPTH``); a
        non-routable or overloaded preferred replica falls back to the
        normal ring walk, costing at most a fallback prefill."""
        self.refresh()
        now = self._clock()
        probe = False
        route: Optional[str] = None
        with self._lock:
            self._purge_locked(now)

            def eff(key: str) -> float:
                e = self._entries[key]
                return (
                    e.depth + self._inflight.get(key, 0)
                    + e.health.depth_penalty()
                )

            best: Optional[str] = None
            best_depth = 0.0
            for key in sorted(self._entries):  # sorted: deterministic ties
                if exclude and key in exclude:
                    continue
                if not self._entries[key].health.routable(now):
                    continue
                d = eff(key)
                if best is None or d < best_depth:
                    best, best_depth = key, d
            if self._ring is not None:
                route = "none"
                if affinity_key:
                    route = "spill"
                    if preferred is not None and not (
                        exclude and preferred in exclude
                    ):
                        e = self._entries.get(preferred)
                        if e is not None and e.health.routable(now):
                            d = eff(preferred)
                            if best is None or (
                                d <= best_depth + DIRECTORY_SPILL_DEPTH
                            ):
                                best, best_depth = preferred, d
                                route = "directory"
                    if route != "directory":
                        for cand in self._ring.candidates(affinity_key):
                            if exclude and cand in exclude:
                                continue
                            e = self._entries.get(cand)
                            if e is None or not e.health.routable(now):
                                continue
                            d = eff(cand)
                            if best is None or (
                                d <= best_depth + AFFINITY_SPILL_DEPTH
                            ):
                                best, best_depth = cand, d
                                route = "affine"
                            # first ROUTABLE successor decides: pin/spill
                            break
            if best is not None:
                h = self._entries[best].health
                if h.state == _health.EJECTED:
                    probe = True
                    h.probe_inflight += 1
                self._inflight[best] = self._inflight.get(best, 0) + 1
                self._last_pick[best] = now
        if best is not None:
            if route is not None and self._metrics is not None:
                self._metrics.inc(
                    "tfk8s_gateway_affinity_requests_total", 1.0,
                    {"serve": f"{self.namespace}/{self.name}", "route": route,
                     **({"phase": self.phase} if self.phase else {})},
                )
            span = get_tracer().current_span()
            if span is not None:
                span.add_event("route.pick", {
                    "replica": best, "effective_depth": best_depth,
                    **({"probe": True} if probe else {}),
                    **({"route": route} if route is not None else {}),
                })
        return best

    def release(self, key: str) -> None:
        with self._lock:
            n = self._inflight.get(key, 0)
            if n <= 1:
                self._inflight.pop(key, None)
            else:
                self._inflight[key] = n - 1
            e = self._entries.get(key)
            if e is not None and e.health.probe_inflight > 0:
                e.health.probe_inflight -= 1  # half-open probe slot back

    def report_outcome(self, key: str, outcome: str,
                       latency_s: Optional[float] = None) -> None:
        """Dispatch feedback driving the health state machine. One call
        per dispatched attempt: ``outcome`` is ``"ok"`` (with the
        replica-observed latency), ``"transport_error"`` (connection
        failed / replica vanished / crashed mid-flight) or
        ``"deadline"`` (the caller's deadline died on this replica).
        Ejections honor the availability floor: the last routable
        replica degrades to Suspect-with-traffic instead."""
        now = self._clock()
        reason: Optional[str] = None
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                return
            h = e.health
            if outcome == "ok":
                was_ejected = h.state == _health.EJECTED
                h.note_ok(latency_s, EMA_ALPHA)
                if was_ejected:
                    log.info("%s/%s: probe of %s succeeded; re-admitted",
                             self.namespace, self.name, key)
                elif (
                    _health.is_gray(h, self._fleet_median_locked(key))
                    and self._floor_allows_locked(key)
                ):
                    h.eject(now)
                    reason = "gray"
            else:
                verdict = (
                    h.note_transport_error()
                    if outcome == "transport_error" else h.note_deadline()
                )
                if verdict == "suspect":
                    h.state = _health.SUSPECT
                elif verdict == "eject":
                    if self._floor_allows_locked(key):
                        h.eject(now)
                        reason = (
                            "errors" if outcome == "transport_error"
                            else "deadline"
                        )
                    else:
                        # availability floor: never eject the last
                        # routable replica — degraded but serving beats
                        # nothing routable at all
                        h.state = _health.SUSPECT
                elif verdict == "reeject":
                    h.eject(now, escalate=True)
                    reason = "probe"
        if reason is not None:
            if self._metrics is not None:
                self._metrics.inc(
                    "tfk8s_gateway_ejections_total", 1.0,
                    {"serve": f"{self.namespace}/{self.name}",
                     "reason": reason},
                )
            span = get_tracer().current_span()
            if span is not None:
                span.add_event("replica.eject", {
                    "replica": key, "reason": reason,
                })
            log.warning("%s/%s: ejected %s (%s)",
                        self.namespace, self.name, key, reason)

    def least_depth(self) -> float:
        """The least effective depth across routable replicas (inf when
        none) — the admission layer's cluster-pressure signal."""
        self.refresh()
        now = self._clock()
        with self._lock:
            self._purge_locked(now)
            depths = [
                e.depth + self._inflight.get(k, 0)
                for k, e in self._entries.items()
                if e.health.state != _health.EJECTED
            ]
        return min(depths) if depths else float("inf")

    def targets(self) -> List[Tuple[str, float]]:
        """Routable (key, effective depth) pairs — debug/test surface
        and the gauge feed. Ejected replicas are out of the routing set
        (half-open probes aside) and don't list."""
        now = self._clock()
        with self._lock:
            self._purge_locked(now)
            return sorted(
                (k, e.depth + self._inflight.get(k, 0))
                for k, e in self._entries.items()
                if e.health.state != _health.EJECTED
            )

    def health_state(self, key: str) -> Optional[str]:
        """The replica's health state (health.HEALTHY/SUSPECT/EJECTED),
        or None when it left the table."""
        with self._lock:
            e = self._entries.get(key)
            return e.health.state if e is not None else None

    def debug_rows(self) -> List[dict]:
        """Full per-replica table dump for ``/debug/routes`` — unlike
        ``targets`` this includes Ejected entries (the interesting ones
        when debugging routing), with health state and in-flight count."""
        now = self._clock()
        with self._lock:
            self._purge_locked(now)
            return [
                {
                    "replica": k,
                    "health": e.health.state,
                    "effective_depth": round(
                        e.depth + self._inflight.get(k, 0)
                        + e.health.depth_penalty(), 3
                    ),
                    "inflight": self._inflight.get(k, 0),
                }
                for k, e in sorted(self._entries.items())
            ]

    def ring_describe(self) -> Optional[dict]:
        """The affinity ring's ownership map (None when affinity is
        off) — the ``/debug/routes`` companion to ``debug_rows``."""
        if self._ring is None:
            return None
        with self._lock:
            return self._ring.describe()

    def last_pick_s(self, key: str) -> Optional[float]:
        """Clock stamp of the LAST pick of ``key`` (kept past removal):
        kill-to-last-pick is the chaos bench's ``ejection_time_ms``."""
        with self._lock:
            return self._last_pick.get(key)

    # -- internals -----------------------------------------------------------

    def _floor_allows_locked(self, key: str) -> bool:
        """Availability floor: ejecting ``key`` must leave at least one
        routable (non-Ejected) replica."""
        return any(
            k != key and e.health.state != _health.EJECTED
            for k, e in self._entries.items()
        )

    def _fleet_median_locked(self, key: str) -> float:
        """Median latency EWMA of ``key``'s PEERS (non-ejected, with
        data) — excluding the candidate so one slow replica can't drag
        the gray-detection reference toward itself."""
        peers = [
            e.health.latency_ewma
            for k, e in self._entries.items()
            if k != key and e.health.latency_ewma is not None
            and e.health.state != _health.EJECTED
        ]
        return statistics.median(peers) if peers else 0.0

    def _removed_locked(self, key: str, reason: str) -> None:
        self._entries.pop(key, None)
        if self._ring is not None:
            self._ring.remove(key)
        if self._metrics is not None:
            self._metrics.inc(
                "tfk8s_gateway_replica_removed_total", 1.0,
                {"serve": f"{self.namespace}/{self.name}", "reason": reason},
            )
        log.debug("%s/%s: %s removed from route table (%s)",
                  self.namespace, self.name, key, reason)

    def _purge_locked(self, now: float) -> None:
        for key, e in list(self._entries.items()):
            if now - e.seen > self._stale_after:
                self._removed_locked(key, "stale")
        for key, when in list(self._draining.items()):
            if now - when > self._stale_after:
                del self._draining[key]

    def _publish_gauges(self) -> None:
        if self._metrics is None:
            return
        rows = self.targets()  # takes the lock itself; gauges set outside
        labels = {"serve": f"{self.namespace}/{self.name}"}
        if self.phase:
            labels["phase"] = self.phase
        self._metrics.set_gauge(
            "tfk8s_gateway_route_replicas", float(len(rows)), labels
        )
        self._metrics.set_gauge(
            "tfk8s_gateway_route_depth",
            min((d for _, d in rows), default=0.0), labels,
        )
        if self._ring is not None:
            with self._lock:
                members = len(self._ring)
            self._metrics.set_gauge(
                "tfk8s_gateway_affinity_ring_members", float(members), labels
            )
