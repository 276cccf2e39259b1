"""Per-replica health state machine for the gateway's failure domains.

The RouteTable learns about replica failure three ways, all from stats
the dispatch loop already observes — no new probes, no sidecars:

- **consecutive transport errors** (connection refused/reset, the
  replica registry entry gone, ``ReplicaUnavailable`` off a crashed
  replica): one error makes the replica *Suspect* (still routable, but
  deprioritized), ``EJECT_AFTER_ERRORS`` in a row *Ejects* it;
- **deadline-exceeded ratio**: a replica that keeps burning callers'
  deadlines is failing even though its transport looks fine — past
  ``EJECT_DEADLINE_RATIO`` over a sliding window it ejects;
- **gray failure**: alive, correct, SLOW. A replica whose latency EWMA
  stands ``GRAY_FACTOR`` above the fleet median (minimum sample count,
  absolute floor) is ejected *before* it times callers out.

Ejected is not forever: after a cooldown the replica is **half-open** —
the circuit breaker admits at most ``PROBE_MAX_INFLIGHT`` concurrent
probe requests. A probe success closes the circuit (Healthy, cooldown
reset); a probe failure re-ejects with the cooldown doubled (capped).
This is also the re-admission path for a REPLACED replica: the serve
controller recreates a crashed pod under the same key, and the first
successful probe folds it back into the routing set.

The fleet-level decisions — the availability floor (never eject below
one routable replica) and the gray-detection median — live in
``RouteTable``, which owns the peer set. This module is the pure,
per-replica half: no clocks of its own (callers pass ``now``), no
locks, unit-testable in microseconds.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Optional

#: state names (also the ``state`` label on ejection metrics/traces)
HEALTHY = "healthy"
SUSPECT = "suspect"
EJECTED = "ejected"

#: consecutive transport errors before a replica turns Suspect / Ejected
SUSPECT_AFTER_ERRORS = 1
EJECT_AFTER_ERRORS = 3
#: sliding outcome window for the deadline-ratio detector
DEADLINE_WINDOW = 16
DEADLINE_MIN_SAMPLES = 8
EJECT_DEADLINE_RATIO = 0.5
#: gray detector: EWMA >= GRAY_FACTOR x fleet median, with guards so
#: microsecond jitter on an idle fleet can't eject anyone
GRAY_FACTOR = 3.0
GRAY_MIN_SAMPLES = 8
GRAY_FLOOR_S = 0.02
#: half-open probe schedule: first re-admission attempt after
#: EJECT_COOLDOWN_S; each failed probe doubles it up to the cap
EJECT_COOLDOWN_S = 0.5
EJECT_COOLDOWN_MAX_S = 5.0
#: circuit breaker: concurrent requests allowed into an Ejected replica
PROBE_MAX_INFLIGHT = 1
#: effective-depth penalty a Suspect replica carries in pick(). It must
#: DEPRIORITIZE, not starve: a Suspect that never gets picked again can
#: neither accumulate the consecutive errors that eject it nor the ok
#: that clears it — a corpse would hide in Suspect forever. Half an
#: in-flight request keeps it behind healthy peers at equal load while
#: routine load fluctuation still sends it the occasional verdict
#: request.
SUSPECT_DEPTH_PENALTY = 0.5


class ReplicaHealth:
    """Per-replica health bookkeeping (one per RouteTable entry)."""

    __slots__ = (
        "state", "consec_errors", "latency_ewma", "samples", "window",
        "ejected_at", "cooldown_s", "probe_inflight", "ejections",
    )

    def __init__(self) -> None:
        self.state = HEALTHY
        self.consec_errors = 0
        self.latency_ewma: Optional[float] = None
        self.samples = 0
        # 1 = deadline-exceeded outcome, 0 = anything else
        self.window: Deque[int] = deque(maxlen=DEADLINE_WINDOW)
        self.ejected_at = 0.0
        self.cooldown_s = EJECT_COOLDOWN_S
        self.probe_inflight = 0
        self.ejections = 0

    # -- outcome folding -----------------------------------------------------

    def note_ok(self, latency_s: Optional[float], alpha: float) -> None:
        """A served request: reset the failure counters, fold the
        latency EWMA. A Suspect recovers; an Ejected replica's
        successful half-open probe closes the circuit (cooldown
        reset)."""
        self.consec_errors = 0
        self.window.append(0)
        if latency_s is not None:
            self.samples += 1
            self.latency_ewma = (
                latency_s if self.latency_ewma is None
                else alpha * latency_s + (1 - alpha) * self.latency_ewma
            )
        if self.state == EJECTED:
            self.cooldown_s = EJECT_COOLDOWN_S
        self.state = HEALTHY

    def note_transport_error(self) -> Optional[str]:
        """A transport-class failure. Returns the transition the caller
        should apply (subject to its availability floor): ``"eject"``,
        ``"suspect"``, or ``"reeject"`` (a failed half-open probe —
        escalate the cooldown)."""
        self.consec_errors += 1
        self.window.append(0)
        if self.state == EJECTED:
            return "reeject"
        if self.consec_errors >= EJECT_AFTER_ERRORS:
            return "eject"
        if self.consec_errors >= SUSPECT_AFTER_ERRORS:
            return "suspect"
        return None

    def note_deadline(self) -> Optional[str]:
        """The caller's deadline died on this replica. One deadline makes
        it Suspect; a window past ``EJECT_DEADLINE_RATIO`` ejects."""
        self.window.append(1)
        if self.state == EJECTED:
            return "reeject"
        if (
            len(self.window) >= DEADLINE_MIN_SAMPLES
            and sum(self.window) / len(self.window) >= EJECT_DEADLINE_RATIO
        ):
            self.window.clear()
            return "eject"
        return "suspect"

    # -- transitions ---------------------------------------------------------

    def eject(self, now: float, escalate: bool = False) -> None:
        """Open the circuit. ``escalate`` (failed probe) doubles the
        cooldown up to the cap instead of starting fresh."""
        if escalate:
            self.cooldown_s = min(self.cooldown_s * 2, EJECT_COOLDOWN_MAX_S)
        self.state = EJECTED
        self.ejected_at = now
        self.probe_inflight = 0
        self.ejections += 1

    def routable(self, now: float) -> bool:
        """Healthy/Suspect: always. Ejected: only as a half-open probe —
        cooldown elapsed AND the probe circuit has a free slot."""
        if self.state != EJECTED:
            return True
        return (
            now - self.ejected_at >= self.cooldown_s
            and self.probe_inflight < PROBE_MAX_INFLIGHT
        )

    def depth_penalty(self) -> float:
        """Extra effective depth in pick(): Suspects are deprioritized
        (routed only when the healthy fleet is busier than the
        penalty), Healthy replicas carry none."""
        return SUSPECT_DEPTH_PENALTY if self.state == SUSPECT else 0.0


def is_gray(h: ReplicaHealth, fleet_median_s: float) -> bool:
    """The gray-failure verdict: enough samples, above the absolute
    floor, and ``GRAY_FACTOR`` beyond the fleet's median latency EWMA
    (median of the OTHER replicas — the caller computes it, so one slow
    replica can't drag the reference toward itself)."""
    return (
        h.samples >= GRAY_MIN_SAMPLES
        and h.latency_ewma is not None
        and h.latency_ewma >= GRAY_FLOOR_S
        and fleet_median_s > 0.0
        and h.latency_ewma >= GRAY_FACTOR * fleet_median_s
    )


__all__ = [
    "EJECTED",
    "EJECT_AFTER_ERRORS",
    "EJECT_COOLDOWN_MAX_S",
    "EJECT_COOLDOWN_S",
    "EJECT_DEADLINE_RATIO",
    "DEADLINE_MIN_SAMPLES",
    "DEADLINE_WINDOW",
    "GRAY_FACTOR",
    "GRAY_FLOOR_S",
    "GRAY_MIN_SAMPLES",
    "HEALTHY",
    "PROBE_MAX_INFLIGHT",
    "ReplicaHealth",
    "SUSPECT",
    "SUSPECT_AFTER_ERRORS",
    "SUSPECT_DEPTH_PENALTY",
    "is_gray",
]
