"""Per-tenant admission control at the serving front door.

Each tenant (the request's ``X-Tenant`` header) gets its own
reservation-style token bucket (``client/ratelimit.py`` — the same
flowcontrol shape the clientset installs) sized by its
:class:`~tfk8s_tpu_torch.api.types.TenantQuota`, an optional in-flight
concurrency cap, and a priority class. Admission is strictly
non-blocking: a request either enters now or is shed with a typed 429
carrying the exact Retry-After — the bucket's token-accrual debt for
quota sheds, a queue-pressure heuristic for priority sheds — so shed
traffic backs off instead of re-hammering.

Priority shedding ("a full queue sheds low priority first"): each
priority class tolerates a different queue occupancy on the LEAST
loaded replica before it is turned away — priority 0 sheds once the
queue is half full, 1 at three quarters, >= 2 only when the replica
itself would shed. As pressure rises, low-priority tenants lose
admission first and the headroom they vacate keeps high-priority
latency flat; no tenant can buy more than its bucket regardless of
priority, which is what stops one abusive tenant starving the rest.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

from tfk8s_tpu_torch.api.types import TenantPolicy, TenantQuota
from tfk8s_tpu_torch.client.ratelimit import TokenBucketRateLimiter
from tfk8s_tpu_torch.obs.trace import get_tracer
from tfk8s_tpu_torch.runtime.server import Overloaded, QuotaExceeded
from tfk8s_tpu_torch.utils.logging import get_logger

log = get_logger("gateway.admission")


def shed_threshold(priority: int) -> float:
    """Queue-occupancy fraction at which a priority class is shed:
    0 -> 0.5, 1 -> 0.75, >= 2 -> 1.0 (only the replica's own bound)."""
    return min(1.0, 0.5 + 0.25 * max(priority, 0))


def _overload_retry_after(depth: float, limit: int) -> float:
    """Retry-After for a pressure shed: scaled with occupancy — a nearly
    full queue needs longer to drain below the caller's band than a
    half-full one. Heuristic by design (the true drain rate is the
    replicas' to know); 50-250 ms spans the batching executor's drain
    timescales at every benched rate."""
    frac = min(depth / limit, 1.0) if limit > 0 else 1.0
    return 0.05 + 0.2 * frac


class _TenantState:
    __slots__ = ("quota", "bucket", "inflight")

    def __init__(self, quota: TenantQuota):
        self.quota = quota
        # qps == 0 means unmetered rate (concurrency/priority still apply)
        self.bucket = (
            TokenBucketRateLimiter(quota.qps, quota.burst or 1)
            if quota.qps > 0 else None
        )
        self.inflight = 0


class TenantAdmission:
    """Admission state for ONE TPUServe: per-tenant buckets + in-flight
    counts, reconfigured in place when the spec's TenantPolicy changes
    (bucket state survives for tenants whose quota is unchanged — a
    policy edit must not hand every tenant a free full burst)."""

    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self._policy = TenantPolicy()
        self._states: Dict[str, _TenantState] = {}

    def configure(self, policy: TenantPolicy) -> None:
        with self._lock:
            if policy == self._policy:
                return
            for tenant, state in list(self._states.items()):
                want = self._quota_for_locked(policy, tenant)
                if want != state.quota:
                    fresh = _TenantState(want)
                    fresh.inflight = state.inflight  # in-flight survives
                    self._states[tenant] = fresh
            self._policy = policy
        log.info("admission policy updated: enabled=%s tenants=%d",
                 policy.enabled, len(policy.tenants))

    @staticmethod
    def _quota_for_locked(policy: TenantPolicy, tenant: str) -> TenantQuota:
        return policy.tenants.get(tenant, policy.default_quota)

    def _state(self, tenant: str) -> _TenantState:
        state = self._states.get(tenant)
        if state is None:
            state = _TenantState(self._quota_for_locked(self._policy, tenant))
            self._states[tenant] = state
        return state

    def admit(self, tenant: str, depth: float, limit: int) -> Callable[[], None]:
        """Admit ``tenant`` given the least-loaded replica's effective
        ``depth`` against its ``limit``, or raise the typed shed
        (Overloaded for pressure, QuotaExceeded for this tenant's own
        budget). Returns the release callable that ends the request's
        in-flight lease; callers MUST invoke it exactly once.

        The decision annotates the caller's ambient span (when one is
        open) with an ``admit``/``shed`` event — a shed request's trace
        shows exactly WHICH rule turned it away."""
        span = get_tracer().current_span()
        priority = 0
        # unmetered admission (policy disabled) is still an admission
        # decision — it gets the admit event, just no lease to release
        release: Callable[[], None] = self._release_noop
        try:
            with self._lock:
                if self._policy.enabled:
                    state = self._state(tenant)
                    quota = state.quota
                    priority = quota.priority
                    # pressure first (no side effects): the shed threshold
                    # for this tenant's priority class at the best replica
                    if limit > 0 and depth >= limit * shed_threshold(quota.priority):
                        exc = Overloaded(
                            int(depth) if depth != float("inf") else limit,
                            limit,
                            retry_after_s=_overload_retry_after(depth, limit),
                        )
                        exc.shed_reason = "priority"
                        raise exc
                    if state.bucket is not None:
                        delay = state.bucket.try_accept_or_delay()
                        if delay > 0:
                            raise QuotaExceeded(tenant, delay, reason="qps")
                    if quota.max_concurrency and state.inflight >= quota.max_concurrency:
                        raise QuotaExceeded(
                            tenant,
                            (1.0 / quota.qps) if quota.qps > 0 else 0.05,
                            reason="concurrency",
                        )
                    state.inflight += 1
                    release = lambda: self._release(tenant)  # noqa: E731
        except Overloaded as exc:
            if span is not None:
                span.add_event("shed", {
                    "tenant": tenant, "reason": "priority",
                    "priority": priority,
                    "queue_depth": exc.queue_depth,
                    "retry_after_s": exc.retry_after_s,
                })
            raise
        except QuotaExceeded as exc:
            if span is not None:
                span.add_event("shed", {
                    "tenant": tenant, "reason": exc.reason,
                    "priority": priority,
                    "retry_after_s": exc.retry_after_s,
                })
            raise
        if span is not None:
            span.add_event("admit", {
                "tenant": tenant, "priority": priority,
                "queue_depth": depth if depth != float("inf") else -1.0,
            })
        return release

    def priority_of(self, tenant: str) -> int:
        """The tenant's configured priority class (0 when unmetered)."""
        with self._lock:
            if not self._policy.enabled:
                return 0
            return self._quota_for_locked(self._policy, tenant).priority

    @staticmethod
    def _release_noop() -> None:
        return None

    def _release(self, tenant: str) -> None:
        with self._lock:
            state = self._states.get(tenant)
            if state is not None and state.inflight > 0:
                state.inflight -= 1

    def inflight(self, tenant: str) -> int:
        with self._lock:
            state = self._states.get(tenant)
            return state.inflight if state else 0
