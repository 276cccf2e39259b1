"""Client-side rate limiting.

The reference's clientset installs ``flowcontrol.NewTokenBucketRateLimiter
(QPS, Burst)`` on every REST client (images/tf4.PNG at k8s-operator.md:235;
SURVEY.md C10/C16). Same construction here: a token bucket gating every
client call, plus the per-item backoff limiters the workqueue composes.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Hashable


class TokenBucketRateLimiter:
    """Classic token bucket: ``qps`` refill rate, ``burst`` capacity.
    ``accept(n)`` blocks until ``n`` tokens are available; ``try_accept()``
    doesn't block.

    ``accept`` is reservation-style (flowcontrol's ``WaitN``): the tokens
    are debited immediately — the balance may go negative — and the
    caller sleeps once for exactly the debt. One ``accept(n)`` is
    therefore a single batched wait, which is how a gang's n pod creates
    pay the rate limiter once instead of sleeping n times on the
    reconcile hot path; later callers queue behind the debt, preserving
    the overall rate."""

    def __init__(self, qps: float, burst: int, clock=time.monotonic, sleep=time.sleep):
        if qps <= 0:
            raise ValueError("qps must be > 0")
        self.qps = float(qps)
        self.burst = max(int(burst), 1)
        self._tokens = float(self.burst)
        self._last = clock()
        self._clock = clock
        self._sleep = sleep
        self._lock = threading.Lock()

    def _refill(self) -> None:
        now = self._clock()
        self._tokens = min(self.burst, self._tokens + (now - self._last) * self.qps)
        self._last = now

    def try_accept(self) -> bool:
        with self._lock:
            self._refill()
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False

    def try_accept_or_delay(self) -> float:
        """Admission-control shape: debit and return 0.0 when a token is
        available, else return (WITHOUT debiting or blocking) the seconds
        until one accrues — the Retry-After a shedding gateway puts on
        the 429 so clients back off for exactly the bucket's debt."""
        with self._lock:
            self._refill()
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return 0.0
            return (1.0 - self._tokens) / self.qps

    def accept(self, n: int = 1) -> None:
        if n <= 0:
            return
        with self._lock:
            self._refill()
            self._tokens -= float(n)
            wait = -self._tokens / self.qps if self._tokens < 0 else 0.0
        if wait > 0:
            self._sleep(wait)


class ItemExponentialFailureRateLimiter:
    """Per-item exponential backoff: ``base * 2^failures`` capped at ``cap``
    — the DefaultControllerRateLimiter's first half (k8s-operator.md:87)."""

    def __init__(self, base: float = 0.005, cap: float = 120.0):
        self.base = base
        self.cap = cap
        self._failures: Dict[Hashable, int] = {}
        self._lock = threading.Lock()

    def when(self, item: Hashable) -> float:
        with self._lock:
            n = self._failures.get(item, 0)
            self._failures[item] = n + 1
            return min(self.base * (2**n), self.cap)

    def forget(self, item: Hashable) -> None:
        with self._lock:
            self._failures.pop(item, None)

    def retries(self, item: Hashable) -> int:
        with self._lock:
            return self._failures.get(item, 0)


class BucketRateLimiter:
    """Overall-rate half of the default controller rate limiter: items are
    admitted at token-bucket pace regardless of per-item history."""

    def __init__(self, qps: float = 10.0, burst: int = 100, clock=time.monotonic):
        self.qps = qps
        self.burst = burst
        self._tokens = float(burst)
        self._last = clock()
        self._clock = clock
        self._lock = threading.Lock()

    def when(self, item: Hashable) -> float:
        with self._lock:
            now = self._clock()
            self._tokens = min(self.burst, self._tokens + (now - self._last) * self.qps)
            self._last = now
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return 0.0
            need = 1.0 - self._tokens
            self._tokens -= 1.0
            return need / self.qps

    def forget(self, item: Hashable) -> None:
        pass

    def retries(self, item: Hashable) -> int:
        return 0


class MaxOfRateLimiter:
    """Compose limiters, taking the worst (max) delay — the
    ``DefaultControllerRateLimiter()`` shape (k8s-operator.md:87)."""

    def __init__(self, *limiters):
        self.limiters = limiters

    def when(self, item: Hashable) -> float:
        return max(l.when(item) for l in self.limiters)

    def forget(self, item: Hashable) -> None:
        for l in self.limiters:
            l.forget(item)

    def retries(self, item: Hashable) -> int:
        return max(l.retries(item) for l in self.limiters)


def default_controller_rate_limiter() -> MaxOfRateLimiter:
    return MaxOfRateLimiter(
        ItemExponentialFailureRateLimiter(base=0.005, cap=16.0),
        BucketRateLimiter(qps=50.0, burst=500),
    )
