"""Lease-based leader election — SURVEY.md C17 ("uses the leaderelection
package for high availability", k8s-operator.md:59; design heading
k8s-operator.md:237).

Only the lease holder runs the reconcile loop; standbys poll and take over
when the lease expires. Acquisition and renewal go through the store's
optimistic-concurrency update, so two candidates racing produce exactly one
winner (the loser's write fails with Conflict).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from tfk8s_tpu_torch.api.types import Lease, LeaseSpec, ObjectMeta
from tfk8s_tpu_torch.client.store import AlreadyExists, Conflict, NotFound
from tfk8s_tpu_torch.utils.logging import get_logger

log = get_logger("leaderelection")


class LeaderElector:
    def __init__(
        self,
        client,  # TypedClient for kind Lease
        identity: str,
        lease_name: str = "tfk8s-tpu-operator",
        namespace: str = "default",
        lease_duration_s: float = 15.0,
        renew_period_s: float = 5.0,
        retry_period_s: float = 2.0,
        clock: Callable[[], float] = time.time,
    ):
        self.client = client
        self.identity = identity
        self.lease_name = lease_name
        self.namespace = namespace
        self.lease_duration_s = lease_duration_s
        self.renew_period_s = renew_period_s
        self.retry_period_s = retry_period_s
        self._clock = clock
        self._is_leader = False

    @property
    def is_leader(self) -> bool:
        return self._is_leader

    # -- lease arithmetic ---------------------------------------------------

    def _expired(self, lease: Lease) -> bool:
        if not lease.spec.holder:
            return True  # released leases are immediately up for grabs
        rt = lease.spec.renew_time
        if rt is None:
            rt = lease.spec.acquire_time if lease.spec.acquire_time is not None else 0.0
        return self._clock() > rt + lease.spec.lease_duration_s

    def try_acquire_or_renew(self) -> bool:
        """One acquisition/renewal attempt. Returns True while leading."""
        now = self._clock()
        try:
            lease = self.client.get(self.lease_name)
        except NotFound:
            lease = Lease(
                metadata=ObjectMeta(name=self.lease_name, namespace=self.namespace),
                spec=LeaseSpec(
                    holder=self.identity,
                    lease_duration_s=self.lease_duration_s,
                    acquire_time=now,
                    renew_time=now,
                ),
            )
            try:
                self.client.create(lease)
                self._is_leader = True
                log.info("%s: acquired new lease %s", self.identity, self.lease_name)
                return True
            except AlreadyExists:
                return False

        if lease.spec.holder != self.identity and not self._expired(lease):
            self._is_leader = False
            return False

        if lease.spec.holder != self.identity:
            lease.spec.lease_transitions += 1
            lease.spec.acquire_time = now
            log.info(
                "%s: taking over expired lease from %s", self.identity, lease.spec.holder
            )
        lease.spec.holder = self.identity
        lease.spec.renew_time = now
        try:
            self.client.update(lease)
        except (Conflict, NotFound):
            self._is_leader = False
            return False
        self._is_leader = True
        return True

    def release(self) -> None:
        """Voluntarily drop the lease so a standby takes over immediately.
        Best-effort: on a dead/unreachable apiserver (process teardown)
        the lease simply expires instead — never raise from here."""
        try:
            lease = self.client.get(self.lease_name)
            if lease.spec.holder == self.identity:
                lease.spec.holder = ""
                lease.spec.renew_time = None
                self.client.update(lease)
        except Exception:  # noqa: BLE001 — includes remote transport errors
            pass
        self._is_leader = False

    # -- run ----------------------------------------------------------------

    def run(
        self,
        on_started_leading: Callable[[threading.Event], None],
        stop: threading.Event,
        on_stopped_leading: Optional[Callable[[], None]] = None,
    ) -> None:
        """Block until leadership is acquired, call ``on_started_leading``
        (with a child stop event), keep renewing in the background, and fire
        ``on_stopped_leading`` if the lease is lost (k8s-operator.md:59 —
        the leaderelection gate ahead of Controller.Run)."""
        while not stop.is_set():
            if self.try_acquire_or_renew():
                break
            stop.wait(self.retry_period_s)
        if stop.is_set():
            return

        lost = threading.Event()

        def renew_loop():
            while not stop.is_set() and not lost.is_set():
                stop.wait(self.renew_period_s)
                if stop.is_set():
                    break
                if not self.try_acquire_or_renew():
                    log.warning("%s: lost lease %s", self.identity, self.lease_name)
                    lost.set()
            if stop.is_set():
                self.release()

        renewer = threading.Thread(target=renew_loop, name="lease-renewer", daemon=True)
        renewer.start()

        child_stop = threading.Event()

        def propagate():
            while not stop.is_set() and not lost.is_set():
                lost.wait(0.2) or stop.wait(0.2)
            child_stop.set()

        threading.Thread(target=propagate, daemon=True).start()
        try:
            on_started_leading(child_stop)
        finally:
            if lost.is_set() and on_stopped_leading:
                on_stopped_leading()
