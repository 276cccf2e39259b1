"""Admission-order policy for the decode loop's request queue.

Both schedulers present the same narrow surface the executor drives
(``append`` / ``peek`` / ``pop`` / ``remove`` / ``requeue_front`` /
``__len__`` / ``__iter__`` / ``clear``), so the loop's admission code is
policy-blind. ``FifoScheduler`` is a thin deque wrapper — the original
behavior, bit-identical. ``PriorityScheduler`` keeps one FIFO deque per
priority class and picks the class head with the highest EFFECTIVE
priority::

    score(req) = req.priority + waited_seconds / aging_s

The aging term is the anti-starvation guarantee: a low-priority request
gains one full priority level per ``aging_s`` seconds queued, so under
sustained high-priority load it is eventually scheduled instead of
starving forever. Within a class, order is strictly FIFO (the head of
each class deque is also its oldest, so the head always holds the
class's best score — ``peek`` only ever scans class heads).

Preempted rows re-enter at the FRONT of their class
(``requeue_front``): they already hold partial output and their spilled
KV buffer is cheapest to restore while the prefix cache is still warm.

Clock discipline: waiting time is measured with ``time.perf_counter``
against the request's ``enqueue_t`` stamp (the same clock the executor
stamps) — never the wall clock, which the seeded-determinism lint bans
on this path.

A copy of the JAX package's ``runtime/sched/scheduler.py``.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, Iterator, List, Optional


class FifoScheduler:
    """Strict arrival order — the decode loop's original admission
    policy. A stalled head blocks later admissions by design (a stream
    of small requests cannot starve a big one)."""

    policy = "fifo"

    def __init__(self) -> None:
        self._q: deque = deque()

    def append(self, req: Any) -> None:
        self._q.append(req)

    def requeue_front(self, req: Any) -> None:
        self._q.appendleft(req)

    def peek(self) -> Optional[Any]:
        return self._q[0] if self._q else None

    def pop(self, req: Any) -> None:
        """Remove the previously peeked head."""
        self._q.remove(req)

    def remove(self, req: Any) -> None:
        self._q.remove(req)  # deque raises ValueError when absent

    def clear(self) -> None:
        self._q.clear()

    def class_depths(self) -> Dict[int, int]:
        depths: Dict[int, int] = {}
        for req in self._q:
            p = int(getattr(req, "priority", 0))
            depths[p] = depths.get(p, 0) + 1
        return depths

    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)

    def __iter__(self) -> Iterator[Any]:
        return iter(self._q)


class PriorityScheduler:
    """Per-priority-class FIFO queues with an aged weighted pick.

    ``peek`` returns the request the loop should try to admit NEXT: the
    class head with the highest ``priority + waited/aging_s`` score
    (ties break toward the higher static priority, then the earlier
    arrival — deterministic under equal clocks). ``aging_s`` is the
    number of seconds of queueing worth one static priority level."""

    policy = "priority"

    def __init__(self, aging_s: float = 5.0) -> None:
        self.aging_s = max(float(aging_s), 1e-6)
        self._classes: Dict[int, deque] = {}
        self._count = 0

    def _class(self, req: Any) -> deque:
        p = int(getattr(req, "priority", 0))
        q = self._classes.get(p)
        if q is None:
            q = self._classes[p] = deque()
        return q

    def append(self, req: Any) -> None:
        self._class(req).append(req)
        self._count += 1

    def requeue_front(self, req: Any) -> None:
        self._class(req).appendleft(req)
        self._count += 1

    def peek(self) -> Optional[Any]:
        if not self._count:
            return None
        now = time.perf_counter()
        best, best_key = None, None
        for p, q in self._classes.items():
            if not q:
                continue
            head = q[0]
            waited = max(now - float(getattr(head, "enqueue_t", now)), 0.0)
            score = p + waited / self.aging_s
            # deterministic total order: score, static priority, age
            key = (score, p, waited)
            if best_key is None or key > best_key:
                best, best_key = head, key
        return best

    def pop(self, req: Any) -> None:
        """Remove the previously peeked request."""
        self.remove(req)

    def remove(self, req: Any) -> None:
        p = int(getattr(req, "priority", 0))
        # an absent request raises ValueError from the deque itself —
        # the executor's timeout path depends on that contract
        self._classes.get(p, _EMPTY).remove(req)
        self._count -= 1

    def clear(self) -> None:
        self._classes.clear()
        self._count = 0

    def class_depths(self) -> Dict[int, int]:
        return {p: len(q) for p, q in self._classes.items() if q}

    def __len__(self) -> int:
        return self._count

    def __bool__(self) -> bool:
        return self._count > 0

    def __iter__(self) -> Iterator[Any]:
        # highest class first, FIFO inside — the order drain/fail paths
        # enumerate victims in
        for p in sorted(self._classes, reverse=True):
            for req in self._classes[p]:
                yield req


# shared empty deque: PriorityScheduler.remove of an unknown class must
# raise the same ValueError a deque raises, without a raise site here
_EMPTY: deque = deque()


def make_scheduler(policy: str = "fifo", aging_s: float = 5.0):
    """Scheduler factory the executor calls with its spec knobs. An
    unknown policy falls back to FIFO — admission policy must never be
    able to brick a replica at startup."""
    if policy == "priority":
        return PriorityScheduler(aging_s=aging_s)
    return FifoScheduler()


MAX_PREEMPTS = 4


def pick_victim(
    slots: List[Any], min_priority: int, max_preempts: int = MAX_PREEMPTS
) -> Optional[Any]:
    """Choose the slot to preempt so a stalled admission of priority
    ``min_priority`` can take its pages: the LOWEST-priority live row
    strictly below ``min_priority``; within a class, the row preempted
    the FEWEST times so far, youngest first among those (the least sunk
    cost — an old row is closer to retiring on its own).

    The preempt-count ordering plus the ``max_preempts`` cap are the
    anti-thrash guarantee: every spill costs the victim a full chunked
    re-prefill of its whole resident stream, so under sustained
    high-priority pressure the selection rotates victims instead of
    bouncing one row through spill/restore forever, and a row already
    preempted ``max_preempts`` times becomes ineligible — the admission
    then stalls, exactly the pre-preemption behavior.

    Only rows whose prefill is complete are eligible: a mid-prefill row
    has no coherent KV prefix to spill, and a prefill-only (disagg) row
    is about to export and retire anyway. Returns None when no eligible
    victim exists."""
    best, best_key = None, None
    for slot in slots:
        if slot is None:
            continue
        req = slot.req
        if getattr(req, "prefill_only", False):
            continue
        if slot.position < len(req.tokens) or not req.out:
            continue  # prefill not finished: nothing coherent to spill
        p = int(getattr(req, "priority", 0))
        if p >= min_priority:
            continue
        pc = int(getattr(req, "preempt_count", 0))
        if pc >= max_preempts:
            continue  # thrash guard: this row has paid enough re-prefills
        # lowest class, then least-preempted, then youngest
        key = (-p, -pc, float(req.dequeue_t))
        if best_key is None or key > best_key:
            best, best_key = slot, key
    return best
