"""Token scheduler for the continuous-batching decode loop.

The decode loop (runtime/server.DecodeLoopExecutor) owns slots, pages
and device dispatch; THIS package owns every per-step policy decision
the loop used to hard-code:

- ``scheduler.py`` — admission order. FIFO (the original behavior,
  bit-identical) or priority-weighted with anti-starvation aging; the
  priority scheduler is also where a stalled high-priority admission
  asks for a preemption victim.
- ``speculative.py`` — speculative decoding (Leviathan et al.): a small
  draft model proposes ``k`` tokens per row, the serving model verifies
  them in ONE packed chunk step, and the accepted prefix (plus the
  target's own correction token) is emitted. Output is token-identical
  to non-speculative decoding by construction — the draft only decides
  how many target tokens each verify step yields.

The package deliberately imports nothing from ``runtime/server.py``
(the executor imports the scheduler, never the reverse), so the typed
error taxonomy stays rooted in the server module.

A copy of the JAX package's ``runtime/sched`` (only the imports
changed).
"""

from tfk8s_tpu_torch.runtime.sched.scheduler import (
    FifoScheduler,
    PriorityScheduler,
    make_scheduler,
)
from tfk8s_tpu_torch.runtime.sched.speculative import SpeculativeEngine

__all__ = [
    "FifoScheduler",
    "PriorityScheduler",
    "SpeculativeEngine",
    "make_scheduler",
]
