"""An entry point whose rank processes start slowly, for the pod-rank
relay's stop grace (``tests/test_torch_pod_ranks.py``).

No JAX here: the ranks import this module to resolve the entry point. In
a rank process (``python -m tfk8s_tpu_torch.runtime.pod_ranks``) its
import sleeps :data:`SLOW_START_S` first, as an interpreter start and a
torch import do on a loaded host.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Any, Dict, Optional

from tfk8s_tpu_torch.runtime import pod_ranks

SLOW_START_S = 3.0

if os.path.basename(sys.argv[0]) == "pod_ranks.py":
    time.sleep(SLOW_START_S)


@pod_ranks.entrypoint
def until_stopped(env: Dict[str, str], stop: Optional[Any] = None):
    """An empty history once the pod's stop reaches the rank."""
    if not stop.wait(60):
        raise RuntimeError("the rank was never stopped")
    return []
