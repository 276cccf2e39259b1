"""Training- and serving-progress reporting: entrypoint -> node agent ->
pod status.

A copy of the JAX package's ``runtime/progress.py``: the trainer (or a
serve replica) calls :func:`report` from the pod's entrypoint thread and
whoever runs the pod reads the values for that thread. When a node agent
is bound to the calling thread (``runtime/node_agent.attach``), the
values go to the agent's own progress sink, which is the one it copies
into ``pod.status.training``. Otherwise reporting is a cheap write into
this module's dict, which :func:`snapshot` reads (the port's own
kubelet, ``runtime/kubelet.py``, reads it there)."""

from __future__ import annotations

import threading
from typing import Dict, Optional

from tfk8s_tpu_torch.runtime import node_agent

_LOCK = threading.Lock()
_BY_THREAD: Dict[int, Dict[str, float]] = {}


def report(**values: float) -> None:
    """Merge numeric progress values for the CALLING thread (the pod
    entrypoint thread). Keys are metric suffixes, e.g. ``step``,
    ``steps_per_sec``, ``examples_per_sec``, ``step_seconds``."""
    clean = {k: float(v) for k, v in values.items()}
    agent = node_agent.bound()
    if agent is not None:
        agent.progress.report(**clean)
        return
    ident = threading.get_ident()
    with _LOCK:
        _BY_THREAD.setdefault(ident, {}).update(clean)


def snapshot(ident: Optional[int] = None) -> Dict[str, float]:
    """Latest values reported outside a node agent for ``ident``
    (defaults to the calling thread)."""
    if ident is None:
        ident = threading.get_ident()
    with _LOCK:
        return dict(_BY_THREAD.get(ident, {}))


def clear(ident: Optional[int] = None) -> None:
    if ident is None:
        ident = threading.get_ident()
    with _LOCK:
        _BY_THREAD.pop(ident, None)
