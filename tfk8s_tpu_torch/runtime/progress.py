"""Training-progress reporting: trainer -> node agent -> pod status.

A copy of the JAX package's ``runtime/progress.py``: the trainer calls
:func:`report` from the pod's entrypoint thread and whoever runs the pod
reads :func:`snapshot` for that thread. Outside a node agent reporting is
a cheap dict write nobody reads."""

from __future__ import annotations

import threading
from typing import Dict, Optional

_LOCK = threading.Lock()
_BY_THREAD: Dict[int, Dict[str, float]] = {}


def report(**values: float) -> None:
    """Merge numeric progress values for the CALLING thread (the pod
    entrypoint thread). Keys are metric suffixes, e.g. ``step``,
    ``steps_per_sec``, ``examples_per_sec``, ``step_seconds``."""
    ident = threading.get_ident()
    clean = {k: float(v) for k, v in values.items()}
    with _LOCK:
        _BY_THREAD.setdefault(ident, {}).update(clean)


def snapshot(ident: Optional[int] = None) -> Dict[str, float]:
    """Latest values for ``ident`` (defaults to the calling thread)."""
    if ident is None:
        ident = threading.get_ident()
    with _LOCK:
        return dict(_BY_THREAD.get(ident, {}))


def clear(ident: Optional[int] = None) -> None:
    if ident is None:
        ident = threading.get_ident()
    with _LOCK:
        _BY_THREAD.pop(ident, None)
