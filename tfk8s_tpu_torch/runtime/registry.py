"""Entrypoint registry: maps a ContainerSpec.entrypoint string to a Python
callable. The local/hermetic backend's analogue of an OCI image + command —
the thing the kubelet 'pulls and starts' (SURVEY.md §3.3 process boundary).

Entrypoints are ``"module.path:function"`` strings resolved by import, or
names registered explicitly (tests). The callable receives the pod's env
dict (the coordination contract of trainer/replicas.py) and optionally
a ``stop`` threading.Event (second positional arg) for graceful teardown.
"""

from __future__ import annotations

import importlib
import inspect
import threading
from typing import Callable, Dict, Optional

from tfk8s_tpu_torch.runtime import node_agent

_REGISTRY: Dict[str, Callable] = {}

# Raised by an entrypoint that honored a reclaim notice: it finished its
# in-flight work, committed its drain checkpoint, and is exiting
# GRACEFULLY. The kubelet maps this to ``PodPhase.DRAINED`` (not Failed),
# which is what lets the job controller resize the gang instead of
# burning ``backoff_limit``. The port has one such class, the one its
# entry points raise outside any node agent.
PodDrained = node_agent.PodDrained


def register(name: str, fn: Optional[Callable] = None):
    """``register("name", fn)`` or ``@register("name")`` decorator."""
    if fn is None:
        def deco(f):
            _REGISTRY[name] = f
            return f
        return deco
    _REGISTRY[name] = fn
    return fn


def resolve(entrypoint: str) -> Callable:
    if entrypoint in _REGISTRY:
        return _REGISTRY[entrypoint]
    if ":" in entrypoint:
        mod_name, attr = entrypoint.split(":", 1)
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, attr)
        if not callable(fn):
            raise TypeError(f"entrypoint {entrypoint!r} is not callable")
        return fn
    raise KeyError(f"entrypoint {entrypoint!r} is neither registered nor importable")


def call(fn: Callable, env: Dict[str, str], stop: threading.Event) -> None:
    """Invoke with (env) or (env, stop) depending on the signature."""
    try:
        sig = inspect.signature(fn)
        nparams = len([
            p for p in sig.parameters.values()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
        ])
    except (TypeError, ValueError):
        nparams = 1
    if nparams >= 2:
        fn(env, stop)
    else:
        fn(env)
