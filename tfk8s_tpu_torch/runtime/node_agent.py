"""Reaching the node agent that runs this pod.

The control plane's node agent (the JAX package's ``LocalKubelet``) calls
an entrypoint with two things only: the pod env and a stop object. It
reads what the pod reports from three objects that live in its own
module's namespace:

- ``PodDrained``: the one exception class it maps to the Drained phase;
- ``_progress``: the progress module whose per-thread values it copies
  into ``pod.status.training`` (training throughput, ``serving_ready``);
- ``get_tracer``: the process tracer its ``kubelet.launch`` span lives in.

The port names nothing of that package, so it finds these through the
stop object: ``sys.modules[type(stop).__module__]`` is the module that
defines the stop signal's class, and the three are read from it by
attribute. Outside a node agent (no stop object, or a plain
``threading.Event``) nothing is found and the port keeps its own
``PodDrained``, its own progress dict and its own tracer. The port's own
kubelet (``runtime/kubelet.py``) reads those directly, so it is no node
agent here: ``find`` returns None for its stop object.

``attach(stop)`` binds the agent's progress sink to the calling thread
(the pod's entrypoint thread, which is the thread the node agent reads
progress for) until the ``with`` block ends, and makes the agent's
tracer the one ``obs.trace.get_tracer`` returns until no pod is bound.

The agent's serving table, where the gateway and the serve client look
replicas up, is found the same way: the stop signal's module belongs to a
package whose ``server`` attribute, once that module is loaded (the
gateway imports it), is the agent's serving module. :func:`serving_module`
returns it, and the port's ``serve`` registers its replicas there too
(``runtime/agent_replica``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import threading
from typing import Any, Callable, Dict, Iterator, Optional

TRACEPARENT_ENV = "TFK8S_TRACEPARENT"


class PodDrained(Exception):
    """Raised by an entrypoint that honored a reclaim notice outside a
    node agent: it finished its in-flight work, committed its drain
    checkpoint, and is exiting gracefully. Under a node agent the port
    raises the agent's own class instead (:attr:`NodeAgent.pod_drained`)."""


@dataclasses.dataclass(frozen=True)
class NodeAgent:
    """The node agent's three sinks, as found from a pod's stop object."""

    pod_drained: type
    progress: Any  # a module with report(**values) for the calling thread
    get_tracer: Callable[[], Any]


def find(stop: Any) -> Optional[NodeAgent]:
    """The node agent behind ``stop``, or None outside one."""
    if stop is None:
        return None
    mod = sys.modules.get(type(stop).__module__)
    drained = getattr(mod, "PodDrained", None)
    prog = getattr(mod, "_progress", None)
    get_tracer = getattr(mod, "get_tracer", None)
    if not (isinstance(drained, type) and issubclass(drained, BaseException)
            and callable(getattr(prog, "report", None))
            and callable(get_tracer)):
        return None
    return NodeAgent(pod_drained=drained, progress=prog, get_tracer=get_tracer)


def serving_module(stop: Any) -> Any:
    """The node agent's serving module behind ``stop``: the ``server``
    attribute of the package of the stop signal's module, when it is
    loaded and offers the replica table (``register_replica``,
    ``unregister_replica``, ``lookup_replica``) and the ``ServeError``
    taxonomy. None outside a node agent or while no such module is
    loaded."""
    if find(stop) is None:
        return None
    package = getattr(sys.modules.get(type(stop).__module__), "__package__", None)
    serving = getattr(sys.modules.get(package or ""), "server", None)
    table = ("register_replica", "unregister_replica", "lookup_replica")
    if not all(callable(getattr(serving, name, None)) for name in table):
        return None
    if not isinstance(getattr(serving, "ServeError", None), type):
        return None
    return serving


def pod_drained_class(stop: Any) -> type:
    """The exception a drained entrypoint raises: the node agent's class
    under one, the port's :class:`PodDrained` outside."""
    agent = find(stop)
    return agent.pod_drained if agent is not None else PodDrained


_LOCK = threading.Lock()
# entrypoint thread ident -> the node agent bound to it
_BOUND: Dict[int, NodeAgent] = {}
# the agent whose tracer obs.trace.get_tracer returns while any pod is
# bound (the node agent's tracer is process-wide, so the last one bound
# stands for all)
_TRACER_AGENT: Optional[NodeAgent] = None


def bound() -> Optional[NodeAgent]:
    """The agent bound to the calling thread, if any."""
    with _LOCK:
        return _BOUND.get(threading.get_ident())


def tracer_agent() -> Optional[NodeAgent]:
    with _LOCK:
        return _TRACER_AGENT


@contextlib.contextmanager
def attach(stop: Any) -> Iterator[Optional[NodeAgent]]:
    """Bind the node agent behind ``stop`` to the calling thread for the
    ``with`` block; yields the agent, or None outside a node agent (then
    nothing is bound and reporting stays local)."""
    global _TRACER_AGENT
    agent = find(stop)
    if agent is None:
        yield None
        return
    ident = threading.get_ident()
    with _LOCK:
        prev = _BOUND.get(ident)
        _BOUND[ident] = agent
        _TRACER_AGENT = agent
    try:
        yield agent
    finally:
        with _LOCK:
            if prev is None:
                _BOUND.pop(ident, None)
            else:
                _BOUND[ident] = prev
            if not _BOUND:
                _TRACER_AGENT = None
