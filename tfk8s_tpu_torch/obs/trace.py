"""Tracing for the port: the node agent's tracer, reached through the pod's
stop object (``runtime/node_agent``), so a port pod's spans land in the
same process-wide ring as the control plane's and continue its trace.

Outside a node agent there is no ring to export to, and
:func:`get_tracer` returns a no-op tracer with the same surface
(``start_span``, ``record_span``, ``current_span``). The W3C
``traceparent`` helpers are copies of the JAX package's ``obs/trace.py``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from tfk8s_tpu_torch.runtime import node_agent

# the pod-env key carrying the parent span across the control -> data
# plane handoff (the reference's name)
TRACEPARENT_ENV = node_agent.TRACEPARENT_ENV


def parse_traceparent(header: Optional[str]) -> Optional[Tuple[str, str]]:
    """``00-<trace_id>-<span_id>-<flags>`` -> (trace_id, span_id), or None
    for anything malformed."""
    if not header:
        return None
    parts = header.strip().split("-")
    if len(parts) != 4:
        return None
    _ver, trace_id, span_id, _flags = parts
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16), int(span_id, 16)
    except ValueError:
        return None
    return trace_id, span_id


class _NoopSpan:
    trace_id = ""
    span_id = ""
    traceparent = ""

    def set_attribute(self, key: str, value: Any) -> None:
        pass

    def set_status(self, status: str, message: str = "") -> None:
        pass

    def add_event(self, name: str, attributes=None, ts=None) -> None:
        pass

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NOOP_SPAN = _NoopSpan()


class NoopTracer:
    """The tracer outside a node agent: every span is a no-op."""

    enabled = False

    def start_span(self, name: str, parent: Any = None,
                   traceparent: Optional[str] = None,
                   attributes: Optional[Dict[str, Any]] = None,
                   tail_sample: bool = False) -> _NoopSpan:
        return _NOOP_SPAN

    def record_span(self, name: str, start: float, end: float,
                    parent: Any = None, traceparent: Optional[str] = None,
                    attributes: Optional[Dict[str, Any]] = None,
                    status: str = "ok",
                    events: Optional[List[Dict[str, Any]]] = None) -> _NoopSpan:
        return _NOOP_SPAN

    def current_span(self) -> None:
        return None


_NOOP_TRACER = NoopTracer()


def get_tracer() -> Any:
    """The node agent's process tracer once a pod has attached to one,
    else the no-op tracer."""
    agent = node_agent.tracer_agent()
    return agent.get_tracer() if agent is not None else _NOOP_TRACER
