"""A port replica as the node agent's serving table holds it.

The gateway and the serve client of the control plane find replicas only
in the agent's serving module (``node_agent.serving_module``), and they
hold what they get from there to the agent's own types: they map its
``ServeError`` classes to HTTP status codes and retry decisions by
``isinstance``, and pass its ``KVHandoffBuffer`` between the phases of a
disaggregated request. :class:`AgentReplica` wraps a port executor
(``ModelServer`` or ``DecodeLoopExecutor``) so that it speaks those types:

- every port ``ServeError`` (and ``HandoffError``) a call raises is raised
  again as the agent's class of the same name with the same fields
  (``retry_after_s``, ``queue_depth``, ``tried``, ...), so the gateway
  answers a port replica with the status codes it gives its own;
- handoff buffers cross between the two types through their wire bytes,
  which are identical in both packages.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, Optional

from tfk8s_tpu_torch.runtime.handoff import KVHandoffBuffer

_PORT = "tfk8s_tpu_torch."


class AgentReplica:
    """``server`` behind the surface the agent's gateway and clients call:
    ``submit``, ``submit_prefill``, ``submit_handoff``, ``export_prefix``,
    ``kv_digest_report``, ``debug_state``, ``queue_depth``, ``fault`` and
    the chaos hooks. ``agent`` is the agent's serving module."""

    def __init__(self, server: Any, agent: Any):
        self.server = server
        self._agent = agent

    def _twin(self, exc: BaseException) -> Optional[BaseException]:
        """``exc`` as the agent's class of the same name, or None when
        ``exc`` is not one of the port's or the agent has no such class."""
        cls = getattr(self._agent, type(exc).__name__, None)
        if not (type(exc).__module__.startswith(_PORT) and isinstance(cls, type)
                and issubclass(cls, BaseException)):
            return None
        twin = cls.__new__(cls)
        twin.__dict__.update(vars(exc))
        twin.args = exc.args
        return twin

    @contextlib.contextmanager
    def _typed(self) -> Iterator[None]:
        try:
            yield
        except BaseException as exc:  # noqa: BLE001 — re-raised as the agent's type
            twin = self._twin(exc)
            if twin is None:
                raise
            raise twin from exc

    def _to_agent(self, buf: Optional[KVHandoffBuffer]) -> Any:
        if buf is None:
            return None
        with self._typed():
            return self._agent.KVHandoffBuffer.from_bytes(buf.to_bytes())

    # -- the request surface --------------------------------------------------

    def submit(self, payload: Any, **kw) -> Any:
        with self._typed():
            return self.server.submit(payload, **kw)

    def submit_prefill(self, payload: Any, **kw) -> Dict[str, Any]:
        with self._typed():
            out = dict(self.server.submit_prefill(payload, **kw))
        out["handoff"] = self._to_agent(out["handoff"])
        return out

    def submit_handoff(self, buf: Any, **kw) -> Any:
        with self._typed():
            return self.server.submit_handoff(KVHandoffBuffer.from_bytes(buf.to_bytes()), **kw)

    def export_prefix(self, tokens: Any) -> Any:
        with self._typed():
            buf = self.server.export_prefix(tokens)
        return self._to_agent(buf)

    def kv_digest_report(self, *args, **kw) -> Dict[str, Any]:
        return self.server.kv_digest_report(*args, **kw)

    def debug_state(self) -> Dict[str, Any]:
        return self.server.debug_state()

    @property
    def queue_depth(self) -> int:
        return self.server.queue_depth

    @property
    def fault(self) -> Optional[BaseException]:
        fault = self.server.fault
        return None if fault is None else (self._twin(fault) or fault)

    # -- chaos hooks (the agent's chaos entry reaches replicas here) ----------

    def chaos_crash(self, *args, **kw) -> None:
        self.server.chaos_crash(*args, **kw)

    def chaos_wire_reset(self, *args, **kw) -> None:
        self.server.chaos_wire_reset(*args, **kw)

    def chaos_delay(self, seconds: float) -> None:
        self.server.chaos_delay(seconds)
