"""Causal tracing for the port: the JAX package's ``obs/trace.py`` (spans,
the W3C ``traceparent`` form, the bounded ring, the request gateway's tail
sampler), with one addition for pods that a foreign node agent runs.

One trace follows one piece of work across the control plane and the
runtime: the controller opens a ``reconcile`` span per sync and stamps
the pod env with ``TFK8S_TRACEPARENT``, the kubelet continues the trace
around the entrypoint launch, and the trainer adds ``trainer.*`` spans.
The module-level :class:`Tracer` is what the port's own operator, kubelet
and trainer threads share (:func:`get_tracer`, :func:`set_tracer`).

Request-scoped additions (the serving plane's layer):

- ``Span.add_event`` records a timestamped timeline entry on a span (the
  decode loop's per-token samples, the gateway's routing decisions, client
  retries).
- **Tail-based sampling** (:class:`TailSampler`): a request's keep/drop
  decision waits for the END of its root span, when the outcome is known.
  Errors, sheds (any ``http.status_code`` >= 400) and the slowest tail are
  always kept; fast successes keep with probability ``TFK8S_TRACE_SAMPLE``
  (default 0.05). Spans of an undecided trace buffer until the verdict;
  late spans follow the recorded verdict. Spans of traces that never
  opened a decision span (the whole control plane) bypass sampling.
- Every span the tracer drops (sampled out, ring eviction, buffer
  overflow) counts in ``tfk8s_trace_spans_dropped_total{reason}`` once a
  metrics registry is wired via ``set_metrics``.

A port pod run by another node agent (the JAX package's kubelet) reaches
that agent's tracer through its stop object (``runtime/node_agent``):
while such an agent is attached, :func:`get_tracer` returns the agent's
tracer, so the pod's spans land in the agent's ring and continue its
trace. A disabled :class:`Tracer` records nothing (a pod's rank
processes use one: their node agent is in the pod's process).
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import random
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from tfk8s_tpu_torch.runtime import node_agent

# Pod-env key carrying the parent span across the control->data plane
# handoff (trainer/replicas.py renders env; the controller stamps this
# one at pod creation because only the creating sync knows its span).
TRACEPARENT_ENV = node_agent.TRACEPARENT_ENV

_TRACEPARENT_VERSION = "00"

# Span-ring capacity (spans, not traces) — sized for the serving plane:
# at the gateway bench's ~3 kept spans per sampled request and the
# default 5% keep rate, 4096 spans holds minutes of saturation traffic.
TRACE_RING_ENV = "TFK8S_TRACE_RING"
DEFAULT_RING_CAPACITY = 4096
# Probability a FAST, SUCCESSFUL request's trace is kept by the tail
# sampler (errors/sheds/slow-tail are always kept regardless).
TRACE_SAMPLE_ENV = "TFK8S_TRACE_SAMPLE"
DEFAULT_KEEP_PROBABILITY = 0.05

# Bounds on the tail-sampling bookkeeping so a leaked decision span or
# a verdict-table pile-up can never grow without limit.
MAX_PENDING_SPANS_PER_TRACE = 512
MAX_PENDING_TRACES = 1024
MAX_VERDICTS = 4096
MAX_EVENTS_PER_SPAN = 256


def ring_capacity_from_env() -> int:
    try:
        n = int(os.environ.get(TRACE_RING_ENV, DEFAULT_RING_CAPACITY))
    except ValueError:
        return DEFAULT_RING_CAPACITY
    return max(n, 16)


# Span/trace ids are w3c-shaped random hex, NOT security material: a
# PRNG seeded once from the OS is plenty unique. Calling os.urandom per
# span was the controller's single biggest instrumented-sync cost on the
# CI box (a getrandom(2) syscall per id — measured ~0.7 ms each there,
# ~2.7 ms of the ~2 ms sync!); getrandbits is pure userspace. Seeded
# per-process; fork safety doesn't matter more than it did (a forked
# child re-imports or shares the parent's stream offset).
_rng = random.Random(os.urandom(16))
_rng_lock = threading.Lock()


def _gen_id(nbytes: int) -> str:
    with _rng_lock:
        return _rng.getrandbits(nbytes * 8).to_bytes(nbytes, "big").hex()


def parse_traceparent(header: Optional[str]) -> Optional[Tuple[str, str]]:
    """``00-<trace_id>-<span_id>-<flags>`` -> (trace_id, span_id), or None
    for anything malformed — a bad header must degrade to 'new trace',
    never to a crash in the reconcile or training path."""
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


@dataclasses.dataclass
class Span:
    """One timed operation. Context-manager: ``with tracer.start_span(..)``
    pops the thread-local stack and lands the span in the ring on exit."""

    name: str
    trace_id: str
    span_id: str
    parent_id: Optional[str] = None
    start_time: float = 0.0
    end_time: Optional[float] = None
    attributes: Dict[str, Any] = dataclasses.field(default_factory=dict)
    status: str = "ok"
    message: str = ""
    events: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    # True on a tail-sampling DECISION span (the request's anchor): its
    # end triggers the keep/drop verdict for the whole trace
    tail_decision: bool = dataclasses.field(
        default=False, repr=False, compare=False
    )
    _tracer: Optional["Tracer"] = dataclasses.field(
        default=None, repr=False, compare=False
    )

    @property
    def traceparent(self) -> str:
        return f"{_TRACEPARENT_VERSION}-{self.trace_id}-{self.span_id}-01"

    def set_attribute(self, key: str, value: Any) -> None:
        self.attributes[key] = value

    def set_status(self, status: str, message: str = "") -> None:
        self.status = status
        self.message = message

    def add_event(
        self,
        name: str,
        attributes: Optional[Dict[str, Any]] = None,
        ts: Optional[float] = None,
    ) -> None:
        """Append one timestamped timeline entry (an OTel span event).
        Bounded: past MAX_EVENTS_PER_SPAN the event is dropped and the
        overflow counted in an ``events_dropped`` attribute — a retry
        storm annotates, it never balloons a span."""
        if len(self.events) >= MAX_EVENTS_PER_SPAN:
            self.attributes["events_dropped"] = (
                int(self.attributes.get("events_dropped", 0)) + 1
            )
            return
        self.events.append({
            "name": name,
            "ts": time.time() if ts is None else ts,
            "attributes": dict(attributes or {}),
        })

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start_time": self.start_time,
            "end_time": self.end_time,
            "duration_s": (
                None if self.end_time is None
                else self.end_time - self.start_time
            ),
            "attributes": dict(self.attributes),
            "status": self.status,
            "message": self.message,
            "events": [dict(e) for e in self.events],
        }

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, _tb) -> bool:
        if exc is not None and self.status == "ok":
            self.set_status("error", f"{getattr(exc_type, '__name__', exc_type)}: {exc}")
        if self._tracer is not None:
            self._tracer._finish(self)
        return False


class _NoopSpan:
    """Returned by a disabled tracer: every operation is a no-op and the
    span never touches a lock — the bench's 'instrumentation off' arm."""

    name = ""
    trace_id = ""
    span_id = ""
    parent_id = None
    start_time = 0.0
    end_time = 0.0
    attributes: Dict[str, Any] = {}
    status = "ok"
    traceparent = ""
    events: List[Dict[str, Any]] = []
    tail_decision = False

    def set_attribute(self, key: str, value: Any) -> None:
        pass

    def set_status(self, status: str, message: str = "") -> None:
        pass

    def add_event(self, name: str, attributes=None, ts=None) -> None:
        pass

    def to_dict(self) -> Dict[str, Any]:
        return {}

    def __enter__(self):
        return self

    def __exit__(self, *a) -> bool:
        return False


_NOOP_SPAN = _NoopSpan()


class TailSampler:
    """OTel-style tail-based sampling policy: the keep/drop decision is
    made at the END of a request's decision span, when the outcome is
    known — the only sampling that can promise "every shed and every
    deadline miss is retrievable" without keeping every fast success.

    Keep rules, in order (the reason string lands in test assertions and
    the drop counter's labels):

    - ``error``: the decision span's status is not ``ok`` (a mapped
      DeadlineExceeded/RequestFailed/Unavailable — always kept);
    - ``status_code``: an ``http.status_code`` attribute >= 400 (the
      429 sheds answer BEFORE the span errors — also always kept);
    - ``slow``: the span's duration reaches the windowed ``quantile``
      (default p99) of recent same-sampler durations — the latency tail
      a histogram bucket can show but never explain;
    - ``probabilistic``: a ``keep_probability`` coin for fast successes
      (``TFK8S_TRACE_SAMPLE``, default 0.05) — enough exemplars to link
      histograms to live traces without paying for every request.

    Everything else drops with reason ``sampled``. The duration window
    needs ``MIN_TAIL_SAMPLES`` observations before the slow-tail rule
    arms (a cold sampler has no tail to speak of)."""

    MIN_TAIL_SAMPLES = 50

    def __init__(
        self,
        keep_probability: Optional[float] = None,
        quantile: float = 0.99,
        window: int = 256,
        rng: Optional[random.Random] = None,
    ):
        if keep_probability is None:
            try:
                keep_probability = float(
                    os.environ.get(TRACE_SAMPLE_ENV, DEFAULT_KEEP_PROBABILITY)
                )
            except ValueError:
                keep_probability = DEFAULT_KEEP_PROBABILITY
        self.keep_probability = min(max(keep_probability, 0.0), 1.0)
        self.quantile = quantile
        self._durations: "collections.deque" = collections.deque(maxlen=window)
        self._rng = rng

    def _tail_cut(self) -> Optional[float]:
        if len(self._durations) < self.MIN_TAIL_SAMPLES:
            return None
        ranked = sorted(self._durations)
        return ranked[min(len(ranked) - 1, int(self.quantile * len(ranked)))]

    def decide(self, span: Span) -> Tuple[bool, str]:
        """(keep, reason) for a finished decision span. Called with the
        owning tracer's lock held — pure bookkeeping, no blocking."""
        duration = (span.end_time or span.start_time) - span.start_time
        cut = self._tail_cut()
        self._durations.append(duration)
        if span.status != "ok":
            return True, "error"
        code = span.attributes.get("http.status_code")
        try:
            if code is not None and int(code) >= 400:
                return True, "status_code"
        except (TypeError, ValueError):
            pass
        if cut is not None and duration >= cut:
            return True, "slow"
        if self.keep_probability >= 1.0:
            return True, "probabilistic"
        if self.keep_probability > 0.0:
            if self._rng is not None:
                r = self._rng.random()
            else:
                with _rng_lock:
                    r = _rng.random()
            if r < self.keep_probability:
                return True, "probabilistic"
        return False, "sampled"


class Tracer:
    """Thread-safe span factory + bounded in-memory ring of finished
    spans. ``capacity`` bounds memory: a long-lived operator keeps the
    most recent ~capacity spans, oldest evicted (``None`` reads
    ``TFK8S_TRACE_RING``, default 4096). An optional :class:`TailSampler`
    gates request traces (spans under a ``tail_sample=True`` decision
    span); control-plane spans always land directly in the ring."""

    def __init__(self, capacity: Optional[int] = None, enabled: bool = True,
                 sampler: Optional[TailSampler] = None, metrics=None):
        self.enabled = enabled
        self.sampler = sampler
        self._metrics = metrics
        self._lock = threading.Lock()
        # ring of (seq, span): the monotonically-increasing seq lets
        # export_jsonl write each span exactly once across repeated calls
        self._spans: "collections.deque" = collections.deque(
            maxlen=ring_capacity_from_env() if capacity is None else capacity
        )
        self._next_seq = 0
        self._exported_seq = -1
        self._tls = threading.local()
        # tail-sampling state: trace_id -> spans buffered until the
        # decision span ends; trace_id -> keep/drop for late finishers
        self._pending: "collections.OrderedDict[str, List[Span]]" = (
            collections.OrderedDict()
        )
        self._verdicts: "collections.OrderedDict[str, bool]" = (
            collections.OrderedDict()
        )
        # reason -> spans dropped (mirrors the exported counter so tests
        # and /debug read pressure without a registry wired)
        self.dropped: Dict[str, int] = {}

    def set_metrics(self, metrics) -> None:
        """Wire a Metrics registry: every dropped span counts in
        ``tfk8s_trace_spans_dropped_total{reason}`` from here on."""
        self._metrics = metrics
        if metrics is not None:
            metrics.describe(
                "tfk8s_trace_spans_dropped_total",
                "Spans the tracer dropped, by reason (sampled / ring_full "
                "/ pending_overflow).",
            )

    def set_sampler(self, sampler: Optional[TailSampler]) -> None:
        self.sampler = sampler

    # -- context -----------------------------------------------------------

    def _stack(self) -> List[Span]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = []
            self._tls.stack = st
        return st

    def current_span(self) -> Optional[Span]:
        st = self._stack()
        return st[-1] if st else None

    def current_traceparent(self) -> Optional[str]:
        sp = self.current_span()
        return sp.traceparent if sp is not None else None

    # -- span lifecycle ----------------------------------------------------

    def start_span(
        self,
        name: str,
        parent: Optional[Span] = None,
        traceparent: Optional[str] = None,
        attributes: Optional[Dict[str, Any]] = None,
        tail_sample: bool = False,
    ) -> Span:
        """Open a span. Parent resolution: explicit ``parent`` span >
        the calling thread's current span > ``traceparent`` header > new
        root (fresh trace_id). Thread context outranks the header on
        purpose: in the hermetic deployment the pod thread's ambient span
        (kubelet.launch) is already a continuation of the trace the
        header names, one hop deeper — the header is the cross-PROCESS
        fallback where no ambient context can exist.

        ``tail_sample=True`` marks this span as the trace's tail-sampling
        DECISION span (requires a sampler): every span of the trace
        buffers until this one ends, then the sampler's verdict flushes
        or drops them all — and binds late finishers the same way."""
        if not self.enabled:
            return _NOOP_SPAN  # type: ignore[return-value]
        parent_id: Optional[str] = None
        trace_id: Optional[str] = None
        if parent is not None and parent.trace_id:
            trace_id, parent_id = parent.trace_id, parent.span_id
        if trace_id is None:
            cur = self.current_span()
            if cur is not None:
                trace_id, parent_id = cur.trace_id, cur.span_id
        if trace_id is None and traceparent:
            parsed = parse_traceparent(traceparent)
            if parsed is not None:
                trace_id, parent_id = parsed
        if trace_id is None:
            trace_id = _gen_id(16)
        span = Span(
            name=name,
            trace_id=trace_id,
            span_id=_gen_id(8),
            parent_id=parent_id,
            start_time=time.time(),
            attributes=dict(attributes or {}),
            _tracer=self,
        )
        if tail_sample and self.sampler is not None:
            span.tail_decision = True
            overflow: List[Span] = []
            with self._lock:
                if span.trace_id not in self._pending:
                    while len(self._pending) >= MAX_PENDING_TRACES:
                        # a leaked decision span must not pin buffers
                        # forever: evict the oldest undecided trace
                        _tid, buf = self._pending.popitem(last=False)
                        overflow.extend(buf)
                    self._pending[span.trace_id] = []
            if overflow:
                self._count_dropped(len(overflow), "pending_overflow")
        self._stack().append(span)
        return span

    def _finish(self, span: Span) -> None:
        if span.end_time is None:
            span.end_time = time.time()
        st = self._stack()
        for i, s in enumerate(st):  # pop it and anything leaked above it
            if s is span:
                del st[i:]
                break
        self._append(span)

    def _ring_locked(self, span: Span, dropped: List[Tuple[int, str]]) -> None:
        if (
            self._spans.maxlen is not None
            and len(self._spans) == self._spans.maxlen
        ):
            dropped.append((1, "ring_full"))  # the evicted oldest span
        self._spans.append((self._next_seq, span))
        self._next_seq += 1

    def _set_verdict_locked(self, trace_id: str, keep: bool) -> None:
        self._verdicts[trace_id] = keep
        self._verdicts.move_to_end(trace_id)
        while len(self._verdicts) > MAX_VERDICTS:
            self._verdicts.popitem(last=False)

    def _count_dropped(self, n: int, reason: str) -> None:
        with self._lock:
            self.dropped[reason] = self.dropped.get(reason, 0) + n
        m = self._metrics
        if m is not None:
            m.inc(
                "tfk8s_trace_spans_dropped_total", float(n),
                {"reason": reason},
            )

    def _append(self, span: Span) -> None:
        dropped: List[Tuple[int, str]] = []
        with self._lock:
            if self.sampler is None:
                self._ring_locked(span, dropped)
            elif span.tail_decision:
                # the decision point: verdict covers the buffered spans,
                # this span, and every late finisher of the trace
                buffered = self._pending.pop(span.trace_id, [])
                keep, reason = self.sampler.decide(span)
                span.attributes.setdefault("sampling.reason", reason)
                self._set_verdict_locked(span.trace_id, keep)
                if keep:
                    for s in buffered:
                        self._ring_locked(s, dropped)
                    self._ring_locked(span, dropped)
                else:
                    dropped.append((len(buffered) + 1, "sampled"))
            elif span.trace_id in self._pending:
                buf = self._pending[span.trace_id]
                if len(buf) >= MAX_PENDING_SPANS_PER_TRACE:
                    dropped.append((1, "pending_overflow"))
                else:
                    buf.append(span)
            elif span.trace_id in self._verdicts:
                if self._verdicts[span.trace_id]:
                    self._ring_locked(span, dropped)
                else:
                    dropped.append((1, "sampled"))
            else:
                # no decision span ever opened for this trace (the whole
                # control plane): unsampled, straight to the ring
                self._ring_locked(span, dropped)
        for n, reason in dropped:
            self._count_dropped(n, reason)

    def verdict(self, trace_id: str) -> Optional[bool]:
        """The tail-sampling verdict for a trace: True kept, False
        dropped, None undecided/unknown."""
        if not trace_id:
            return None
        with self._lock:
            return self._verdicts.get(trace_id)

    def record_span(
        self,
        name: str,
        start: float,
        end: float,
        parent: Optional[Span] = None,
        traceparent: Optional[str] = None,
        attributes: Optional[Dict[str, Any]] = None,
        status: str = "ok",
        events: Optional[List[Dict[str, Any]]] = None,
    ) -> Span:
        """Record an already-elapsed interval (e.g. the measured
        time-in-queue before a reconcile span existed) without touching
        the thread-local stack. ``events`` pre-loads the span's timeline
        (the decode loop builds a request's token events off-span and
        attaches them all at retirement)."""
        if not self.enabled:
            return _NOOP_SPAN  # type: ignore[return-value]
        parent_id: Optional[str] = None
        trace_id: Optional[str] = None
        if parent is not None and parent.trace_id:
            trace_id, parent_id = parent.trace_id, parent.span_id
        elif traceparent:
            parsed = parse_traceparent(traceparent)
            if parsed is not None:
                trace_id, parent_id = parsed
        if trace_id is None:
            trace_id = _gen_id(16)
        span = Span(
            name=name,
            trace_id=trace_id,
            span_id=_gen_id(8),
            parent_id=parent_id,
            start_time=start,
            end_time=end,
            attributes=dict(attributes or {}),
            status=status,
        )
        for ev in events or []:
            span.add_event(
                str(ev.get("name", "")),
                ev.get("attributes"),
                ts=ev.get("ts"),
            )
        self._append(span)
        return span

    # -- read side ---------------------------------------------------------

    def spans(self) -> List[Span]:
        with self._lock:
            return [s for _seq, s in self._spans]

    def traces(self) -> Dict[str, List[Span]]:
        """trace_id -> spans sorted by start time, traces ordered by their
        earliest span (oldest trace first)."""
        by_trace: Dict[str, List[Span]] = {}
        for sp in self.spans():
            by_trace.setdefault(sp.trace_id, []).append(sp)
        out: Dict[str, List[Span]] = {}
        for tid, sps in sorted(
            by_trace.items(), key=lambda kv: min(s.start_time for s in kv[1])
        ):
            out[tid] = sorted(sps, key=lambda s: s.start_time)
        return out

    def trace(self, trace_id: str) -> List[Span]:
        return sorted(
            (s for s in self.spans() if s.trace_id == trace_id),
            key=lambda s: s.start_time,
        )

    def find_spans(self, name: str) -> List[Span]:
        return [s for s in self.spans() if s.name == name]

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    # -- export ------------------------------------------------------------

    def to_jsonl(self) -> str:
        return "".join(json.dumps(s.to_dict()) + "\n" for s in self.spans())

    def export_jsonl(self, path: str) -> int:
        """Append spans not yet exported to ``path`` (each span is written
        exactly once across repeated calls — periodic exporters must not
        duplicate the still-buffered ring); returns the count written."""
        with self._lock:
            fresh = [(seq, s) for seq, s in self._spans if seq > self._exported_seq]
        if not fresh:
            return 0
        with open(path, "a") as f:
            for _seq, s in fresh:
                f.write(json.dumps(s.to_dict()) + "\n")
        with self._lock:
            self._exported_seq = max(self._exported_seq, fresh[-1][0])
        return len(fresh)


def recent_request_traces(
    tracer: Tracer,
    trace_id: Optional[str] = None,
    limit: int = 32,
) -> List[Dict[str, Any]]:
    """The /debug/requests view: recently-kept REQUEST traces (those
    anchored by a tail-sampling decision span), newest first. Each entry
    is ``{"trace_id", "root", "spans"}`` with spans sorted by start time.
    ``trace_id`` narrows to one trace; ``limit`` bounds the reply."""
    by_trace: Dict[str, List[Span]] = {}
    order: List[str] = []
    for sp in tracer.spans():
        if trace_id is not None and sp.trace_id != trace_id:
            continue
        if sp.trace_id not in by_trace:
            by_trace[sp.trace_id] = []
            order.append(sp.trace_id)
        by_trace[sp.trace_id].append(sp)
    out: List[Dict[str, Any]] = []
    for tid in reversed(order):  # newest arrivals last in the ring
        sps = sorted(by_trace[tid], key=lambda s: s.start_time)
        root = next((s for s in sps if s.tail_decision), None)
        if root is None:
            continue  # control-plane trace, not a request
        out.append({
            "trace_id": tid,
            "root": root.to_dict(),
            "spans": [s.to_dict() for s in sps],
        })
        if len(out) >= limit:
            break
    return out


_default_tracer = Tracer()


def get_tracer() -> Any:
    """The tracer of the node agent attached to a pod of this process when
    that agent is another package's (``node_agent.attach``), else the
    process-wide tracer that the port's controller, kubelet and trainer
    threads share (one ring, which makes the single e2e trace real)."""
    agent = node_agent.tracer_agent()
    if agent is not None:
        return agent.get_tracer()
    return _default_tracer


def set_tracer(tracer: Tracer) -> Tracer:
    """Swap the process default (tests / bench isolation); returns the
    previous one so callers can restore it."""
    global _default_tracer
    prev = _default_tracer
    _default_tracer = tracer
    return prev
