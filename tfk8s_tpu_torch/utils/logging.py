"""Logging, events and metrics for the port.

``get_logger`` keeps the JAX package's logger naming (``tfk8s.<name>``),
so the port's logs read like the reference's. ``init_logging``, ``Event``
and ``EventRecorder`` (the control plane's structured event log, mirrored
into the cluster as Event objects) and ``Metrics`` (the labeled
counter/gauge/histogram registry with Prometheus exposition, which the
port's controller and serving executor record into under the reference's
names and labels) are copies of the reference's ``utils/logging.py``.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

_FORMAT = "%(asctime)s %(levelname).1s %(name)s] %(message)s"
_configured = False


def init_logging(level: int = logging.INFO) -> None:
    """The 'initlog' step of startup (images/tf2.png)."""
    global _configured
    if not _configured:
        logging.basicConfig(level=level, format=_FORMAT)
        _configured = True


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(f"tfk8s.{name}")


@dataclasses.dataclass
class Event:
    """One structured control-plane event (job created, gang admitted,
    pod failed, ...)."""

    timestamp: float
    kind: str
    key: str  # namespace/name of the involved object
    reason: str
    message: str = ""


class EventRecorder:
    """Append-only in-memory event log; tests and the CLI 'describe' read
    it. With a ``sink`` clientset, every event is ALSO mirrored into the
    cluster as a core/v1-style Event object (api/types.py Event),
    k8s-aggregated — one object per (involved object, reason) with a
    bumped count — so clients read event history through the apiserver
    instead of the operator process. Best-effort: sink failures never
    break the reconcile path that emitted the event."""

    def __init__(self, capacity: int = 4096, sink=None):
        self._lock = threading.Lock()
        self._events: List[Event] = []
        self._capacity = capacity
        self._sink = sink
        self._queue = None
        if sink is not None:
            # mirror ASYNCHRONOUSLY (k8s records events via a broadcaster
            # for the same reason): the sink does REST round-trips through
            # the operator's rate-limited client, and reconcile workers
            # must never stall behind event bookkeeping
            import queue

            self._queue = queue.Queue(maxsize=4096)
            threading.Thread(
                target=self._mirror_loop, name="event-mirror", daemon=True
            ).start()

    def event(self, kind: str, key: str, reason: str, message: str = "") -> None:
        ev = Event(time.time(), kind, key, reason, message)
        with self._lock:
            self._events.append(ev)
            if len(self._events) > self._capacity:
                self._events = self._events[-self._capacity :]
        get_logger("events").info("%s %s %s %s", kind, key, reason, message)
        if self._queue is not None:
            try:
                self._queue.put_nowait(ev)
            except Exception:  # noqa: BLE001 — full queue: drop, best-effort
                pass

    def _mirror_loop(self) -> None:
        while True:
            ev = self._queue.get()
            try:
                self._mirror(ev)
            except Exception as e:  # noqa: BLE001 — events are best-effort
                get_logger("events").debug("event sink failed: %s", e)
            finally:
                self._queue.task_done()

    def flush(self) -> None:
        """Block until every queued event has been mirrored (tests)."""
        if self._queue is not None:
            self._queue.join()

    def _mirror(self, ev: Event) -> None:
        from tfk8s_tpu_torch.api import types as t
        from tfk8s_tpu_torch.client.store import AlreadyExists, Conflict, NotFound

        ns, _, obj_name = ev.key.partition("/")
        ns = ns or "default"
        # deterministic per (kind, object, reason): repeats aggregate. The
        # kind is part of the identity — a Pod and a TPUJob sharing a name
        # in one namespace must not merge into one Event.
        name = f"{ev.kind.lower()}.{obj_name}.{ev.reason.lower()}"
        client = self._sink.generic("Event", ns)
        for _ in range(3):
            try:
                existing = client.get(name)
            except NotFound:
                try:
                    client.create(
                        t.Event(
                            metadata=t.ObjectMeta(name=name, namespace=ns),
                            involved_kind=ev.kind,
                            involved_key=ev.key,
                            reason=ev.reason,
                            message=ev.message,
                            count=1,
                            first_timestamp=ev.timestamp,
                            last_timestamp=ev.timestamp,
                        )
                    )
                    return
                except AlreadyExists:
                    continue
            existing.count += 1
            existing.last_timestamp = ev.timestamp
            existing.message = ev.message or existing.message
            try:
                client.update(existing)
                return
            except (Conflict, NotFound):
                continue

    def events(self, key: Optional[str] = None, reason: Optional[str] = None) -> List[Event]:
        with self._lock:
            return [
                e
                for e in self._events
                if (key is None or e.key == key) and (reason is None or e.reason == reason)
            ]


_DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0)


def _series_key(name: str, labels: Optional[Dict[str, str]]):
    """Series identity: (name, sorted label items) — one series per unique
    label set, the Prometheus data model."""
    if not labels:
        return (name, ())
    return (name, tuple(sorted((k, str(v)) for k, v in labels.items())))


def _escape_label_value(v: str) -> str:
    """Prometheus exposition escaping for label values: backslash, double
    quote, and newline (the three characters the format reserves)."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _sanitize_name(n: str) -> str:
    return n.replace(".", "_").replace("-", "_")


def _render_labels(lk, extra: str = "") -> str:
    """``(("job","a"),("ns","d"))`` -> ``{job="a",ns="d"}`` (values
    escaped); ``extra`` appends a pre-rendered pair (the histogram
    ``le``)."""
    pairs = ['{}="{}"'.format(k, _escape_label_value(v)) for k, v in lk]
    if extra:
        pairs.append(extra)
    return "{" + ",".join(pairs) + "}" if pairs else ""


class Metrics:
    """Counter/gauge/histogram registry with labeled series and Prometheus
    text exposition.

    Series identity is ``(name, labels)``: ``inc("pods_created_total",
    labels={"namespace": ns})`` and the same name with different labels
    are independent series, exposed as ``name{k="v",...} value`` with
    label values escaped per the exposition format. Per-object series
    (per-job training gauges) carry their owner as labels so deletion can
    GC them precisely with :meth:`remove_labels` — no name-prefix
    matching, no way to take out a neighbor's series by accident."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[Any, float] = {}
        self._gauges: Dict[Any, float] = {}
        # series key -> [bucket counts..., +inf count], plus _sum
        self._hist_counts: Dict[Any, List[float]] = {}
        self._hist_sum: Dict[Any, float] = {}
        # (series key, bucket index) -> (trace_id, observed value): the
        # most recent exemplar per bucket, linking the bucket to a kept
        # trace in the exposition (OpenMetrics-style " # {...}" suffix)
        self._hist_exemplars: Dict[Any, Dict[int, Tuple[str, float]]] = {}
        self._help: Dict[str, str] = {}

    # -- write side --------------------------------------------------------

    def describe(self, name: str, help_text: str) -> None:
        """Register a ``# HELP`` line for ``name`` (optional; exposition
        emits it ahead of the family's ``# TYPE`` line when present)."""
        with self._lock:
            self._help[name] = help_text

    def inc(
        self, name: str, value: float = 1.0,
        labels: Optional[Dict[str, str]] = None,
    ) -> None:
        key = _series_key(name, labels)
        with self._lock:
            self._counters[key] = self._counters.get(key, 0.0) + value

    def set_gauge(
        self, name: str, value: float,
        labels: Optional[Dict[str, str]] = None,
    ) -> None:
        with self._lock:
            self._gauges[_series_key(name, labels)] = value

    def observe(
        self, name: str, value: float,
        labels: Optional[Dict[str, str]] = None,
        exemplar: Optional[str] = None,
    ) -> None:
        """Record one histogram observation (e.g. a sync latency).
        ``exemplar`` is a trace id to pin on the bucket the observation
        lands in — exposition renders it as the OpenMetrics
        ``# {trace_id="..."} value`` suffix so a slow bucket links to a
        kept trace. Last writer per bucket wins."""
        key = _series_key(name, labels)
        with self._lock:
            counts = self._hist_counts.setdefault(
                key, [0.0] * (len(_DEFAULT_BUCKETS) + 1)
            )
            for i, ub in enumerate(_DEFAULT_BUCKETS):
                if value <= ub:
                    counts[i] += 1
                    bucket = i
                    break
            else:
                counts[-1] += 1
                bucket = len(_DEFAULT_BUCKETS)
            self._hist_sum[key] = self._hist_sum.get(key, 0.0) + value
            if exemplar:
                self._hist_exemplars.setdefault(key, {})[bucket] = (
                    exemplar, value,
                )

    # -- read side ---------------------------------------------------------

    def get_counter(
        self, name: str, labels: Optional[Dict[str, str]] = None
    ) -> Optional[float]:
        with self._lock:
            return self._counters.get(_series_key(name, labels))

    def get_gauge(
        self, name: str, labels: Optional[Dict[str, str]] = None
    ) -> Optional[float]:
        with self._lock:
            return self._gauges.get(_series_key(name, labels))

    def remove_labels(self, match: Dict[str, str]) -> int:
        """Label-based GC: drop every series (any name) whose label set
        contains ALL of ``match``'s pairs — per-job series must die with
        their job or a long-lived operator leaks memory and scrapes stale
        values. Returns the number of series removed."""
        want = set((k, str(v)) for k, v in match.items())
        removed = 0
        with self._lock:
            for table in (
                self._counters, self._gauges, self._hist_counts,
                self._hist_sum, self._hist_exemplars,
            ):
                doomed = [k for k in table if want.issubset(set(k[1]))]
                for k in doomed:
                    del table[k]
                # _hist_sum/_hist_exemplars share keys with _hist_counts;
                # one series each (identity, not ==: two empty tables
                # compare equal and would double-count)
                if any(
                    table is t for t in
                    (self._counters, self._gauges, self._hist_counts)
                ):
                    removed += len(doomed)
        return removed

    @staticmethod
    def _flat(key) -> str:
        name, lk = key
        return name + _render_labels(lk)

    def snapshot(self) -> Dict[str, Any]:
        """Flattened view for tests/CLI: unlabeled series keep their plain
        name; labeled ones render as ``name{k="v",...}``."""
        with self._lock:
            hists = {}
            for key, counts in self._hist_counts.items():
                hists[self._flat(key)] = {
                    "count": sum(counts),
                    "sum": self._hist_sum.get(key, 0.0),
                }
            return {
                "counters": {self._flat(k): v for k, v in self._counters.items()},
                "gauges": {self._flat(k): v for k, v in self._gauges.items()},
                "histograms": hists,
            }

    def prometheus_text(self) -> str:
        """Prometheus exposition format: names sanitized (dots/dashes ->
        underscores), one ``# HELP``/``# TYPE`` header per metric family,
        label values escaped."""
        with self._lock:
            lines: List[str] = []
            seen: set = set()

            def header(raw_name: str, sname: str, kind: str) -> None:
                if sname in seen:
                    return
                seen.add(sname)
                help_text = self._help.get(raw_name)
                if help_text:
                    lines.append(f"# HELP {sname} {help_text}")
                lines.append(f"# TYPE {sname} {kind}")

            for (name, lk), v in sorted(
                self._counters.items(), key=lambda kv: kv[0]
            ):
                n = _sanitize_name(name)
                header(name, n, "counter")
                lines.append(f"{n}{_render_labels(lk)} {v}")
            for (name, lk), v in sorted(
                self._gauges.items(), key=lambda kv: kv[0]
            ):
                n = _sanitize_name(name)
                header(name, n, "gauge")
                lines.append(f"{n}{_render_labels(lk)} {v}")
            for (name, lk), counts in sorted(
                self._hist_counts.items(), key=lambda kv: kv[0]
            ):
                n = _sanitize_name(name)
                header(name, n, "histogram")
                exemplars = self._hist_exemplars.get((name, lk), {})

                def _ex(bucket: int) -> str:
                    ex = exemplars.get(bucket)
                    if ex is None:
                        return ""
                    tid, val = ex
                    return f' # {{trace_id="{_escape_label_value(tid)}"}} {val}'

                cum = 0.0
                for i, ub in enumerate(_DEFAULT_BUCKETS):
                    cum += counts[i]
                    le = 'le="{}"'.format(ub)
                    lines.append(
                        f"{n}_bucket{_render_labels(lk, le)} {cum}{_ex(i)}"
                    )
                cum += counts[-1]
                inf = 'le="+Inf"'
                lines.append(
                    f"{n}_bucket{_render_labels(lk, inf)} {cum}"
                    f"{_ex(len(_DEFAULT_BUCKETS))}"
                )
                lines.append(
                    f"{n}_sum{_render_labels(lk)} {self._hist_sum.get((name, lk), 0.0)}"
                )
                lines.append(f"{n}_count{_render_labels(lk)} {cum}")
            return "\n".join(lines) + "\n"
