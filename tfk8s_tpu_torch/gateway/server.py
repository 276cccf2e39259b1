"""TPUGateway HTTP server: the one wire entrance for inference traffic.

Same transport stack and idioms as ``client/apiserver.py`` (threaded
``http.server``, HTTP/1.1 keep-alive, per-request latency histograms,
``metav1.Status`` error envelopes) serving one route::

    POST /v1/serve/<namespace>/<name>
        body:    {"payload": <JSON payload>, "timeoutS": <float, opt>}
        headers: X-Tenant: <tenant id>        (default "default")
        200:     {"result": <model response>}

Status-code matrix (every error is typed — the ServeError taxonomy on
the wire; shed responses ALWAYS carry Retry-After)::

    400 InvalidRequest    unservable request (never retried)
    404 NotFound          no such TPUServe
    429 QuotaExceeded     the TENANT's bucket/concurrency budget
    429 Overloaded        cluster pressure (priority shed or replica queue)
    500 RequestFailed     model raised executing the batch
    503 Unavailable       no routable replica held until the deadline, OR
                          a replica failed mid-flight with the retry
                          budget exhausted (retriable by the caller)
    504 DeadlineExceeded  deadline elapsed while queued/executing
                          (``details.triedReplicas`` names the replicas
                          the dispatch loop burned the deadline on)

``Retry-After`` uses fractional seconds (e.g. ``0.087``): sub-second
backoff is the natural timescale of a batching queue and this is our
own client on both ends; integer-second rounding would quantize every
backoff to >= 1 s and idle the fleet. The Draining replicas a rollout
produces are never surfaced: the router drops them at drain start (the
in-process drain hook) and the dispatch loop retries the next-least-
loaded replica inside the caller's deadline — the wire keeps the
zero-failed-request contract the in-process client already had.

A copy of the JAX package's ``gateway/server.py``. It routes to the
replicas of the port's own table (``tfk8s_tpu_torch.runtime.server``),
where a port replica registers unwrapped under the port's kubelet, maps
the port's ``ServeError`` classes to status codes by ``isinstance``, and
subscribes to that table's drain hooks. A JAX-package gateway in the same
process keeps to its own table and hooks, so the two do not cross.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional, Tuple

from tfk8s_tpu_torch.client.ratelimit import TokenBucketRateLimiter
from tfk8s_tpu_torch.client.store import NotFound, Unavailable
from tfk8s_tpu_torch.gateway.admission import TenantAdmission
from tfk8s_tpu_torch.gateway.affinity import affinity_key_of
from tfk8s_tpu_torch.gateway.router import RouteTable
from tfk8s_tpu_torch.obs.trace import TailSampler, get_tracer, recent_request_traces
from tfk8s_tpu_torch.runtime import server as serving
from tfk8s_tpu_torch.runtime.handoff import (
    HandoffError,
    KVTransport,
    LocalKVTransport,
)
from tfk8s_tpu_torch.runtime.kvtier import CacheDirectory
from tfk8s_tpu_torch.runtime.server import (
    DeadlineExceeded,
    Draining,
    InvalidRequest,
    Overloaded,
    Preempted,
    QuotaExceeded,
    ReplicaUnavailable,
    ServeError,
    lookup_replica,
)
from tfk8s_tpu_torch.utils.logging import get_logger

log = get_logger("gateway")

# how long a fetched TPUServe spec (tenancy, queue limit) stays fresh
SPEC_TTL_S = 1.0
DEFAULT_TENANT = "default"
# server-side ceiling on a single request's deadline
MAX_TIMEOUT_S = 120.0
# Retry-After when a replica shed without a hint of its own
DEFAULT_RETRY_AFTER_S = 0.1
# in-flight recovery: transport-class re-dispatch attempts
# per request, AND a per-serve token bucket bounding the fleet-wide
# retry rate — a dying fleet must not amplify offered load into a
# retry storm
MAX_DISPATCH_RETRIES = 3
RETRY_BUDGET_QPS = 20.0
RETRY_BUDGET_BURST = 40


def _err_body(status: int, reason: str, message: str,
              details: Optional[Dict[str, Any]] = None) -> bytes:
    # the k8s metav1.Status failure envelope (apiserver parity)
    body = {
        "kind": "Status",
        "apiVersion": "v1",
        "status": "Failure",
        "code": status,
        "reason": reason,
        "message": message,
    }
    if details:
        body["details"] = details
    return json.dumps(body).encode()


def _wire_error(exc: Exception) -> Tuple[int, str, Dict[str, Any], Dict[str, str]]:
    """Map a typed error to (status, reason, details, extra_headers) —
    the one place the taxonomy meets HTTP status codes."""
    headers: Dict[str, str] = {}
    if isinstance(exc, QuotaExceeded):
        headers["Retry-After"] = f"{exc.retry_after_s:.3f}"
        return 429, "QuotaExceeded", {
            "tenant": exc.tenant,
            "quota": exc.reason,
            "retryAfterS": round(exc.retry_after_s, 3),
        }, headers
    if isinstance(exc, Overloaded):
        retry = exc.retry_after_s or DEFAULT_RETRY_AFTER_S
        headers["Retry-After"] = f"{retry:.3f}"
        return 429, "Overloaded", {
            "queueDepth": exc.queue_depth,
            "queueLimit": exc.queue_limit,
            "retryAfterS": round(retry, 3),
        }, headers
    if isinstance(exc, InvalidRequest):
        return 400, "InvalidRequest", {}, headers
    if isinstance(exc, NotFound):
        return 404, "NotFound", {}, headers
    if isinstance(exc, Unavailable):
        return 503, "Unavailable", _tried_details(exc), headers
    if isinstance(exc, DeadlineExceeded):
        return 504, "DeadlineExceeded", _tried_details(exc), headers
    if isinstance(exc, ReplicaUnavailable):
        # transport-class: the replica died mid-flight and the retry
        # budget ran out — retriable by the caller, NOT a model failure
        return 503, "Unavailable", _tried_details(exc), headers
    if isinstance(exc, Preempted):
        # the row was evicted for a higher-priority admission and its
        # spill failed — nothing about the request is suspect, the
        # caller may simply resubmit (503, retriable, like a shed)
        return 503, "Preempted", {}, headers
    if isinstance(exc, HandoffError):
        # the decode pool refused the prefill pool's KV buffer (version
        # skew mid-rollout, geometry mismatch, integrity failure): a
        # between-replicas failure, not the caller's and not the model's
        return 502, "HandoffFailed", {}, headers
    # Draining should be absorbed by the dispatch loop; RequestFailed and
    # any other ServeError are the model's failure, a plain 500
    return 500, "RequestFailed", {}, headers


def _tried_details(exc: Exception) -> Dict[str, Any]:
    """The replicas the dispatch loop burned the deadline on, for the
    Status envelope details."""
    tried = getattr(exc, "tried", None)
    return {"triedReplicas": list(tried)} if tried else {}


def debug_requests(tracer, inflight: Optional[list] = None,
                   trace_id: Optional[str] = None,
                   limit: int = 32) -> Dict[str, Any]:
    """The ``/debug/requests`` zpage body: in-flight requests plus the
    recently tail-sampled request timelines — one shape shared by the
    gateway, the apiserver, and the operator server."""
    return {
        "inflight": list(inflight or []),
        "recent": recent_request_traces(
            tracer, trace_id=trace_id, limit=limit
        ),
        "spans_dropped": dict(tracer.dropped),
    }


def debug_decode() -> Dict[str, Any]:
    """The ``/debug/decode`` zpage body: live slot/page occupancy per
    registered replica (decode loops report slots; batchers their
    queue)."""
    replicas: Dict[str, Any] = {}
    for key in serving.replica_keys():
        server = serving.lookup_replica(key)
        if server is None:
            continue
        state_fn = getattr(server, "debug_state", None)
        if state_fn is not None:
            replicas[key] = state_fn()
    return {"replicas": replicas}


class _LeanHeaders(dict):
    """Header mapping with case-insensitive ``get`` — keys are stored
    lowercased by the fast-path parser below."""

    def get(self, key, default=None):  # type: ignore[override]
        return dict.get(self, key.lower(), default)


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # response header block and body are separate send()s: without
    # TCP_NODELAY, Nagle + the peer's delayed ACK stalls the tail of
    # every response ~40ms — dwarfing the actual serving latency
    disable_nagle_algorithm = True
    server: "GatewayServer"

    # Date header cache: (whole_second, formatted) — strftime per response
    # is measurable at saturation and the value only changes once a second
    _date_cache = (-1, "")

    def log_message(self, *a):  # route through our logger, debug level
        log.debug("http: " + a[0], *a[1:])

    def parse_request(self) -> bool:
        """Fast-path request parse for the serving hot loop.

        The stdlib implementation funnels every request's headers through
        the email-package parser (~100us on one core — a third of the
        whole wire budget at saturation). Plain ``HTTP/1.x`` requests take
        a split/partition parse instead; anything unusual falls back to
        the stdlib parser before any header bytes are consumed.
        """
        self.close_connection = True
        try:
            requestline = self.raw_requestline.decode("latin-1")
            command, path, version = requestline.rstrip("\r\n").split(" ")
        except (UnicodeDecodeError, ValueError):
            return super().parse_request()
        if version not in ("HTTP/1.1", "HTTP/1.0"):
            return super().parse_request()
        self.requestline = requestline.rstrip("\r\n")
        self.command, self.path, self.request_version = command, path, version
        headers = _LeanHeaders()
        rfile = self.rfile
        while True:
            line = rfile.readline(65537)
            if line in (b"\r\n", b"\n", b""):
                break
            if len(line) > 65536:
                self.send_error(431)
                return False
            name, sep, value = line.partition(b":")
            if sep:
                headers[name.decode("latin-1").strip().lower()] = (
                    value.decode("latin-1").strip()
                )
        self.headers = headers
        conntype = (headers.get("connection") or "").lower()
        if conntype == "close":
            self.close_connection = True
        elif version == "HTTP/1.1":
            self.close_connection = False
        else:
            self.close_connection = conntype != "keep-alive"
        if (headers.get("expect", "").lower() == "100-continue"
                and version == "HTTP/1.1"):
            if not self.handle_expect_100():
                return False
        return True

    def date_time_string(self, timestamp=None):  # type: ignore[override]
        if timestamp is not None:
            return super().date_time_string(timestamp)
        now = int(time.time())
        cached = _Handler._date_cache
        if cached[0] == now:
            return cached[1]
        value = super().date_time_string(now)
        _Handler._date_cache = (now, value)
        return value

    def _send_json(self, status: int, payload: Any,
                   extra_headers: Optional[Dict[str, str]] = None) -> None:
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (extra_headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _send_status_error(
        self, status: int, reason: str, message: str,
        details: Optional[Dict[str, Any]] = None,
        extra_headers: Optional[Dict[str, str]] = None,
    ) -> None:
        body = _err_body(status, reason, message, details)
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (extra_headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:
        if self.path == "/healthz":
            self._send_json(200, {"status": "ok"})
            return
        path, _, query = self.path.partition("?")
        if path == "/debug/requests":
            params = dict(
                kv.split("=", 1) for kv in query.split("&") if "=" in kv
            )
            self._send_json(200, debug_requests(
                get_tracer(), self.server.inflight_snapshot(),
                trace_id=params.get("trace_id"),
                limit=int(params.get("limit", "32")),
            ))
            return
        if path == "/debug/decode":
            self._send_json(200, debug_decode())
            return
        if path == "/debug/routes":
            self._send_json(200, self.server.debug_routes())
            return
        self._send_status_error(404, "NotFound", self.path)

    def do_POST(self) -> None:
        parts = [p for p in self.path.split("/") if p]
        if len(parts) != 4 or parts[0] != "v1" or parts[1] != "serve":
            self._send_status_error(404, "NotFound", self.path)
            return
        namespace, name = parts[2], parts[3]
        tenant = self.headers.get("X-Tenant", "").strip() or DEFAULT_TENANT
        try:
            length = int(self.headers.get("Content-Length", "0"))
            body = json.loads(self.rfile.read(length) or b"{}")
        except (ValueError, TypeError):
            self._send_status_error(400, "BadRequest", "body must be JSON")
            return
        timeout = min(float(body.get("timeoutS") or 30.0), MAX_TIMEOUT_S)
        serve_label = f"{namespace}/{name}"
        m = self.server.metrics
        t0 = time.perf_counter()
        result = None
        err: Optional[Exception] = None
        code = 200
        # the request's ROOT span: continues the client's traceparent
        # header and anchors the trace's tail-sampling verdict at its end
        tracer = get_tracer()
        span = tracer.start_span(
            "gateway.request",
            traceparent=self.headers.get("traceparent"),
            attributes={"serve": serve_label, "tenant": tenant},
            tail_sample=True,
        )
        self.server.track_inflight(span, serve_label, tenant)
        meta: Dict[str, str] = {}
        try:
            with span:
                try:
                    result = self.server.dispatch(
                        namespace, name, tenant, body.get("payload"), timeout,
                        session=self.headers.get("x-tfk8s-session"),
                        meta=meta,
                    )
                except Exception as exc:  # noqa: BLE001 - typed wire errors
                    err = exc
                    code, reason, details, headers = _wire_error(exc)
                    if not isinstance(exc, (ServeError, NotFound, Unavailable)):
                        log.warning("gateway 500 on %s: %s", serve_label, exc)
                span.set_attribute("http.status_code", code)
                if err is not None:
                    span.set_status("error", f"{reason}: {err}")
        finally:
            self.server.untrack_inflight(span)
        # metrics land BEFORE the response bytes: a caller observing its
        # own 200 must find the series already incremented
        if m is not None:
            labels = {"serve": serve_label, "tenant": tenant}
            # exemplar only when the tail sampler KEPT the trace — a
            # bucket must never link to a trace that was dropped
            kept = tracer.verdict(span.trace_id) is True
            m.observe(
                "tfk8s_gateway_request_seconds",
                time.perf_counter() - t0, labels,
                exemplar=span.trace_id if kept else None,
            )
            m.inc("tfk8s_gateway_requests_total", 1.0,
                  {**labels, "code": str(code)})
            if code == 429:
                m.inc("tfk8s_gateway_shed_total", 1.0, {
                    **labels,
                    "reason": getattr(err, "shed_reason", None)
                    or getattr(err, "reason", None) or "overloaded",
                })
        if err is None:
            # disaggregated serves hand the caller its routing pin: echo
            # the session token on follow-up requests to stay affine to
            # the replica holding the conversation's warm KV prefix
            self._send_json(200, {"result": result}, extra_headers=(
                {"x-tfk8s-session": meta["session"]}
                if meta.get("session") else None
            ))
        else:
            self._send_status_error(code, reason, str(err), details, headers)


class _ServeState:
    """Per-TPUServe routing + admission, plus the TTL-cached spec bits
    the hot path needs (queue limit, tenancy). A disaggregated serve
    carries TWO route tables — one per phase pool, each discovering only
    its pool's pods; ``table`` aliases the prefill table there so the
    admission pressure signal reads the pool requests enter first."""

    __slots__ = ("table", "admission", "queue_limit", "fetched",
                 "retry_budget", "prefill", "decode", "page_size",
                 "kv_dir")

    def __init__(self, table: RouteTable,
                 prefill: Optional[RouteTable] = None,
                 decode: Optional[RouteTable] = None):
        self.table = table
        self.prefill = prefill
        self.decode = decode
        self.page_size = 0
        # cache directory (runtime/kvtier): present only when the serve
        # carries a KVTierPolicy — absent means ZERO directory traffic
        self.kv_dir: Optional[CacheDirectory] = None
        self.admission = TenantAdmission()
        self.queue_limit = 0
        self.fetched = 0.0
        # transport-failure re-dispatches debit this bucket (fleet-wide
        # per serve) — exhausted means the failure surfaces typed
        self.retry_budget = TokenBucketRateLimiter(
            RETRY_BUDGET_QPS, RETRY_BUDGET_BURST
        )

    @property
    def disagg(self) -> bool:
        return self.prefill is not None

    def named_tables(self) -> list:
        if self.prefill is not None:
            return [("prefill", self.prefill), ("decode", self.decode)]
        return [("", self.table)]


class GatewayServer(ThreadingHTTPServer):
    """Threaded HTTP serving front door over one clientset. ``port=0``
    binds an ephemeral port (tests); ``serve_background()`` runs on a
    daemon thread and returns the bound port."""

    daemon_threads = True
    # an open-loop load generator keeps many keep-alive connections
    request_queue_size = 128

    def __init__(self, clientset, host: str = "127.0.0.1", port: int = 0,
                 metrics=None):
        self._cs = clientset
        self.metrics = metrics
        if metrics is not None:
            metrics.describe(
                "tfk8s_gateway_request_seconds",
                "End-to-end wall time per gateway request, by serve/tenant.",
            )
            metrics.describe(
                "tfk8s_gateway_queue_seconds",
                "Admission + routing delay before a request's final "
                "dispatch to a replica.",
            )
            metrics.describe(
                "tfk8s_gateway_shed_total",
                "Requests shed with a typed 429, by tenant and reason "
                "(qps/concurrency/priority/overloaded).",
            )
            metrics.describe(
                "tfk8s_gateway_requests_total",
                "Gateway requests answered, by serve/tenant/status code.",
            )
            metrics.describe(
                "tfk8s_gateway_route_replicas",
                "Routable replicas in the route table, per serve.",
            )
            metrics.describe(
                "tfk8s_gateway_route_depth",
                "Least effective queue depth across routable replicas.",
            )
            metrics.describe(
                "tfk8s_gateway_ejections_total",
                "Replicas ejected from the routing set by the health "
                "state machine, by reason "
                "(errors/deadline/gray/probe).",
            )
            metrics.describe(
                "tfk8s_gateway_retries_total",
                "In-flight re-dispatches to a surviving replica, by "
                "reason (draining/transport).",
            )
            metrics.describe(
                "tfk8s_gateway_replica_removed_total",
                "Replicas removed from the route table, by reason "
                "(stale/drained/ejected).",
            )
            metrics.describe(
                "tfk8s_gateway_affinity_requests_total",
                "Affinity-routed picks, by route "
                "(affine=ring owner, spill=owner too deep, none=no key).",
            )
            metrics.describe(
                "tfk8s_gateway_affinity_ring_members",
                "Replicas on the prefix-affinity consistent-hash ring.",
            )
            metrics.describe(
                "tfk8s_gateway_kv_directory_total",
                "Cache-directory lookups on the dispatch path, by "
                "outcome (hit=fresh owner, stale=only expired reports, "
                "miss=no replica reported the prefix).",
            )
            metrics.describe(
                "tfk8s_disagg_handoffs_total",
                "Prefill->decode KV handoffs brokered by the gateway, "
                "by outcome.",
            )
            metrics.describe(
                "tfk8s_disagg_handoff_seconds",
                "Wall time of one KV handoff transfer (serialize + "
                "verify + deserialize).",
            )
            metrics.describe(
                "tfk8s_disagg_handoff_bytes",
                "Wire size of one KV handoff buffer.",
            )
        self.stopping = threading.Event()
        self._states: Dict[Tuple[str, str], _ServeState] = {}
        self._states_lock = threading.Lock()
        # request-scoped tracing: install a tail sampler on the process
        # tracer (request roots only — control-plane spans bypass it) and
        # wire the drop counter into this gateway's registry
        tracer = get_tracer()
        if tracer.sampler is None:
            tracer.set_sampler(TailSampler())
        if metrics is not None:
            tracer.set_metrics(metrics)
        # in-flight request table for /debug/requests (span id -> row)
        self._inflight: Dict[str, Dict[str, Any]] = {}
        self._inflight_lock = threading.Lock()
        # the KV handoff seam: one box, the transfer is a serialize/
        # verify/deserialize memcpy; a real-TPU deployment injects a
        # device-to-device KVTransport here instead
        self.transport: KVTransport = LocalKVTransport()
        # route tables learn of drains the instant replicas unregister
        self._drain_hook: Callable[[str], None] = self._on_drain
        serving.add_drain_hook(self._drain_hook)
        super().__init__((host, port), _Handler)

    # -- lifecycle -----------------------------------------------------------

    @property
    def port(self) -> int:
        return self.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.server_address[0]}:{self.port}"

    def serve_background(self) -> int:
        t = threading.Thread(target=self.serve_forever, daemon=True,
                             name="gateway")
        t.start()
        return self.port

    def shutdown(self) -> None:  # type: ignore[override]
        self.stopping.set()
        serving.remove_drain_hook(self._drain_hook)
        super().shutdown()

    def _on_drain(self, key: str) -> None:
        with self._states_lock:
            tables = [
                t for s in self._states.values()
                for _, t in s.named_tables()
            ]
        for table in tables:
            table.mark_draining(key)

    # -- /debug/requests in-flight table -------------------------------------

    def track_inflight(self, span, serve: str, tenant: str) -> None:
        if not span.span_id:
            return  # tracing disabled: _NoopSpan
        with self._inflight_lock:
            self._inflight[span.span_id] = {
                "trace_id": span.trace_id,
                "span_id": span.span_id,
                "serve": serve,
                "tenant": tenant,
                "start_time": span.start_time,
            }

    def untrack_inflight(self, span) -> None:
        if not span.span_id:
            return
        with self._inflight_lock:
            self._inflight.pop(span.span_id, None)

    def inflight_snapshot(self) -> list:
        now = time.time()
        with self._inflight_lock:
            rows = [dict(r) for r in self._inflight.values()]
        for r in rows:
            r["age_s"] = now - r["start_time"]
        return sorted(rows, key=lambda r: r["start_time"])

    # -- request path --------------------------------------------------------

    def state_for(self, namespace: str, name: str) -> _ServeState:
        """The (ns, name) routing/admission state, spec-refreshed within
        SPEC_TTL_S. Raises store.NotFound for an unknown TPUServe."""
        now = time.monotonic()
        with self._states_lock:
            state = self._states.get((namespace, name))
        if state is not None and now - state.fetched < SPEC_TTL_S:
            return state
        try:
            serve = self._cs.tpuserves(namespace).get(name)
        except NotFound:
            with self._states_lock:
                self._states.pop((namespace, name), None)
            raise
        disagg = serve.spec.disaggregation is not None
        with self._states_lock:
            state = self._states.get((namespace, name))
            if state is None or state.disagg != disagg:
                # (re)build: flipping disaggregation on/off swaps the
                # routing topology wholesale (the pods rolled anyway —
                # the block is part of the template hash)
                if disagg:
                    prefill = RouteTable(
                        self._cs, name, namespace, metrics=self.metrics,
                        phase="prefill", affinity=True,
                    )
                    decode = RouteTable(
                        self._cs, name, namespace, metrics=self.metrics,
                        phase="decode",
                    )
                    state = _ServeState(prefill, prefill=prefill,
                                        decode=decode)
                else:
                    state = _ServeState(RouteTable(
                        self._cs, name, namespace, metrics=self.metrics,
                    ))
                self._states[(namespace, name)] = state
            state.queue_limit = serve.spec.batching.queue_limit
            state.page_size = serve.spec.batching.page_size
            kv = getattr(serve.spec, "kv_tier", None)
            if kv is None:
                # policy absent: no directory, no polling — the serving
                # path is bit-identical to a pre-kvtier gateway
                state.kv_dir = None
            elif state.kv_dir is None:
                state.kv_dir = CacheDirectory(ttl_s=kv.directory_ttl_s)
            state.fetched = now
        state.admission.configure(serve.spec.tenancy)
        return state

    def _count_retry(self, serve: str, tenant: str, reason: str) -> None:
        if self.metrics is not None:
            self.metrics.inc("tfk8s_gateway_retries_total", 1.0, {
                "serve": serve, "tenant": tenant, "reason": reason,
            })

    def dispatch(self, namespace: str, name: str, tenant: str,
                 payload: Any, timeout: float,
                 session: Optional[str] = None,
                 meta: Optional[Dict[str, str]] = None) -> Any:
        """Admit, route least-loaded, submit; absorb Draining, vanished,
        and CRASHED replicas by re-routing to a survivor inside the
        deadline. A serve request is idempotent (a pure function of its
        payload), so a mid-flight transport failure is retriable —
        bounded per request by MAX_DISPATCH_RETRIES and fleet-wide by
        the serve's token-bucket retry budget. Every attempt's outcome
        feeds the router's health state machine.

        Disaggregated serves take the two-phase path instead: affine
        prefill, gateway-brokered KV handoff, least-loaded decode.
        ``session`` is the caller's sticky token; ``meta`` (when given)
        returns ``{"session": key}`` for the response header."""
        state = self.state_for(namespace, name)
        if state.disagg:
            return self._dispatch_disagg(
                state, namespace, name, tenant, payload, timeout,
                session=session, meta=meta,
            )
        serve_label = f"{namespace}/{name}"
        deadline = time.monotonic() + timeout
        t0 = time.perf_counter()
        # the handler's root span is ambient on this thread; its context
        # rides into the replica submit so the decode loop's timeline
        # lands in the SAME trace
        span = get_tracer().current_span()
        traceparent = span.traceparent if span is not None else None
        priority = state.admission.priority_of(tenant)
        release = state.admission.admit(
            tenant, state.table.least_depth(), state.queue_limit
        )
        try:
            exclude: set = set()
            tried: list = []
            transport_retries = 0
            backoff = 0.005
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    exc = DeadlineExceeded(
                        f"no replica of {serve_label} served the "
                        f"request within {timeout}s"
                    )
                    exc.tried = list(tried)
                    raise exc
                key = state.table.pick(exclude)
                if key is None:
                    if exclude:
                        exclude = set()  # full rescan before backing off
                        continue
                    if timeout - remaining + backoff > timeout * 0.5:
                        # half the deadline burned with NOTHING routable:
                        # surface it as capacity, not a deadline miss
                        exc = Unavailable(
                            f"{serve_label}: no routable replica"
                        )
                        exc.tried = list(tried)
                        raise exc
                    time.sleep(min(backoff, remaining))
                    backoff = min(backoff * 2, 0.25)
                    continue
                server = lookup_replica(key)
                if server is None:
                    # an in-flight request just DISCOVERED the replica's
                    # registry entry is gone — count the removal (it was
                    # silent before) and route around it
                    state.table.release(key)
                    state.table.remove(key, "ejected")
                    if span is not None:
                        span.add_event("replica.vanished", {"replica": key})
                    exclude.add(key)
                    continue
                submit_t0 = time.perf_counter()
                try:
                    if self.metrics is not None:
                        self.metrics.observe(
                            "tfk8s_gateway_queue_seconds",
                            time.perf_counter() - t0,
                            {"serve": serve_label},
                        )
                    result = server.submit(
                        payload, timeout=remaining, traceparent=traceparent,
                        tenant=tenant, priority=priority,
                    )
                    state.table.report_outcome(
                        key, "ok", time.perf_counter() - submit_t0
                    )
                    return result
                except Draining:
                    # rolling out from under us — retry the next-least-
                    # loaded replica (the zero-failed-request contract)
                    self._count_retry(serve_label, tenant, "draining")
                    if span is not None:
                        span.add_event("retry", {
                            "reason": "Draining", "replica": key,
                            "backoff_s": 0.0,
                        })
                    exclude.add(key)
                    continue
                except DeadlineExceeded as exc:
                    # the deadline died ON this replica: feed the health
                    # machine (ratio-based eject) and surface it typed
                    state.table.report_outcome(key, "deadline")
                    tried.append(key)
                    exc.tried = list(tried)
                    raise
                except (ReplicaUnavailable, OSError) as exc:
                    # the replica died mid-flight (crash, wire cut,
                    # connection reset) — retriable on a survivor while
                    # the deadline, attempt cap, and budget allow
                    state.table.report_outcome(key, "transport_error")
                    tried.append(key)
                    exclude.add(key)
                    transport_retries += 1
                    if (transport_retries <= MAX_DISPATCH_RETRIES
                            and state.retry_budget.try_accept()):
                        self._count_retry(serve_label, tenant, "transport")
                        if span is not None:
                            span.add_event("retry", {
                                "reason": "ReplicaUnavailable",
                                "replica": key,
                            })
                        continue
                    wrapped = ReplicaUnavailable(
                        f"{serve_label}: replica {key} failed mid-flight "
                        f"({exc}) with the retry budget exhausted"
                    )
                    wrapped.tried = list(tried)
                    raise wrapped from exc
                finally:
                    state.table.release(key)
        finally:
            release()

    def _dispatch_disagg(self, state: _ServeState, namespace: str,
                         name: str, tenant: str, payload: Any,
                         timeout: float, session: Optional[str] = None,
                         meta: Optional[Dict[str, str]] = None) -> Any:
        """The disaggregated request path: (1) prefill on the affinity
        ring's owner of the prompt's page-aligned prefix digest (warm KV
        prefix reuse), (2) a gateway-brokered KV page handoff, (3)
        decode on the least-loaded decode replica. The gateway holds the
        buffer between phases, so a decode replica dying mid-transfer is
        absorbed by re-picking a survivor — the prefill work is never
        repeated for a decode-side failure."""
        serve_label = f"{namespace}/{name}"
        deadline = time.monotonic() + timeout
        t0 = time.perf_counter()
        tracer = get_tracer()
        span = tracer.current_span()
        traceparent = span.traceparent if span is not None else None
        priority = state.admission.priority_of(tenant)
        # the affinity key: an explicit session token wins (follow-up
        # turns keep their pin even as the shared history grows past the
        # first page); otherwise the page-aligned prefix digest of the
        # prompt itself (co-locates prompts sharing a system prefix)
        raw = payload.get("tokens") if isinstance(payload, dict) else payload
        try:
            toks = [int(t) for t in raw] if raw is not None else []
        except (TypeError, ValueError):
            toks = []
        # the digest key is ALWAYS the prompt's first-page digest (it is
        # what replicas report to the cache directory); the ring key may
        # be the caller's opaque session token instead
        dkey = affinity_key_of(toks, state.page_size) if toks else None
        akey: Optional[str] = (session or "").strip() or dkey
        if meta is not None and akey:
            meta["session"] = akey
        # cache directory (runtime/kvtier): a fresh report naming a
        # replica that HOLDS this prefix overrides the ring's guess; if
        # the pick still lands elsewhere, the owner rides along as a
        # peer-fetch hint so the prefill replica can pull the warm pages
        # instead of recomputing them
        kv_owner: Optional[str] = None
        if state.kv_dir is not None and dkey is not None:
            self._kv_directory_refresh(state)
            kv_owner, outcome = state.kv_dir.lookup(dkey)
            if self.metrics is not None:
                self.metrics.inc("tfk8s_gateway_kv_directory_total", 1.0, {
                    "serve": serve_label, "outcome": outcome,
                })
            if span is not None:
                span.add_event("kv_directory.lookup", {
                    "outcome": outcome, "owner": kv_owner or "",
                })
        owner = kv_owner
        release = state.admission.admit(
            tenant, state.prefill.least_depth(), state.queue_limit
        )
        try:
            prefill_res = self._run_phase(
                state, state.prefill, serve_label, tenant, deadline,
                timeout, t0, span, akey,
                lambda srv, rem, key: srv.submit_prefill(
                    payload, timeout=rem, traceparent=traceparent,
                    tenant=tenant, priority=priority,
                    # hint only when the pick LOST the directory owner
                    # (spill, owner in the decode pool, owner ejected):
                    # a replica never peer-fetches from itself
                    kv_peer=(owner if owner and owner != key else ""),
                ),
                preferred=kv_owner,
            )
            buf = prefill_res["handoff"]
            nbytes = 0
            outcome = "ok"
            ht0 = time.perf_counter()
            try:
                with tracer.start_span("handoff.transfer", attributes={
                    "serve": serve_label,
                    "pages": buf.n_pages,
                }) as hs:
                    buf, nbytes = self.transport.transfer(buf)
                    hs.set_attribute("bytes", nbytes)
            except HandoffError:
                outcome = "corrupt"
                raise
            finally:
                if self.metrics is not None:
                    self.metrics.inc(
                        "tfk8s_disagg_handoffs_total", 1.0,
                        {"serve": serve_label, "outcome": outcome},
                    )
                    self.metrics.observe(
                        "tfk8s_disagg_handoff_seconds",
                        time.perf_counter() - ht0, {"serve": serve_label},
                    )
                    if nbytes:
                        self.metrics.observe(
                            "tfk8s_disagg_handoff_bytes", float(nbytes),
                            {"serve": serve_label},
                        )
            return self._run_phase(
                state, state.decode, serve_label, tenant, deadline,
                timeout, None, span, None,
                lambda srv, rem, key: srv.submit_handoff(
                    buf, timeout=rem, traceparent=traceparent,
                    tenant=tenant, priority=priority,
                ),
            )
        finally:
            release()

    def _kv_directory_refresh(self, state: _ServeState) -> None:
        """Pull ``kv_digest_report`` from every routable replica of the
        serve (both phase pools — decode replicas hold imported prefixes
        too) into the cache directory. Rate-limited by the directory's
        own ``should_poll`` throttle (ttl/2), so the hot path amortizes
        the sweep; a replica that vanished or predates the report API
        simply drops out of the directory at its next TTL expiry."""
        kv_dir = state.kv_dir
        if kv_dir is None or not kv_dir.should_poll():
            return
        for _, table in state.named_tables():
            if table is None:
                continue
            for key, _depth in table.targets():
                server = lookup_replica(key)
                report_fn = getattr(server, "kv_digest_report", None)
                if report_fn is None:
                    kv_dir.forget(key)
                    continue
                try:
                    kv_dir.report(key, report_fn())
                except Exception:  # noqa: BLE001 - a dying replica's
                    # report must never fail the request being routed
                    kv_dir.forget(key)

    def _run_phase(self, state: _ServeState, table: RouteTable,
                   serve_label: str, tenant: str, deadline: float,
                   timeout: float, t0: Optional[float], span,
                   affinity_key: Optional[str], call,
                   preferred: Optional[str] = None) -> Any:
        """One phase of a disaggregated dispatch: the pick/submit/retry
        loop of :meth:`dispatch`, against ONE pool's route table.
        ``call(server, remaining, key)`` performs the phase's submit;
        the loop owns routing, outcome feedback, Draining/vanished/crash
        re-dispatch, and the typed surfacing contract. ``preferred`` is
        the cache directory's confirmed-warm replica, honored by the
        pick when routable; once excluded (drain, crash) the retry walk
        proceeds without it."""
        phase = table.phase or "serve"
        exclude: set = set()
        tried: list = []
        transport_retries = 0
        backoff = 0.005
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                exc = DeadlineExceeded(
                    f"no {phase} replica of {serve_label} served the "
                    f"request within {timeout}s"
                )
                exc.tried = list(tried)
                raise exc
            key = table.pick(exclude, affinity_key=affinity_key,
                             preferred=preferred)
            if key is None:
                if exclude:
                    exclude = set()  # full rescan before backing off
                    continue
                if timeout - remaining + backoff > timeout * 0.5:
                    exc = Unavailable(
                        f"{serve_label}: no routable {phase} replica"
                    )
                    exc.tried = list(tried)
                    raise exc
                time.sleep(min(backoff, remaining))
                backoff = min(backoff * 2, 0.25)
                continue
            server = lookup_replica(key)
            if server is None:
                table.release(key)
                table.remove(key, "ejected")
                if span is not None:
                    span.add_event("replica.vanished", {"replica": key})
                exclude.add(key)
                continue
            submit_t0 = time.perf_counter()
            try:
                if t0 is not None and self.metrics is not None:
                    # admission+routing delay lands once, on the phase
                    # requests enter first (prefill)
                    self.metrics.observe(
                        "tfk8s_gateway_queue_seconds",
                        time.perf_counter() - t0, {"serve": serve_label},
                    )
                    t0 = None
                result = call(server, remaining, key)
                table.report_outcome(
                    key, "ok", time.perf_counter() - submit_t0
                )
                return result
            except Draining:
                self._count_retry(serve_label, tenant, "draining")
                if span is not None:
                    span.add_event("retry", {
                        "reason": "Draining", "replica": key,
                        "phase": phase, "backoff_s": 0.0,
                    })
                exclude.add(key)
                continue
            except DeadlineExceeded as exc:
                table.report_outcome(key, "deadline")
                tried.append(key)
                exc.tried = list(tried)
                raise
            except (ReplicaUnavailable, OSError) as exc:
                # the phase target died mid-flight. For decode this is
                # the handoff-target-dies case: the gateway still holds
                # the buffer, so a survivor takes the SAME handoff
                table.report_outcome(key, "transport_error")
                tried.append(key)
                exclude.add(key)
                transport_retries += 1
                if (transport_retries <= MAX_DISPATCH_RETRIES
                        and state.retry_budget.try_accept()):
                    self._count_retry(serve_label, tenant, "transport")
                    if span is not None:
                        span.add_event("retry", {
                            "reason": "ReplicaUnavailable",
                            "replica": key, "phase": phase,
                        })
                    continue
                wrapped = ReplicaUnavailable(
                    f"{serve_label}: {phase} replica {key} failed "
                    f"mid-flight ({exc}) with the retry budget exhausted"
                )
                wrapped.tried = list(tried)
                raise wrapped from exc
            finally:
                table.release(key)

    # -- /debug/routes -------------------------------------------------------

    def debug_routes(self) -> Dict[str, Any]:
        """The ``/debug/routes`` zpage body: every serve's route table(s)
        — replica, health state, effective depth, in-flight — plus the
        affinity ring's ownership map where prefix routing is on."""
        with self._states_lock:
            items = list(self._states.items())
        serves: Dict[str, Any] = {}
        for (ns, name), st in items:
            entry: Dict[str, Any] = {}
            for phase, table in st.named_tables():
                block: Dict[str, Any] = {"replicas": table.debug_rows()}
                ring = table.ring_describe()
                if ring is not None:
                    block["ring"] = ring
                entry[phase or "default"] = block
            if st.kv_dir is not None:
                # the KV economy's routing view: per-replica digest
                # counts, host-tier occupancy, and lookup outcomes
                entry["kv_directory"] = st.kv_dir.describe()
            serves[f"{ns}/{name}"] = entry
        return {"serves": serves}
