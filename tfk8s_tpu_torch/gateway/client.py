"""Thin pipelined client for the gateway wire API.

One persistent keep-alive connection per calling thread (HTTP/1.1 —
requests pipeline back-to-back on a warm socket instead of paying a TCP
handshake each), the ``ServeError`` taxonomy re-materialized from the
typed wire envelopes, and the same shed discipline as the in-process
``ServeClient``: a 429 (``Overloaded`` or ``QuotaExceeded``) is retried
inside the caller's deadline after a jittered backoff seeded by the
server's ``Retry-After`` — shed traffic spreads out instead of
re-hammering the front door in lockstep.

The wire layer is hand-rolled over a raw socket rather than
``http.client``: the stdlib stack routes every response through the
email-package header parser (~100us/request) and ships the request as
two ``send()`` calls, which is most of the wire-vs-in-process QPS gap
at saturation. Here a request is ONE pre-built buffer and one
``sendall``, and the response parse is a few ``partition`` calls on a
buffered reader — the gateway always frames with Content-Length, and
anything that doesn't parse drops the connection and surfaces as a
connection error.
"""

from __future__ import annotations

import json
import socket
import threading
import time
from typing import Any, Dict, Optional, Tuple
from urllib.parse import urlsplit

from tfk8s_tpu_torch.client.store import NotFound, Unavailable
from tfk8s_tpu_torch.obs.trace import get_tracer
from tfk8s_tpu_torch.runtime.server import (
    DeadlineExceeded,
    InvalidRequest,
    Overloaded,
    QuotaExceeded,
    RequestFailed,
    jittered_backoff,
)
from tfk8s_tpu_torch.utils.logging import get_logger

log = get_logger("gateway.client")


def _parse_retry_after(value: Optional[str]) -> Optional[float]:
    # the gateway sends fractional seconds; tolerate anything numeric
    try:
        s = float(value)  # type: ignore[arg-type]
        return s if s > 0 else None
    except (TypeError, ValueError):
        return None


def _map_error(status: int, reason: str, message: str,
               details: Dict[str, Any],
               retry_after_s: Optional[float]) -> Exception:
    """Wire envelope -> the typed exception it left the gateway as."""
    if status == 429 and reason == "QuotaExceeded":
        return QuotaExceeded(
            str(details.get("tenant", "")),
            retry_after_s or float(details.get("retryAfterS", 0.05) or 0.05),
            reason=str(details.get("quota", "qps")),
        )
    if status == 429:
        return Overloaded(
            int(details.get("queueDepth", 0) or 0),
            int(details.get("queueLimit", 0) or 0),
            retry_after_s=retry_after_s,
        )
    if status == 400:
        return InvalidRequest(message)
    if status == 404:
        return NotFound(message)
    if status == 503:
        return Unavailable(message)
    if status == 504:
        return DeadlineExceeded(message)
    return RequestFailed(f"HTTP {status} {reason}: {message}")


class GatewayClient:
    """Client for one TPUServe through the gateway front door.

    ``request`` raises the same taxonomy as the in-process
    ``ServeClient.request`` (plus ``store.NotFound`` for an unknown
    serve), so call sites swap between the two transports unchanged.
    """

    OVERLOAD_BACKOFF_S = 0.05
    # bounded transport-failure retries (gateway unreachable, 503 with
    # nothing routable): the gateway already re-dispatches around a dead
    # replica internally, so the client's policy is a small, jittered
    # second chance — not an amplifier
    TRANSPORT_RETRIES = 2
    TRANSPORT_BACKOFF_S = 0.02

    def __init__(self, url: str, name: str, namespace: str = "default",
                 tenant: str = "", timeout_s: float = 30.0):
        sp = urlsplit(url)
        if not sp.hostname:
            raise InvalidRequest(f"gateway url missing host: {url!r}")
        self._host = sp.hostname
        self._port = sp.port or 80
        self._path = f"/v1/serve/{namespace}/{name}"
        self.tenant = tenant
        self._timeout = timeout_s
        # the invariant prefix of every request this client sends; only
        # Content-Length and the body differ between requests
        self._head = (
            f"POST {self._path} HTTP/1.1\r\n"
            f"Host: {self._host}:{self._port}\r\n"
            "Content-Type: application/json\r\n"
            + (f"X-Tenant: {tenant}\r\n" if tenant else "")
        ).encode("ascii")
        # the sticky routing token a disaggregated gateway returned on
        # the last 200 (``x-tfk8s-session``): echoed on every later
        # request so follow-up turns stay affine to the replica holding
        # the conversation's warm KV prefix. Single-pool gateways never
        # set it; ``reset_session()`` starts a fresh conversation.
        self.session: Optional[str] = None
        # one warm connection per thread: sockets are not safely shared
        # mid-request, and per-thread reuse is what keeps the wire path
        # pipelined under a threaded load generator
        self._local = threading.local()

    # -- connection management -----------------------------------------------

    def _conn(self) -> Tuple[socket.socket, Any]:
        sock = getattr(self._local, "sock", None)
        if sock is None:
            sock = socket.create_connection(
                (self._host, self._port), timeout=self._timeout
            )
            # the request goes out as one sendall, but keep Nagle off so
            # a retransmitted tail never waits on the peer's delayed ACK
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._local.sock = sock
            self._local.reader = sock.makefile("rb")
        return sock, self._local.reader

    def _drop_conn(self) -> None:
        sock = getattr(self._local, "sock", None)
        if sock is not None:
            self._local.sock = None
            reader, self._local.reader = self._local.reader, None
            try:
                reader.close()
                sock.close()
            except OSError:
                pass

    def close(self) -> None:
        self._drop_conn()

    def reset_session(self) -> None:
        """Forget the sticky routing token (a new conversation)."""
        self.session = None

    # -- wire ----------------------------------------------------------------

    def _roundtrip(self, body: bytes,
                   traceparent: str = "") -> Tuple[int, Dict[str, str], bytes]:
        """One POST over the warm connection; a connection gone stale
        between requests (server restart, idle FIN) gets ONE fresh-socket
        retry — the request was never processed, so this is safe.

        ``traceparent`` (per-request — each attempt carries its own span
        context) rides as the W3C header between the invariant prefix and
        the framing."""
        tp = (
            f"traceparent: {traceparent}\r\n".encode("ascii")
            if traceparent else b""
        )
        session = self.session
        if session:
            tp += f"x-tfk8s-session: {session}\r\n".encode("ascii")
        request = b"%s%sContent-Length: %d\r\n\r\n%s" % (
            self._head, tp, len(body), body
        )
        for attempt in (0, 1):
            sock, reader = self._conn()
            try:
                sock.sendall(request)
                return self._read_response(reader)
            except OSError:
                self._drop_conn()
                if attempt:
                    raise
        raise AssertionError("unreachable")

    def _read_response(self, reader: Any) -> Tuple[int, Dict[str, str], bytes]:
        """Parse one Content-Length-framed HTTP/1.1 response."""
        line = reader.readline(4096)
        if not line.startswith(b"HTTP/1."):
            # empty read = peer closed the idle connection; anything else
            # is a framing error — either way the socket is unusable
            raise ConnectionResetError(
                f"bad status line from gateway: {line[:80]!r}"
            )
        try:
            status = int(line.split(b" ", 2)[1])
        except (IndexError, ValueError):
            raise ConnectionResetError(f"bad status line: {line[:80]!r}")
        headers: Dict[str, str] = {}
        while True:
            line = reader.readline(4096)
            if line in (b"\r\n", b"\n"):
                break
            if not line:
                raise ConnectionResetError("connection closed mid-headers")
            name, _, value = line.partition(b":")
            headers[name.decode("latin-1").strip().lower()] = (
                value.decode("latin-1").strip()
            )
        try:
            n = int(headers.get("content-length", "0") or "0")
        except ValueError:
            # a garbled frame leaves unread body bytes on the socket —
            # surfacing it as a connection error makes _roundtrip DROP
            # the warm socket instead of handing the next request on
            # this thread the previous response's stale bytes
            raise ConnectionResetError(
                "bad Content-Length from gateway: "
                f"{headers.get('content-length')!r}"
            )
        data = reader.read(n) if n else b""
        if len(data) < n:
            raise ConnectionResetError("connection closed mid-body")
        if headers.get("connection", "").lower() == "close":
            self._drop_conn()
        return status, headers, data

    def request(self, payload: Any, timeout: float = 30.0) -> Any:
        """Submit one request through the gateway; retries shed (429)
        responses with jittered backoff inside ``timeout`` seconds.

        The whole exchange (every retry included) rides ONE
        ``gateway.client.request`` span whose context crosses the wire as
        the ``traceparent`` header — the server continues the trace, so
        client, gateway, and decode loop share one trace id. Retries
        annotate the span with typed ``retry`` events."""
        deadline = time.monotonic() + timeout
        shed_backoff = self.OVERLOAD_BACKOFF_S
        transport_backoff = self.TRANSPORT_BACKOFF_S
        transport_retries = 0
        attempt = 0
        with get_tracer().start_span(
            "gateway.client.request",
            attributes={"path": self._path, "tenant": self.tenant},
        ) as span:
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise DeadlineExceeded(
                        f"gateway request deadline ({timeout}s) exceeded"
                    )
                body = json.dumps(
                    {"payload": payload, "timeoutS": remaining}
                ).encode()
                attempt += 1
                try:
                    status, headers, data = self._roundtrip(
                        body, traceparent=span.traceparent
                    )
                except OSError as exc:
                    if transport_retries < self.TRANSPORT_RETRIES:
                        transport_retries += 1
                        delay = jittered_backoff(None, transport_backoff)
                        if delay < deadline - time.monotonic():
                            span.add_event("retry", {
                                "attempt": attempt,
                                "reason": "transport",
                                "backoff_s": delay,
                            })
                            time.sleep(delay)
                            transport_backoff = min(transport_backoff * 2, 0.5)
                            continue
                    raise Unavailable(f"gateway unreachable: {exc}") from exc
                if status == 200:
                    sess = headers.get("x-tfk8s-session")
                    if sess:
                        self.session = sess
                    span.set_attribute("http.status_code", 200)
                    return json.loads(data)["result"]
                try:
                    envelope = json.loads(data)
                except ValueError:
                    envelope = {}
                err = _map_error(
                    status,
                    str(envelope.get("reason", "")),
                    str(envelope.get("message", data[:200])),
                    envelope.get("details") or {},
                    _parse_retry_after(
                        {k.lower(): v for k, v in headers.items()}.get("retry-after")
                    ),
                )
                if isinstance(err, (Overloaded, QuotaExceeded)):
                    delay = jittered_backoff(err.retry_after_s, shed_backoff)
                    if delay < deadline - time.monotonic():
                        span.add_event("retry", {
                            "attempt": attempt,
                            "reason": type(err).__name__,
                            "status": status,
                            "backoff_s": delay,
                        })
                        time.sleep(delay)
                        shed_backoff = min(shed_backoff * 2, 1.0)
                        continue
                elif (isinstance(err, Unavailable)
                        and transport_retries < self.TRANSPORT_RETRIES):
                    # 503: a replica died mid-flight with the gateway's
                    # retry budget drained, or nothing was routable —
                    # both transient while the controller replaces the
                    # replica, so give it the same bounded second chance
                    transport_retries += 1
                    delay = jittered_backoff(None, transport_backoff)
                    if delay < deadline - time.monotonic():
                        span.add_event("retry", {
                            "attempt": attempt,
                            "reason": "Unavailable",
                            "status": status,
                            "backoff_s": delay,
                        })
                        time.sleep(delay)
                        transport_backoff = min(transport_backoff * 2, 0.5)
                        continue
                span.set_attribute("http.status_code", status)
                raise err
