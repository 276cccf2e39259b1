"""HTTP apiserver: serves a ClusterStore over REST — the out-of-process
L0 substrate.

The reference operator's whole point is talking to a *live* apiserver over
the network: kubeconfig → ``NewForConfig`` → rate-limited REST
(`k8s-operator.md:92-102`), resources exposed at
``/apis/<group>/<version>/namespaces/*/<plural>/...``
(`k8s-operator.md:33-34`), watches as long-lived streams feeding the
Reflector (images/informer1.png). This module is that process boundary:
the hermetic :class:`~tfk8s_tpu_torch.client.store.ClusterStore` behind real
HTTP, so an operator in one process and a kubelet in another reconcile
the same cluster state over the wire (client/remote.py is the client
half).

Route table (JSON bodies; ``gv`` = ``tfk8s.dev/v1alpha1``):

====== ============================================== =====================
verb   path                                           store call
====== ============================================== =====================
GET    /apis/{gv}/namespaces/{ns}/{plural}            list(kind, ns)
GET    /apis/{gv}/{plural}                            list(kind, all-ns)
GET    /apis/{gv}/{plural}?watch=1&resourceVersion=N  watch(kind, N) stream
POST   /apis/{gv}/namespaces/{ns}/{plural}            create(obj)
GET    /apis/{gv}/namespaces/{ns}/{plural}/{name}     get(kind, ns, name)
PUT    /apis/{gv}/namespaces/{ns}/{plural}/{name}     update(obj)
PUT    .../{name}/status                              update(obj) (status)
DELETE /apis/{gv}/namespaces/{ns}/{plural}/{name}     delete(kind, ns, name)
GET    /apis                                          discovery doc
====== ============================================== =====================

Error mapping follows the real protocol: 404 NotFound, 409 AlreadyExists /
Conflict (distinguished by ``reason``), 410 Gone (watch window expired →
client must relist). Watch responses are newline-delimited JSON events
``{"type": "ADDED|MODIFIED|DELETED", "object": {...}}`` streamed until the
client disconnects, with periodic ``{"type": "HEARTBEAT"}`` lines so a dead
peer is detected and the server-side watch reclaimed.

Security (the part of the reference's client stack whose whole point is a
*secured* apiserver — ``rest.Config`` carries TLS + credentials,
`k8s-operator.md:93-97`, images/tf5-tf6): pass ``tls=TLSServerConfig(...)``
to serve HTTPS (optionally verifying client certs against a CA), and
``auth=AuthConfig(...)`` to require credentials. Authentication accepts a
``Authorization: Bearer <token>`` header (static-token-file model) or a
CA-verified client certificate (identity = cert CN). With auth enabled:
no/unknown credentials → **401 Unauthorized**; a read-only identity
attempting a write → **403 Forbidden**; ``/healthz`` stays open for
liveness probes. Without ``auth``, requests run as ``system:anonymous``
(the hermetic default).
"""

from __future__ import annotations

import json
import socketserver
import ssl
import threading
import time
import urllib.parse
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

from tfk8s_tpu_torch import API_VERSION
from tfk8s_tpu_torch.api import serde
from tfk8s_tpu_torch.client.store import (
    AlreadyExists,
    ClusterStore,
    Conflict,
    Gone,
    Invalid,
    NotFound,
)
from tfk8s_tpu_torch.utils.logging import get_logger

log = get_logger("apiserver")

# plural REST segment <-> scheme kind (the CRD `names` mapping,
# k8s-operator.md:20-27)
PLURALS: Dict[str, str] = {
    "tpujobs": "TPUJob",
    "tpuserves": "TPUServe",
    "pods": "Pod",
    "services": "Service",
    "leases": "Lease",
    "events": "Event",
}
KIND_TO_PLURAL = {v: k for k, v in PLURALS.items()}

_HEARTBEAT_S = 2.0


@dataclass
class TLSServerConfig:
    """Serving certs. ``client_ca_file`` set → request client certificates
    during the handshake and accept CA-verified ones as an identity (mTLS);
    bearer tokens still work alongside."""

    cert_file: str
    key_file: str
    client_ca_file: Optional[str] = None


@dataclass
class User:
    """An authenticated caller. ``readonly`` callers get GET/watch only —
    the minimal authorization split that makes 403 (authorized ≠
    authenticated) real rather than theoretical."""

    name: str
    readonly: bool = False


@dataclass
class AuthConfig:
    """Static-token authentication (the k8s ``--token-auth-file`` model):
    bearer token → user. ``allow_client_certs`` additionally admits
    mTLS-verified peers (requires ``TLSServerConfig.client_ca_file``)."""

    tokens: Dict[str, User] = field(default_factory=dict)
    allow_client_certs: bool = True

    @staticmethod
    def from_token_file(path: str) -> "AuthConfig":
        """Parse ``token,user[,readonly]`` lines (CSV like the k8s static
        token file; blank lines and ``#`` comments skipped)."""
        tokens: Dict[str, User] = {}
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = [p.strip() for p in line.split(",")]
                if len(parts) < 2:
                    raise ValueError(f"token file line needs token,user: {line!r}")
                tokens[parts[0]] = User(
                    name=parts[1], readonly="readonly" in parts[2:]
                )
        return AuthConfig(tokens=tokens)


class _AdmissionRejected(Exception):
    """Invalid TPUJob write — mapped to 422 Invalid by the error sender."""


def _err_body(status: int, reason: str, message: str) -> bytes:
    # the k8s metav1.Status failure envelope
    return json.dumps(
        {
            "kind": "Status",
            "apiVersion": "v1",
            "status": "Failure",
            "code": status,
            "reason": reason,
            "message": message,
        }
    ).encode()


class _Handler(BaseHTTPRequestHandler):
    # HTTP/1.1 keep-alive for discrete requests; watch responses opt out
    # (Connection: close + no Content-Length → stream until disconnect).
    protocol_version = "HTTP/1.1"
    server: "APIServer"

    def log_message(self, *a):  # route through our logger, debug level
        log.debug("http: " + a[0], *a[1:])

    def setup(self) -> None:
        # Per-connection TLS: get_request hands us a not-yet-handshaken
        # SSLSocket (wrapping there, handshaking here, keeps a slow or
        # malicious peer from stalling the accept loop). Handshake errors
        # propagate to handle_error, which logs them at debug.
        if isinstance(self.request, ssl.SSLSocket):
            self.request.do_handshake()
        super().setup()

    # -- authn/authz --------------------------------------------------------

    def _send_status_error(
        self, status: int, reason: str, message: str,
        extra_headers: Optional[Dict[str, str]] = None,
    ) -> None:
        body = _err_body(status, reason, message)
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (extra_headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _authenticate(self) -> Optional[User]:
        """Resolve the caller's identity, or None (no valid credentials)."""
        auth = self.server.auth
        if auth is None:
            return User("system:anonymous")
        hdr = self.headers.get("Authorization", "")
        if hdr.startswith("Bearer "):
            return auth.tokens.get(hdr[len("Bearer "):].strip())
        if auth.allow_client_certs and isinstance(self.connection, ssl.SSLSocket):
            der = self.connection.getpeercert(binary_form=True)
            if der:  # CA-verified during the handshake (CERT_OPTIONAL)
                from tfk8s_tpu_torch.client.tlsutil import cert_common_name

                cn = cert_common_name(der)
                if cn:
                    return User(cn)
        return None

    def _gate(self, write: bool) -> Optional[User]:
        """The 401/403 boundary: returns the caller, or None after having
        sent the error. Anonymous/unknown credentials → 401 Unauthorized
        (with WWW-Authenticate, per RFC 6750); an authenticated read-only
        caller attempting a write → 403 Forbidden."""
        user = self._authenticate()
        if user is None or (write and user.readonly):
            # The gate fires BEFORE the request body is read; on HTTP/1.1
            # keep-alive the unread body bytes would be parsed as the next
            # request line — close the connection instead of desyncing it.
            self.close_connection = True
            if user is None:
                self._send_status_error(
                    401, "Unauthorized", "authentication required",
                    extra_headers={
                        "WWW-Authenticate": "Bearer", "Connection": "close",
                    },
                )
            else:
                self._send_status_error(
                    403, "Forbidden",
                    f'user "{user.name}" cannot write (read-only credential)',
                    extra_headers={"Connection": "close"},
                )
            return None
        return user

    # -- plumbing -----------------------------------------------------------

    def _send_json(self, status: int, payload: Any) -> None:
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_store_error(self, exc: Exception) -> None:
        if isinstance(exc, NotFound):
            status, reason = 404, "NotFound"
        elif isinstance(exc, AlreadyExists):
            status, reason = 409, "AlreadyExists"
        elif isinstance(exc, Conflict):
            status, reason = 409, "Conflict"
        elif isinstance(exc, Gone):
            status, reason = 410, "Gone"
        elif isinstance(exc, (Invalid, _AdmissionRejected)):
            status, reason = 422, "Invalid"
        else:
            status, reason = 500, "InternalError"
            log.warning("apiserver 500: %s", exc)
        self._send_status_error(status, reason, str(exc))

    def _read_body(self) -> Dict[str, Any]:
        length = int(self.headers.get("Content-Length", "0"))
        return json.loads(self.rfile.read(length) or b"{}")

    def _route(self) -> Optional[Tuple[str, Optional[str], Optional[str], bool, Dict[str, str]]]:
        """Parse path → (kind, namespace, name, is_status, query) or None."""
        parsed = urllib.parse.urlparse(self.path)
        query = {k: v[0] for k, v in urllib.parse.parse_qs(parsed.query).items()}
        parts = [p for p in parsed.path.split("/") if p]
        # /apis/{group}/{version}/...
        if len(parts) < 3 or parts[0] != "apis":
            return None
        gv = f"{parts[1]}/{parts[2]}"
        if gv != API_VERSION and gv != "core/v1":
            return None
        rest = parts[3:]
        is_status = False
        if rest and rest[-1] == "status":
            is_status = True
            rest = rest[:-1]
        if len(rest) >= 2 and rest[0] == "namespaces":
            ns: Optional[str] = rest[1]
            rest = rest[2:]
        else:
            ns = None
        if not rest or rest[0] not in PLURALS:
            return None
        kind = PLURALS[rest[0]]
        name = rest[1] if len(rest) > 1 else None
        return kind, ns, name, is_status, query

    # -- verbs --------------------------------------------------------------
    #
    # Each verb runs through _timed: with a metrics registry on the server,
    # discrete requests record a per-verb latency histogram + counter
    # (apiserver_request_seconds{verb=...}). Watch streams are excluded
    # from the histogram — a stream lives for minutes and would bury the
    # request latencies — and counted separately at stream open.

    def _timed(self, verb: str, handler) -> None:
        m = self.server.metrics
        if m is None:
            handler()
            return
        self._streaming = False
        t0 = time.perf_counter()
        try:
            handler()
        finally:
            if not self._streaming:
                labels = {"verb": verb}
                m.observe(
                    "apiserver.request_seconds",
                    time.perf_counter() - t0, labels,
                )
                m.inc("apiserver.requests_total", 1.0, labels)

    def do_GET(self) -> None:
        self._timed("GET", self._handle_get)

    def do_POST(self) -> None:
        self._timed("POST", self._handle_post)

    def do_PUT(self) -> None:
        self._timed("PUT", self._handle_put)

    def do_PATCH(self) -> None:
        self._timed("PATCH", self._handle_patch)

    def do_DELETE(self) -> None:
        self._timed("DELETE", self._handle_delete)

    def _handle_get(self) -> None:
        if self.path == "/healthz":
            # liveness probes stay credential-free (kubelet-probe parity)
            self._send_json(200, {"status": "ok"})
            return
        if self.path == "/metrics" and self.server.metrics is not None:
            # same open stance as /healthz: operator-internal plane
            body = self.server.metrics.prometheus_text().encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if self.path.split("?", 1)[0] in ("/debug/requests", "/debug/decode"):
            # zpages ride the same open stance as /metrics — the shared
            # gateway.server helpers render both bodies
            from urllib.parse import parse_qs, urlsplit

            from tfk8s_tpu_torch.gateway.server import debug_decode, debug_requests
            from tfk8s_tpu_torch.obs.trace import get_tracer

            sp = urlsplit(self.path)
            if sp.path == "/debug/requests":
                q = {k: v[0] for k, v in parse_qs(sp.query).items()}
                self._send_json(200, debug_requests(
                    get_tracer(), trace_id=q.get("trace_id"),
                    limit=int(q.get("limit", "32")),
                ))
            else:
                self._send_json(200, debug_decode())
            return
        if self._gate(write=False) is None:
            return
        if self.path == "/apis" or self.path == "/apis/":
            self._send_json(200, self.server.discovery_doc())
            return
        if self.path.rstrip("/") == f"/apis/{API_VERSION}":
            self._send_json(200, self.server.resource_list())
            return
        route = self._route()
        if route is None:
            self._send_json(404, {"reason": "NotFound", "message": self.path})
            return
        kind, ns, name, _st, query = route
        try:
            if name is not None:
                obj = self.server.store.get(kind, ns or "default", name)
                self._send_json(200, serde.to_wire(obj))
                return
            if query.get("watch") in ("1", "true"):
                self._serve_watch(kind, query)
                return
            selector = _parse_selector(query.get("labelSelector", ""))
            items, rv = self.server.store.list(kind, ns, selector or None)
            # the k8s *List envelope: ListMeta.resourceVersion is the
            # store's version at list time (the reflector's watch cursor)
            self._send_json(
                200,
                {
                    "apiVersion": serde.api_version_of(kind),
                    "kind": f"{kind}List",
                    "metadata": {"resourceVersion": str(rv)},
                    "items": [serde.to_wire(o) for o in items],
                },
            )
        except Exception as e:  # noqa: BLE001 — mapped to protocol errors
            self._send_store_error(e)

    def _admit(self, obj) -> None:
        """Admission for CRD writes (the validating webhook's job, done by
        the API machinery here): apply defaults, then validate — invalid
        specs are rejected at the boundary with 422 Invalid instead of
        being persisted and later failed by the controller. Raises
        :class:`_AdmissionRejected` on invalid specs."""
        if not self.server.admission:
            return
        if obj.kind == "TPUJob":
            from tfk8s_tpu_torch.api import set_defaults, validate

            set_defaults(obj)
            errs = validate(obj)
        elif obj.kind == "TPUServe":
            from tfk8s_tpu_torch.api import set_serve_defaults, validate_serve

            set_serve_defaults(obj)
            errs = validate_serve(obj)
        else:
            return
        if errs:
            raise _AdmissionRejected("; ".join(errs))

    def _handle_post(self) -> None:
        if self._gate(write=True) is None:
            return
        route = self._route()
        if route is None:
            self._send_json(404, {"reason": "NotFound", "message": self.path})
            return
        kind, ns, _name, _st, _q = route
        try:
            obj = serde.decode_object(self._read_body())
            if ns:
                obj.metadata.namespace = ns
            self._admit(obj)
            created = self.server.store.create(obj)
            self._send_json(201, serde.to_wire(created))
        except Exception as e:  # noqa: BLE001
            self._send_store_error(e)

    def _handle_put(self) -> None:
        if self._gate(write=True) is None:
            return
        route = self._route()
        if route is None or route[2] is None:
            self._send_json(404, {"reason": "NotFound", "message": self.path})
            return
        kind, ns, name, is_status, _q = route
        try:
            obj = serde.decode_object(self._read_body())
            # the URL is authoritative; a body naming a different object
            # is a client bug, not a redirect
            if (
                obj.kind != kind
                or obj.metadata.name != name
                or (ns is not None and obj.metadata.namespace != ns)
            ):
                body = _err_body(
                    400, "BadRequest",
                    f"body names {obj.kind} "
                    f"{obj.metadata.namespace}/{obj.metadata.name}, "
                    f"URL names {kind} {ns}/{name}",
                )
                self.send_response(400)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if is_status:
                updated = self.server.store.update_status(obj)
            else:
                self._admit(obj)
                updated = self.server.store.update(obj)
            self._send_json(200, serde.to_wire(updated))
        except Exception as e:  # noqa: BLE001
            self._send_store_error(e)

    def _handle_patch(self) -> None:
        """JSON merge-patch (RFC 7386) on objects and /status — the verb
        `kubectl apply/scale` and controller status writes ride so
        concurrent writers touch disjoint fields instead of fighting over
        whole-object PUTs (k8s-operator.md:33-34)."""
        if self._gate(write=True) is None:
            return
        ctype = (self.headers.get("Content-Type") or "").split(";")[0].strip()
        if ctype not in ("application/merge-patch+json", "application/json"):
            self._send_json(
                415,
                {
                    "reason": "UnsupportedMediaType",
                    "message": f"PATCH requires application/merge-patch+json, "
                               f"got {ctype!r}",
                },
            )
            return
        route = self._route()
        if route is None or route[2] is None:
            self._send_json(404, {"reason": "NotFound", "message": self.path})
            return
        kind, ns, name, is_status, _q = route
        try:
            patch = self._read_body()
        except ValueError as exc:
            self._send_json(
                400,
                {"reason": "BadRequest", "message": f"body is not JSON: {exc}"},
            )
            return
        if not isinstance(patch, dict):
            # RFC 7386: a merge patch document is a JSON OBJECT; an
            # array/string/null body would otherwise reach store.patch
            # and surface as a 500 AttributeError (ADVICE r5)
            self._send_json(
                400,
                {
                    "reason": "BadRequest",
                    "message": "merge patch must be a JSON object, got "
                               f"{type(patch).__name__}",
                },
            )
            return
        try:
            # admission runs on the MERGED object inside the store's
            # critical section — a patch cannot sneak an invalid spec
            # past validation, and a rejected patch commits nothing
            patched = self.server.store.patch(
                kind, ns or "default", name, patch,
                subresource="status" if is_status else None,
                admit=self._admit,
            )
            self._send_json(200, serde.to_wire(patched))
        except Exception as e:  # noqa: BLE001
            self._send_store_error(e)

    def _handle_delete(self) -> None:
        if self._gate(write=True) is None:
            return
        route = self._route()
        if route is None or route[2] is None:
            self._send_json(404, {"reason": "NotFound", "message": self.path})
            return
        kind, ns, name, _st, _q = route
        try:
            deleted = self.server.store.delete(kind, ns or "default", name)
            self._send_json(200, serde.to_wire(deleted))
        except Exception as e:  # noqa: BLE001
            self._send_store_error(e)

    # -- watch streaming ----------------------------------------------------

    def _serve_watch(self, kind: str, query: Dict[str, str]) -> None:
        self._streaming = True  # exclude the stream from request latency
        if self.server.metrics is not None:
            self.server.metrics.inc(
                "apiserver.requests_total", 1.0, {"verb": "WATCH"}
            )
        since_rv: Optional[int] = None
        if "resourceVersion" in query:
            since_rv = int(query["resourceVersion"])
        w = self.server.store.watch(kind, since_rv)  # Gone propagates to 410
        self.send_response(200)
        self.send_header("Content-Type", "application/json; stream=watch")
        self.send_header("Connection", "close")
        self.end_headers()
        self.close_connection = True
        try:
            while not self.server.stopping.is_set():
                ev = w.next(timeout=_HEARTBEAT_S)
                if ev is None:
                    line = b'{"type": "HEARTBEAT"}\n'
                else:
                    line = (
                        json.dumps(
                            {"type": ev.type.value, "object": serde.to_wire(ev.object)}
                        ).encode()
                        + b"\n"
                    )
                self.wfile.write(line)
                self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass  # client went away — normal watch teardown
        finally:
            self.server.store.stop_watch(w)


def parse_selector(raw: str) -> Dict[str, str]:
    """``a=b,c=d`` → dict (the labelSelector query format). The ONE
    parser — the CLI's ``-l`` flag uses it too, so client and server
    selector semantics cannot drift."""
    out: Dict[str, str] = {}
    for part in (raw or "").split(","):
        if "=" in part:
            k, v = part.split("=", 1)
            out[k.strip()] = v.strip()
    return out


_parse_selector = parse_selector  # internal alias (pre-rename call sites)


class APIServer(ThreadingHTTPServer):
    """Threaded HTTP(S) apiserver over one ClusterStore. ``port=0`` binds an
    ephemeral port (tests); ``serve_background()`` runs on a daemon thread
    and returns the bound port. ``tls``/``auth`` secure the wire (module
    docstring)."""

    daemon_threads = True
    # watches hold sockets open; allow plenty of concurrent streams
    request_queue_size = 64

    def __init__(
        self,
        store: ClusterStore,
        host: str = "127.0.0.1",
        port: int = 0,
        admission: bool = True,
        tls: Optional[TLSServerConfig] = None,
        auth: Optional[AuthConfig] = None,
        metrics=None,
    ):
        self.store = store
        self.admission = admission
        self.auth = auth
        # optional utils.logging.Metrics: per-verb request latency
        # histograms + /metrics exposition on this listener
        self.metrics = metrics
        if metrics is not None:
            metrics.describe(
                "apiserver.request_seconds",
                "Wall time per discrete apiserver request, by verb.",
            )
            metrics.describe(
                "apiserver.requests_total",
                "Requests served, by verb (WATCH counts stream opens).",
            )
        self.stopping = threading.Event()
        self._ssl_ctx: Optional[ssl.SSLContext] = None
        if tls is not None:
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(tls.cert_file, tls.key_file)
            if tls.client_ca_file:
                ctx.load_verify_locations(tls.client_ca_file)
                # OPTIONAL, not REQUIRED: bearer-token clients carry no
                # cert; a presented cert must still verify against the CA
                ctx.verify_mode = ssl.CERT_OPTIONAL
            self._ssl_ctx = ctx
        super().__init__((host, port), _Handler)

    def get_request(self):
        sock, addr = self.socket.accept()
        if self._ssl_ctx is not None:
            # wrap here, handshake in the handler thread (_Handler.setup)
            sock = self._ssl_ctx.wrap_socket(
                sock, server_side=True, do_handshake_on_connect=False
            )
        return sock, addr

    def handle_error(self, request, client_address) -> None:  # type: ignore[override]
        # TLS handshake failures from probes/misconfigured clients are
        # operationally normal; keep them off stderr.
        import sys

        exc = sys.exc_info()[1]
        if isinstance(exc, (ssl.SSLError, ConnectionError, TimeoutError, OSError)):
            log.debug("connection from %s failed: %s", client_address, exc)
            return
        super().handle_error(request, client_address)

    @property
    def port(self) -> int:
        return self.server_address[1]

    @property
    def url(self) -> str:
        scheme = "https" if self._ssl_ctx is not None else "http"
        return f"{scheme}://{self.server_address[0]}:{self.port}"

    def discovery_doc(self) -> Dict[str, Any]:
        # metav1.APIGroupList, what `kubectl api-versions` reads at /apis
        group, version = API_VERSION.split("/")
        gv = {"groupVersion": API_VERSION, "version": version}
        return {
            "kind": "APIGroupList",
            "apiVersion": "v1",
            "groups": [
                {"name": group, "versions": [gv], "preferredVersion": gv}
            ],
        }

    def resource_list(self) -> Dict[str, Any]:
        # metav1.APIResourceList for the group-version (kubectl api-resources)
        verbs = ["create", "delete", "get", "list", "patch", "update", "watch"]
        return {
            "kind": "APIResourceList",
            "apiVersion": "v1",
            "groupVersion": API_VERSION,
            "resources": [
                {
                    "name": plural,
                    "kind": kind,
                    "namespaced": True,
                    "verbs": verbs,
                }
                for plural, kind in sorted(PLURALS.items())
            ]
            + [
                {
                    "name": f"{plural}/status",
                    "kind": kind,
                    "namespaced": True,
                    "verbs": ["patch", "update"],
                }
                for plural, kind in sorted(PLURALS.items())
            ],
        }

    def serve_background(self) -> int:
        t = threading.Thread(target=self.serve_forever, daemon=True, name="apiserver")
        t.start()
        return self.port

    def shutdown(self) -> None:  # type: ignore[override]
        self.stopping.set()
        super().shutdown()
