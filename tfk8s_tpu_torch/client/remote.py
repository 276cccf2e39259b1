"""Remote cluster client: the ClusterStore interface over HTTP.

The other half of the process boundary (client/apiserver.py): a
:class:`RemoteStore` presents the exact CRUD+watch surface of the
in-memory :class:`~tfk8s_tpu_torch.client.store.ClusterStore`, but every call is
a REST request to ``/apis/<group>/<version>/namespaces/*/<plural>/...``
(the path shape of k8s-operator.md:33-34). A
:class:`~tfk8s_tpu_torch.client.clientset.Clientset` built over a RemoteStore is
therefore a *real* remote client — the informers, controller, and kubelet
run unchanged against it, which is the swap the reference performs with
``clientcmd.BuildConfigFromFlags → NewForConfig``
(k8s-operator.md:92-102, images/tf4-tf6).

Kubeconfig: :func:`load_kubeconfig` accepts BOTH a small flat JSON file
``{"server": "http://host:port", "qps": ..., "token": ..., ...}`` and a
real Kubernetes kubeconfig (YAML or JSON: clusters/users/contexts with
``certificate-authority-data`` etc.) — the reference's kubeconfig-flag
path (`k8s-operator.md:206-207`, ``clientcmd.BuildConfigFromFlags`` at
:93). Credentials ride every request the way ``rest.Config`` carries
them (images/tf5-tf6): the CA (path or inline PEM) pins the server cert,
``token`` becomes ``Authorization: Bearer``, and a client cert/key pair
is presented for mTLS; ``user_agent`` is the DefaultKubernetesUserAgent
equivalent.

Watch streams: one long-lived HTTP response per watch, newline-delimited
JSON events pumped into a :class:`~tfk8s_tpu_torch.client.store.Watch` by a
reader thread; ``stop()`` closes the socket, which the server notices via
its heartbeat write. HTTP errors map back to the store's exception types
(404 NotFound / 409 AlreadyExists|Conflict / 410 Gone), so reflector
relist-on-Gone works identically across the wire.
"""

from __future__ import annotations

import atexit
import base64
import json
import os
import shutil
import socket
import ssl
import tempfile
import threading
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from tfk8s_tpu_torch import API_VERSION
from tfk8s_tpu_torch.api import serde
from tfk8s_tpu_torch.client.apiserver import KIND_TO_PLURAL
from tfk8s_tpu_torch.client.clientset import Clientset, RESTConfig
from tfk8s_tpu_torch.client.store import (
    AlreadyExists,
    Conflict,
    EventType,
    Forbidden,
    Gone,
    Invalid,
    NotFound,
    StoreError,
    Unauthorized,
    Unavailable,
    Watch,
    WatchEvent,
)
from tfk8s_tpu_torch.utils.logging import get_logger

log = get_logger("remote")

_TIMEOUT_S = 30.0
# Watch-stream read deadline: several server heartbeat intervals (the
# server writes a HEARTBEAT line every 2s when idle). A silent peer death
# — power loss, network partition with no FIN/RST — surfaces as
# socket.timeout in the pump, which ends the watch; the reflector then
# relists, exactly the liveness contract the heartbeats exist for.
_WATCH_READ_TIMEOUT_S = 10.0


def _map_error(status: int, reason: str, message: str) -> StoreError:
    if status == 401:
        return Unauthorized(message)
    if status == 403:
        return Forbidden(message)
    if status == 404:
        return NotFound(message)
    if status == 409 and reason == "AlreadyExists":
        return AlreadyExists(message)
    if status == 409:
        return Conflict(message)
    if status == 410:
        return Gone(message)
    if status == 422:
        # typed (callers can catch Invalid) but message-compatible with
        # the generic branch this status used to fall through to
        return Invalid(f"HTTP {status} {reason}: {message}")
    if status >= 500:
        # server-side failure: transient by contract, retryable
        return Unavailable(f"HTTP {status} {reason}: {message}")
    return StoreError(f"HTTP {status} {reason}: {message}")


class RemoteWatch(Watch):
    """Watch fed by a reader thread draining one HTTP watch response."""

    def __init__(self, resp) -> None:
        super().__init__()
        self._resp = resp
        self._thread = threading.Thread(
            target=self._pump, daemon=True, name="remote-watch"
        )
        self._thread.start()

    def _pump(self) -> None:
        try:
            for raw in self._resp:
                if self._stopped:
                    break
                line = raw.strip()
                if not line:
                    continue
                data = json.loads(line)
                if data.get("type") == "HEARTBEAT":
                    continue
                self._push(
                    WatchEvent(
                        EventType(data["type"]), serde.decode_object(data["object"])
                    )
                )
        except (OSError, ValueError):
            pass  # connection torn down (stop() or server shutdown)
        finally:
            self.stop()

    def stop(self) -> None:
        super().stop()
        try:
            self._resp.close()
        except OSError:
            pass


class RemoteStore:
    """ClusterStore-shaped facade over the HTTP(S) apiserver.

    ``token`` rides as ``Authorization: Bearer`` on every request;
    ``ssl_context`` carries the CA pin and any client cert (build one from
    a kubeconfig with :func:`build_ssl_context`)."""

    def __init__(
        self,
        base_url: str,
        timeout: float = _TIMEOUT_S,
        token: Optional[str] = None,
        ssl_context: Optional[ssl.SSLContext] = None,
        user_agent: str = "tfk8s-tpu-operator",
    ):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.token = token
        self.ssl_context = ssl_context
        self.user_agent = user_agent

    # -- request plumbing ---------------------------------------------------

    def _path(self, kind: str, namespace: Optional[str], name: Optional[str] = None) -> str:
        plural = KIND_TO_PLURAL[kind]
        if namespace is None:
            p = f"/apis/{API_VERSION}/{plural}"
        else:
            p = f"/apis/{API_VERSION}/namespaces/{namespace}/{plural}"
        if name is not None:
            p += f"/{urllib.parse.quote(name)}"
        return p

    def _request(
        self,
        method: str,
        path: str,
        body: Optional[Dict[str, Any]] = None,
        query: Optional[Dict[str, str]] = None,
        stream: bool = False,
        content_type: str = "application/json",
    ):
        url = self.base_url + path
        if query:
            url += "?" + urllib.parse.urlencode(query)
        data = json.dumps(body).encode() if body is not None else None
        headers: Dict[str, str] = {"User-Agent": self.user_agent}
        if data:
            headers["Content-Type"] = content_type
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        req = urllib.request.Request(url, data=data, method=method, headers=headers)
        try:
            resp = urllib.request.urlopen(
                req,
                timeout=_WATCH_READ_TIMEOUT_S if stream else self.timeout,
                context=self.ssl_context,
            )
        except urllib.error.HTTPError as e:
            payload = {}
            try:
                payload = json.loads(e.read() or b"{}")
            except ValueError:
                pass
            raise _map_error(
                e.code, payload.get("reason", ""), payload.get("message", str(e))
            ) from None
        except urllib.error.URLError as e:
            raise Unavailable(
                f"apiserver unreachable at {url}: {e.reason}"
            ) from None
        if stream:
            return resp
        return json.loads(resp.read() or b"{}")

    # -- the ClusterStore surface ------------------------------------------

    def create(self, obj: Any) -> Any:
        data = self._request(
            "POST",
            self._path(obj.kind, obj.metadata.namespace or "default"),
            body=serde.to_wire(obj),
        )
        return serde.decode_object(data)

    def get(self, kind: str, namespace: str, name: str) -> Any:
        data = self._request("GET", self._path(kind, namespace, name))
        return serde.decode_object(data)

    def list(
        self,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[Dict[str, str]] = None,
    ) -> Tuple[List[Any], int]:
        query: Dict[str, str] = {}
        if label_selector:
            query["labelSelector"] = ",".join(
                f"{k}={v}" for k, v in sorted(label_selector.items())
            )
        data = self._request("GET", self._path(kind, namespace), query=query or None)
        items = [serde.decode_object(d) for d in data.get("items", [])]
        # k8s ListMeta.resourceVersion (string); legacy top-level int kept
        # for mixed-version rollouts
        rv = data.get("metadata", {}).get(
            "resourceVersion", data.get("resourceVersion", 0)
        )
        return items, int(rv)

    def update(self, obj: Any) -> Any:
        data = self._request(
            "PUT",
            self._path(obj.kind, obj.metadata.namespace or "default", obj.metadata.name),
            body=serde.to_wire(obj),
        )
        return serde.decode_object(data)

    def update_status(self, obj: Any) -> Any:
        data = self._request(
            "PUT",
            self._path(obj.kind, obj.metadata.namespace or "default", obj.metadata.name)
            + "/status",
            body=serde.to_wire(obj),
        )
        return serde.decode_object(data)

    def patch(
        self,
        kind: str,
        namespace: str,
        name: str,
        patch: Dict[str, Any],
        subresource: Optional[str] = None,
        admit=None,  # server-side concern; accepted for surface parity
    ) -> Any:
        path = self._path(kind, namespace, name)
        if subresource:
            path += f"/{subresource}"
        data = self._request(
            "PATCH", path, body=patch,
            content_type="application/merge-patch+json",
        )
        return serde.decode_object(data)

    def delete(self, kind: str, namespace: str, name: str) -> Any:
        data = self._request("DELETE", self._path(kind, namespace, name))
        return serde.decode_object(data)

    def watch(self, kind: str, since_rv: Optional[int] = None) -> Watch:
        query = {"watch": "1"}
        if since_rv is not None:
            query["resourceVersion"] = str(since_rv)
        resp = self._request(
            "GET", self._path(kind, None), query=query, stream=True
        )
        return RemoteWatch(resp)

    def stop_watch(self, w: Watch) -> None:
        w.stop()

    def healthz(self) -> bool:
        try:
            data = self._request("GET", "/healthz")
            return data.get("status") == "ok"
        except StoreError:
            return False


@dataclass
class Kubeconfig:
    """The ``rest.Config`` equivalent: where the apiserver lives, the
    credentials to present, and client limits. CA/client-cert material may
    be a file path or inline PEM (the ``*-data`` kubeconfig fields)."""

    server: str
    qps: float = 50.0
    burst: int = 100
    user_agent: str = "tfk8s-tpu-operator"
    token: str = ""
    certificate_authority: str = ""  # path to CA bundle (PEM)
    certificate_authority_data: str = ""  # inline PEM
    client_certificate: str = ""  # path (PEM)
    client_key: str = ""  # path (PEM)
    client_certificate_data: str = ""  # inline PEM
    client_key_data: str = ""  # inline PEM
    insecure_skip_tls_verify: bool = False


def _b64_or_pem(value: str) -> str:
    """kubeconfig ``*-data`` fields are base64(PEM); accept raw PEM too."""
    if value.lstrip().startswith("-----BEGIN"):
        return value
    return base64.b64decode(value).decode()


def _from_k8s_kubeconfig(data: Dict[str, Any]) -> Kubeconfig:
    """Parse the real kubeconfig shape (clusters/users/contexts +
    current-context), honoring ``*-data`` inline credentials. A context
    naming a nonexistent cluster/user is an ERROR (kubectl parity) —
    silently picking another cluster would connect somewhere else with
    the wrong credentials."""
    by_name = lambda items, key: {i["name"]: i[key] for i in items or []}  # noqa: E731
    clusters = by_name(data.get("clusters"), "cluster")
    users = by_name(data.get("users"), "user")
    contexts = by_name(data.get("contexts"), "context")
    if not clusters:
        raise ValueError("kubeconfig has no clusters")
    ctx_name = data.get("current-context") or next(iter(contexts), "")
    if ctx_name and ctx_name not in contexts:
        # a dangling current-context must error too — falling back to
        # the first cluster would silently connect somewhere else
        raise ValueError(
            f'kubeconfig current-context "{ctx_name}" does not exist'
        )
    ctx = contexts.get(ctx_name, {})

    def pick(pool: Dict[str, Any], ref: str, what: str) -> Dict[str, Any]:
        if ref:
            if ref not in pool:
                raise ValueError(
                    f'kubeconfig context "{ctx_name}" references unknown '
                    f'{what} "{ref}"'
                )
            return pool[ref]
        return next(iter(pool.values()), {})

    cluster = pick(clusters, ctx.get("cluster", ""), "cluster")
    user = pick(users, ctx.get("user", ""), "user")
    return Kubeconfig(
        server=cluster["server"],
        certificate_authority=cluster.get("certificate-authority", ""),
        certificate_authority_data=_b64_or_pem(
            cluster.get("certificate-authority-data", "") or ""
        ),
        insecure_skip_tls_verify=bool(cluster.get("insecure-skip-tls-verify", False)),
        token=user.get("token", ""),
        client_certificate=user.get("client-certificate", ""),
        client_key=user.get("client-key", ""),
        client_certificate_data=_b64_or_pem(user.get("client-certificate-data", "") or ""),
        client_key_data=_b64_or_pem(user.get("client-key-data", "") or ""),
    )


def load_kubeconfig(path: str) -> Kubeconfig:
    """Load either format: a real kubeconfig (YAML/JSON with ``clusters``)
    or the flat JSON dev form."""
    with open(path) as f:
        raw = f.read()
    try:
        data = json.loads(raw)
    except ValueError:
        import yaml  # kubeconfigs in the wild are YAML

        data = yaml.safe_load(raw)
    if "clusters" in data:
        return _from_k8s_kubeconfig(data)
    return Kubeconfig(
        server=data["server"],
        qps=float(data.get("qps", 50.0)),
        burst=int(data.get("burst", 100)),
        user_agent=data.get("user_agent", "tfk8s-tpu-operator"),
        token=data.get("token", ""),
        certificate_authority=data.get("certificate_authority", ""),
        # *_data fields accept base64(PEM) or raw PEM in BOTH formats —
        # the field name mirrors the k8s convention, so honor it here too
        certificate_authority_data=_b64_or_pem(
            data.get("certificate_authority_data", "") or ""
        ),
        client_certificate=data.get("client_certificate", ""),
        client_key=data.get("client_key", ""),
        client_certificate_data=_b64_or_pem(
            data.get("client_certificate_data", "") or ""
        ),
        client_key_data=_b64_or_pem(data.get("client_key_data", "") or ""),
        insecure_skip_tls_verify=bool(data.get("insecure_skip_tls_verify", False)),
    )


def build_ssl_context(cfg: Kubeconfig) -> Optional[ssl.SSLContext]:
    """TLS client context from kubeconfig credentials: CA pin (path or
    inline PEM) + optional client cert/key for mTLS. Returns None for
    plain-HTTP servers. Server certs must carry the host as a SAN
    (hostname verification stays ON unless insecure_skip_tls_verify)."""
    if not cfg.server.startswith("https"):
        return None
    ctx = ssl.create_default_context(
        cafile=cfg.certificate_authority or None,
        cadata=cfg.certificate_authority_data or None,
    )
    if cfg.insecure_skip_tls_verify:
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
    if cfg.client_certificate and cfg.client_key:
        ctx.load_cert_chain(cfg.client_certificate, cfg.client_key)
    elif cfg.client_certificate_data and cfg.client_key_data:
        ctx.load_cert_chain(
            *_stage_client_pair(cfg.client_certificate_data, cfg.client_key_data)
        )
    return ctx


# load_cert_chain needs files; inline PEM pairs are staged into private
# tempdirs ONCE per distinct pair (rebuilding clients must not leak a new
# key file per call) and removed at interpreter exit.
_staged_pairs: Dict[Tuple[str, str], Tuple[str, str]] = {}
_staged_dirs: List[str] = []


def _stage_client_pair(cert_pem: str, key_pem: str) -> Tuple[str, str]:
    pair = (cert_pem, key_pem)
    if pair not in _staged_pairs:
        d = tempfile.mkdtemp(prefix="tfk8s-client-cert-")
        cert_path = os.path.join(d, "client.crt")
        key_path = os.path.join(d, "client.key")
        with open(cert_path, "w") as f:
            f.write(cert_pem)
        with open(key_path, "w") as f:
            f.write(key_pem)
        os.chmod(key_path, 0o600)  # kubeconfig-credential discipline
        _staged_pairs[pair] = (cert_path, key_path)
        _staged_dirs.append(d)
    return _staged_pairs[pair]


@atexit.register
def _cleanup_staged_pairs() -> None:
    for d in _staged_dirs:
        shutil.rmtree(d, ignore_errors=True)
    _staged_dirs.clear()
    _staged_pairs.clear()


def store_from_kubeconfig(cfg: Kubeconfig) -> RemoteStore:
    """Kubeconfig → credentialed RemoteStore (rest.RESTClientFor parity)."""
    return RemoteStore(
        cfg.server,
        token=cfg.token or None,
        ssl_context=build_ssl_context(cfg),
        user_agent=cfg.user_agent,
    )


def clientset_from_kubeconfig(path_or_cfg) -> Clientset:
    """``BuildConfigFromFlags → NewForConfig`` in one step
    (k8s-operator.md:92-102): kubeconfig → RemoteStore → rate-limited
    Clientset."""
    cfg = (
        path_or_cfg
        if isinstance(path_or_cfg, Kubeconfig)
        else load_kubeconfig(path_or_cfg)
    )
    return Clientset.new_for_config(
        store_from_kubeconfig(cfg),
        RESTConfig(qps=cfg.qps, burst=cfg.burst, user_agent=cfg.user_agent),
    )
