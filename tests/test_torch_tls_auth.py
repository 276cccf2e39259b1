"""The port's secured apiserver: TLS serving, bearer and mTLS
authentication, kubeconfigs and the CLI's safety rails, on the CPU.

The flows of ``tests/test_tls_auth.py`` run once through each package
(``P``: its ``tlsutil``, ``APIServer``, ``RemoteStore``, kubeconfig loader
and ``cmd.main``), with the same assertions; the texts of the errors the
port raises (401, 403, an untrusted server, malformed kubeconfigs and token
files) equal the reference's. The end-to-end case runs the port's MLP
(``TFK8S_DEVICE=cpu`` in the template) through the port's ``Server`` and a
``LocalKubelet``, each its own client of one HTTPS apiserver with a bearer
token; until the port has a ``submit`` verb, the job is submitted with
``clientset_from_kubeconfig``.
"""

import base64
import http.client
import json
import os
import re
import ssl
import threading
import types

import pytest
import _torch_threads  # noqa: F401  (torch's threads under xdist)

pytest.importorskip("cryptography")

from tfk8s_tpu import API_VERSION  # noqa: E402
from tfk8s_tpu.api import serde as rserde  # noqa: E402
from tfk8s_tpu.api import types as rtypes  # noqa: E402
from tfk8s_tpu.client import apiserver as rapiserver  # noqa: E402
from tfk8s_tpu.client import remote as rremote  # noqa: E402
from tfk8s_tpu.client import store as rstore  # noqa: E402
from tfk8s_tpu.client import tlsutil as rtlsutil  # noqa: E402
from tfk8s_tpu_torch.api import helpers as thelpers  # noqa: E402
from tfk8s_tpu_torch.api import serde as tserde  # noqa: E402
from tfk8s_tpu_torch.api import types as ttypes  # noqa: E402
from tfk8s_tpu_torch.client import apiserver as tapiserver  # noqa: E402
from tfk8s_tpu_torch.client import remote as tremote  # noqa: E402
from tfk8s_tpu_torch.client import store as tstore  # noqa: E402
from tfk8s_tpu_torch.client import tlsutil as ttlsutil  # noqa: E402

from conftest import wait_for  # noqa: E402

TOKEN = "sekret-operator-token"
RO_TOKEN = "sekret-readonly-token"
PACKAGES = {
    "reference": types.SimpleNamespace(t=rtypes, serde=rserde, api=rapiserver, remote=rremote,
                                       s=rstore, tls=rtlsutil, cmd="tfk8s_tpu.cmd.main"),
    "port": types.SimpleNamespace(t=ttypes, serde=tserde, api=tapiserver, remote=tremote,
                                  s=tstore, tls=ttlsutil, cmd="tfk8s_tpu_torch.cmd.main"),
}


def make_job(P, name, entrypoint="test.echo", env=None):
    t = P.t
    return t.TPUJob(
        metadata=t.ObjectMeta(name=name, namespace="default"),
        spec=t.TPUJobSpec(
            replica_specs={t.ReplicaType.WORKER: t.ReplicaSpec(
                replicas=1, template=t.ContainerSpec(entrypoint=entrypoint, env=env or {}))},
            tpu=t.TPUSpec(accelerator="cpu-1"),
        ),
    )


def cli(P):
    import importlib

    return importlib.import_module(P.cmd).main


@pytest.fixture(scope="module", params=sorted(PACKAGES))
def P(request):
    return PACKAGES[request.param]


@pytest.fixture(scope="module")
def pki(P, tmp_path_factory):
    d = tmp_path_factory.mktemp("pki")
    ca = P.tls.generate_ca()
    server_pair = P.tls.issue_cert(ca, "tfk8s-apiserver")
    client_pair = P.tls.issue_cert(ca, "cert-user", client=True)
    ca_path, _ = ca.write(str(d), "ca")
    cert_path, key_path = server_pair.write(str(d), "apiserver")
    ccert_path, ckey_path = client_pair.write(str(d), "client")
    return {"ca": ca, "ca_path": ca_path, "cert_path": cert_path, "key_path": key_path,
            "client_cert_path": ccert_path, "client_key_path": ckey_path}


def start_secured(P, pki):
    server = P.api.APIServer(
        P.s.ClusterStore(), port=0,
        tls=P.api.TLSServerConfig(pki["cert_path"], pki["key_path"],
                                  client_ca_file=pki["ca_path"]),
        auth=P.api.AuthConfig(tokens={TOKEN: P.api.User("operator"),
                                      RO_TOKEN: P.api.User("viewer", readonly=True)}),
    )
    server.serve_background()
    return server


@pytest.fixture(scope="module")
def secured(P, pki):
    server = start_secured(P, pki)
    yield server
    server.shutdown()
    server.server_close()


@pytest.fixture(autouse=True)
def _fresh_store(request):
    """Each test starts from an empty store on the module's server."""
    if "secured" in request.fixturenames:
        P = request.getfixturevalue("P")
        request.getfixturevalue("secured").store = P.s.ClusterStore()


def mint(P, d):
    """A CA and a server pair written into ``d``, in ``pki``'s layout."""
    ca = P.tls.generate_ca()
    ca_path, _ = ca.write(str(d), "ca")
    cert_path, key_path = P.tls.issue_cert(ca, "tfk8s-apiserver").write(str(d), "apiserver")
    return {"ca": ca, "ca_path": ca_path, "cert_path": cert_path, "key_path": key_path}


def authed_store(P, server, pki, token=TOKEN):
    return P.remote.RemoteStore(
        server.url, token=token,
        ssl_context=P.remote.build_ssl_context(
            P.remote.Kubeconfig(server=server.url, certificate_authority=pki["ca_path"])))


# -- the PKI -----------------------------------------------------------------------


def test_issued_chain_verifies(P, pki):
    ctx = ssl.create_default_context(cafile=pki["ca_path"])
    assert ctx.cert_store_stats()["x509_ca"] == 1
    assert P.tls.cert_common_name(pki["ca"].cert_pem) == "tfk8s-ca"


def test_key_files_are_private(P, pki):
    assert os.stat(pki["key_path"]).st_mode & 0o777 == 0o600
    assert os.stat(pki["client_key_path"]).st_mode & 0o777 == 0o600


def test_either_package_s_certificates_serve_the_other(pki, tmp_path):
    """A CA and a server pair minted by one package serve HTTPS for the
    other package's apiserver."""
    for P in PACKAGES.values():
        server = start_secured(P, pki)
        try:
            authed_store(P, server, pki).create(make_job(P, "cross"))
            assert server.store.get("TPUJob", "default", "cross")
        finally:
            server.shutdown()
            server.server_close()


# -- the secured wire --------------------------------------------------------------


def test_https_crud_and_watch_with_bearer_token(P, secured, pki):
    store = authed_store(P, secured, pki)
    assert secured.url.startswith("https://")
    store.create(make_job(P, "tls-a"))
    assert store.get("TPUJob", "default", "tls-a").metadata.name == "tls-a"
    w = store.watch("TPUJob", since_rv=0)
    try:
        assert w.next(timeout=5).object.metadata.name == "tls-a"
    finally:
        store.stop_watch(w)


def test_anonymous_rejected_401(P, secured, pki):
    anon = authed_store(P, secured, pki, token=None)
    with pytest.raises(P.s.Unauthorized):
        anon.list("TPUJob")
    with pytest.raises(P.s.Unauthorized):
        anon.create(make_job(P, "nope"))
    with pytest.raises(P.s.Unauthorized):
        anon.watch("TPUJob")


def test_unknown_token_rejected_401(P, secured, pki):
    with pytest.raises(P.s.Unauthorized):
        authed_store(P, secured, pki, token="wrong").list("TPUJob")


def test_readonly_token_reads_but_cannot_write_403(P, secured, pki):
    authed_store(P, secured, pki).create(make_job(P, "ro-visible"))
    viewer = authed_store(P, secured, pki, token=RO_TOKEN)
    assert [j.metadata.name for j in viewer.list("TPUJob")[0]] == ["ro-visible"]
    with pytest.raises(P.s.Forbidden):
        viewer.create(make_job(P, "ro-write"))
    with pytest.raises(P.s.Forbidden):
        viewer.delete("TPUJob", "default", "ro-visible")
    with pytest.raises(P.s.Forbidden):
        viewer.patch("TPUJob", "default", "ro-visible",
                     {"spec": {"runPolicy": {"suspend": True}}})
    with pytest.raises(P.s.Forbidden):
        viewer.patch("TPUJob", "default", "ro-visible", {"status": {}}, subresource="status")


def test_unauthorized_post_closes_keepalive_cleanly(P, secured, pki):
    ctx = ssl.create_default_context(cafile=pki["ca_path"])
    conn = http.client.HTTPSConnection("127.0.0.1", secured.port, context=ctx)
    try:
        conn.request("POST", f"/apis/{API_VERSION}/namespaces/default/tpujobs",
                     body=json.dumps(P.serde.to_wire(make_job(P, "desync"))).encode(),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 401
        resp.read()
        assert resp.getheader("Connection") == "close"
        assert resp.getheader("WWW-Authenticate") == "Bearer"
    finally:
        conn.close()


def test_healthz_stays_open_for_probes(P, secured, pki):
    assert authed_store(P, secured, pki, token=None).healthz()


def test_client_cert_identity_mtls(P, secured, pki):
    store = P.remote.store_from_kubeconfig(P.remote.Kubeconfig(
        server=secured.url, certificate_authority=pki["ca_path"],
        client_certificate=pki["client_cert_path"], client_key=pki["client_key_path"]))
    store.create(make_job(P, "mtls-a"))
    assert store.get("TPUJob", "default", "mtls-a").metadata.name == "mtls-a"


def test_untrusted_server_cert_rejected(P, secured):
    other_ca = P.tls.generate_ca(cn="rogue-ca")
    ctx = ssl.create_default_context(cadata=other_ca.cert_pem.decode())
    store = P.remote.RemoteStore(secured.url, token=TOKEN, ssl_context=ctx)
    with pytest.raises(P.s.StoreError, match="unreachable"):
        store.list("TPUJob")


# -- kubeconfigs -------------------------------------------------------------------


def test_flat_json_with_inline_ca_and_token(P, secured, pki, tmp_path):
    path = tmp_path / "kc.json"
    path.write_text(json.dumps({"server": secured.url, "token": TOKEN,
                                "certificate_authority_data": open(pki["ca_path"]).read()}))
    P.remote.clientset_from_kubeconfig(str(path)).tpujobs("default").create(
        make_job(P, "kc-flat"))
    assert secured.store.get("TPUJob", "default", "kc-flat")


def _k8s_kubeconfig(server_url, ca_b64):
    return (
        "apiVersion: v1\nkind: Config\ncurrent-context: test\n"
        "clusters:\n- name: tfk8s\n  cluster:\n"
        f"    server: {server_url}\n    certificate-authority-data: {ca_b64}\n"
        "contexts:\n- name: test\n  context: {cluster: tfk8s, user: op}\n"
        f"users:\n- name: op\n  user:\n    token: {TOKEN}\n")


def test_k8s_format_yaml_with_base64_data(P, secured, pki, tmp_path):
    with open(pki["ca_path"], "rb") as f:
        ca_b64 = base64.b64encode(f.read()).decode()
    path = tmp_path / "kubeconfig.yaml"
    path.write_text(_k8s_kubeconfig(secured.url, ca_b64))
    cfg = P.remote.load_kubeconfig(str(path))
    assert cfg.token == TOKEN
    assert cfg.certificate_authority_data.startswith("-----BEGIN")
    P.remote.clientset_from_kubeconfig(cfg).tpujobs("default").create(make_job(P, "kc-k8s"))
    assert secured.store.get("TPUJob", "default", "kc-k8s")


def test_flat_json_accepts_base64_data_fields(P, secured, pki, tmp_path):
    with open(pki["ca_path"], "rb") as f:
        ca_b64 = base64.b64encode(f.read()).decode()
    path = tmp_path / "kc-b64.json"
    path.write_text(json.dumps({"server": secured.url, "certificate_authority_data": ca_b64,
                                "token": TOKEN}))
    P.remote.clientset_from_kubeconfig(str(path)).tpujobs("default").create(
        make_job(P, "kc-b64"))
    assert secured.store.get("TPUJob", "default", "kc-b64")


def test_inline_client_pair_staged_once(P, pki):
    cfg = P.remote.Kubeconfig(
        server="https://127.0.0.1:1", certificate_authority=pki["ca_path"],
        client_certificate_data=open(pki["client_cert_path"]).read(),
        client_key_data=open(pki["client_key_path"]).read())
    before = len(P.remote._staged_dirs)
    P.remote.build_ssl_context(cfg)
    P.remote.build_ssl_context(cfg)
    assert len(P.remote._staged_dirs) == before + 1


DANGLING = ("current-context: prod\nclusters:\n- name: staging\n"
            "  cluster: {server: https://127.0.0.1:1}\n"
            "contexts:\n- name: staging\n  context: {cluster: staging, user: op}\n"
            "users:\n- name: op\n  user: {token: t}\n")
NO_CONTEXTS = ("current-context: prod\nclusters:\n- name: staging\n"
               "  cluster: {server: https://127.0.0.1:1}\n"
               "users:\n- name: op\n  user: {token: t}\n")
BAD_CONTEXT = ("current-context: prod\nclusters:\n- name: staging\n"
               "  cluster: {server: https://127.0.0.1:1}\n"
               "contexts:\n- name: prod\n  context: {cluster: prod-cluster, user: op}\n"
               "users:\n- name: op\n  user: {token: t}\n")


def test_dangling_current_context_rejected(P, tmp_path):
    for i, text in enumerate((DANGLING, NO_CONTEXTS)):
        path = tmp_path / f"dangling-{i}.yaml"
        path.write_text(text)
        with pytest.raises(ValueError, match='current-context "prod"'):
            P.remote.load_kubeconfig(str(path))


def test_bad_context_reference_rejected(P, tmp_path):
    path = tmp_path / "bad-ctx.yaml"
    path.write_text(BAD_CONTEXT)
    with pytest.raises(ValueError, match='unknown cluster "prod-cluster"'):
        P.remote.load_kubeconfig(str(path))


def test_token_file_parsing(P, tmp_path):
    p = tmp_path / "tokens.csv"
    p.write_text(f"# static tokens\n{TOKEN},operator\n{RO_TOKEN},viewer,readonly\n")
    auth = P.api.AuthConfig.from_token_file(str(p))
    assert auth.tokens[TOKEN] == P.api.User("operator")
    assert auth.tokens[RO_TOKEN].readonly


# -- the command line --------------------------------------------------------------


def test_token_file_without_tls_refused(P, tmp_path):
    tf = tmp_path / "tokens.csv"
    tf.write_text(f"{TOKEN},admin\n")
    assert cli(P)(["apiserver", "--port", "0", "--token-file", str(tf)]) == 2


def test_half_tls_config_refused(P, pki):
    assert cli(P)(["apiserver", "--port", "0", "--tls-cert", pki["cert_path"]]) == 2


def test_write_kubeconfig_skips_readonly_tokens(P, tmp_path):
    tf = tmp_path / "tokens.csv"
    tf.write_text(f"{RO_TOKEN},viewer,readonly\n")
    assert cli(P)(["apiserver", "--port", "0", "--self-signed", str(tmp_path / "pki"),
                   "--token-file", str(tf),
                   "--write-kubeconfig", str(tmp_path / "kc.json")]) == 2
    assert not (tmp_path / "kc.json").exists()


# -- the error texts ---------------------------------------------------------------


def _texts(P, pki, tmp_path):
    """(error type, text) of each failure, the port number masked."""
    server = start_secured(P, pki)
    out = []

    def failing(fn):
        try:
            fn()
        except Exception as e:  # noqa: BLE001 — the text is the point
            out.append((type(e).__name__, re.sub(r":\d+", ":PORT", str(e))))
        else:
            out.append(None)

    try:
        authed_store(P, server, pki).create(make_job(P, "seen"))
        anon = authed_store(P, server, pki, token=None)
        viewer = authed_store(P, server, pki, token=RO_TOKEN)
        failing(lambda: anon.list("TPUJob"))
        failing(lambda: anon.create(make_job(P, "x")))
        failing(lambda: authed_store(P, server, pki, token="wrong").get("TPUJob", "default", "seen"))
        failing(lambda: viewer.create(make_job(P, "x")))
        failing(lambda: viewer.delete("TPUJob", "default", "seen"))
        failing(lambda: viewer.patch("TPUJob", "default", "seen", {"spec": {}}))
        rogue = ssl.create_default_context(cadata=P.tls.generate_ca(cn="rogue").cert_pem.decode())
        failing(lambda: P.remote.RemoteStore(server.url, token=TOKEN, ssl_context=rogue)
                .list("TPUJob"))
    finally:
        server.shutdown()
        server.server_close()
    for i, text in enumerate((DANGLING, NO_CONTEXTS, BAD_CONTEXT, "- a list\n")):
        path = tmp_path / f"{P.cmd}-{i}.yaml"
        path.write_text(text)
        failing(lambda: P.remote.load_kubeconfig(str(path)))
    bad = tmp_path / f"{P.cmd}-tokens.csv"
    bad.write_text("lonely-token\n")
    failing(lambda: P.api.AuthConfig.from_token_file(str(bad)))
    return out


def test_error_texts_equal_the_reference_s(tmp_path):
    pki = mint(PACKAGES["port"], tmp_path)
    port = _texts(PACKAGES["port"], pki, tmp_path)
    ref = _texts(PACKAGES["reference"], pki, tmp_path)
    assert None not in port
    assert port == ref
    assert [kind for kind, _ in port[:6]] == ["Unauthorized"] * 3 + ["Forbidden"] * 3


# -- a job over HTTPS --------------------------------------------------------------


def test_the_port_s_job_succeeds_over_https(tmp_path):
    """The port's operator and kubelet, two clients of one HTTPS apiserver
    with a bearer token; the MLP on the CPU, on two threads."""
    import torch

    from tfk8s_tpu_torch.cmd.options import Options
    from tfk8s_tpu_torch.cmd.server import Server
    from tfk8s_tpu_torch.runtime.kubelet import LocalKubelet

    P = PACKAGES["port"]
    pki = mint(P, tmp_path)
    secured = start_secured(P, pki)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    kc = tmp_path / "kubeconfig.json"
    kc.write_text(json.dumps({"server": secured.url, "token": TOKEN,
                              "certificate_authority_data": open(pki["ca_path"]).read()}))
    stop = threading.Event()
    operator = Server(Options(kubeconfig=str(kc), local_kubelet=False, workers=2))
    assert type(operator.store).__name__ == "RemoteStore"
    operator.run(stop, block=False)
    LocalKubelet(tremote.clientset_from_kubeconfig(str(kc)), name="tls-kubelet").run(stop)
    try:
        cs = tremote.clientset_from_kubeconfig(str(kc))
        cs.tpujobs("default").create(make_job(
            PACKAGES["port"], "tls-e2e", entrypoint="tfk8s_tpu_torch.models.mlp:train",
            env={"TFK8S_DEVICE": "cpu", "TFK8S_LOG_EVERY": "100"}))

        def ended():
            st = cs.tpujobs("default").get("tls-e2e").status
            return any(thelpers.has_condition(st, c) for c in (
                ttypes.JobConditionType.SUCCEEDED, ttypes.JobConditionType.FAILED))

        assert wait_for(ended, timeout=60)
        job = cs.tpujobs("default").get("tls-e2e")
        assert thelpers.has_condition(job.status, ttypes.JobConditionType.SUCCEEDED), job.status
        (pod,) = cs.pods("default").list()[0]
        assert pod.status.host == "tls-kubelet" and pod.status.training["step"] == 300
    finally:
        stop.set()
        operator.shutdown()
        secured.shutdown()
        secured.server_close()
        torch.set_num_threads(threads)
