"""CLI entrypoint — SURVEY.md C1 (`tf_operator/main.go`; sequence
Main → Option → flags → initlog → Run server, images/tf2.png).

The job half of the JAX package's ``cmd/main.py``, on the port's control
plane and entry points:

- ``operator``  run the reconcile server (the reference's only mode), with
                ``--gateway-port`` the serving front door too; with
                ``--kubeconfig`` it reconciles against a remote apiserver
                across a process boundary (``--no-local-kubelet`` leaves
                the pods to a ``kubelet`` process)
- ``run``       end-to-end local run: operator + kubelet in-process,
                submit one TPUJob, wait for a terminal condition
- ``train``     run a model entrypoint directly in this process (the
                data-plane launcher, no control plane — for debugging)
- ``apiserver`` serve the cluster store over HTTP(S)
                (client/apiserver.py), with ``--journal-dir`` durable
                across restarts — the L0 substrate as its own process
- ``kubelet``   run the pod executor as its own process against a remote
                apiserver (the node-agent half of the process split)

``python -m tfk8s_tpu_torch.cmd.main run --entrypoint
tfk8s_tpu_torch.models.mlp:train --accelerator cpu-1 --env
'{"TFK8S_DEVICE": "cpu"}'`` runs a job on the CPU; ``--accelerator
h100-1`` and no ``TFK8S_DEVICE`` run it on the card. A pod's entry point
runs on the card unless its own env says ``TFK8S_DEVICE=cpu``; the
``kubelet`` verb sets no device for it (the reference's kubelet honours
``TFK8S_JAX_PLATFORM``, which the port has no counterpart of). The
reference's kubectl-like verbs (``submit``, ``get``, ...) are a later
slice: until then a job is submitted with
``client.remote.clientset_from_kubeconfig(path).tpujobs().create(job)``.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
from typing import List, Optional

from tfk8s_tpu_torch.cmd.options import Options
from tfk8s_tpu_torch.utils.logging import get_logger, init_logging

log = get_logger("main")


def _build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="tfk8s-tpu-torch",
        description="TFJob-style training operator for NVIDIA GPUs (PyTorch)",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p_op = sub.add_parser("operator", help="run the operator server")
    Options.add_flags(p_op)

    p_run = sub.add_parser("run", help="run one TPUJob end-to-end locally")
    Options.add_flags(p_run)
    p_run.add_argument("--file", default="",
                       help="TPUJob manifest (YAML or JSON); overrides the flag-built spec")
    p_run.add_argument("--name", default="job")
    p_run.add_argument("--entrypoint", default="",
                       help='e.g. "tfk8s_tpu_torch.models.mlp:train" (required without --file)')
    p_run.add_argument("--replicas", type=int, default=1)
    p_run.add_argument("--accelerator", default="cpu-1")
    p_run.add_argument("--env", default="{}",
                       help="extra pod env as JSON")
    p_run.add_argument("--timeout", type=float, default=600.0)

    p_tr = sub.add_parser("train", help="run a model entrypoint in-process")
    p_tr.add_argument("--entrypoint", required=True)
    p_tr.add_argument("--env", default="{}")

    p_api = sub.add_parser("apiserver", help="serve the cluster store over HTTP(S)")
    p_api.add_argument("--host", default="127.0.0.1")
    p_api.add_argument("--port", type=int, default=8443)
    p_api.add_argument("--write-kubeconfig", default="", dest="write_kubeconfig",
                       help="write a kubeconfig JSON for the bound address "
                       "(use with --port 0 to discover the ephemeral port); "
                       "with --self-signed/--token-file it embeds the CA "
                       "and first token")
    p_api.add_argument("--tls-cert", default="", help="server certificate (PEM)")
    p_api.add_argument("--tls-key", default="", help="server private key (PEM)")
    p_api.add_argument("--client-ca", default="",
                       help="CA bundle for verifying client certs (mTLS)")
    p_api.add_argument("--self-signed", default="", metavar="DIR",
                       help="mint a CA + server cert into DIR and serve TLS "
                       "(dev/test; overrides --tls-cert/--tls-key)")
    p_api.add_argument("--journal-dir", default="", dest="journal_dir",
                       help="directory for the write-ahead log + snapshot; "
                            "cluster state survives apiserver restarts "
                            "(empty = in-memory only)")
    p_api.add_argument("--no-fsync", action="store_true", dest="no_fsync",
                       help="journal without fsync (kill-9 safe via page "
                            "cache, not power-loss safe)")
    p_api.add_argument("--token-file", default="",
                       help="static token file 'token,user[,readonly]' per "
                       "line; enables authentication (anonymous -> 401)")

    p_kl = sub.add_parser("kubelet", help="run the pod executor against a remote apiserver")
    p_kl.add_argument("--kubeconfig", required=True)
    p_kl.add_argument("--name", default="kubelet-0",
                      help="node name recorded in pod status")
    return parser


def _cmd_operator(opts: Options) -> int:
    from tfk8s_tpu_torch.cmd.server import Server

    stop = threading.Event()
    server = Server(opts)
    try:
        server.run(stop, block=True)
    except KeyboardInterrupt:
        log.info("interrupted; shutting down")
    finally:
        stop.set()
        server.shutdown()
    return 0


def _cmd_run(opts: Options, args: argparse.Namespace) -> int:
    import time

    from tfk8s_tpu_torch.api import helpers
    from tfk8s_tpu_torch.api.types import (
        ContainerSpec, JobConditionType, ObjectMeta, ReplicaSpec, ReplicaType,
        RunPolicy, SchedulingPolicy, TPUJob, TPUJobSpec, TPUSpec,
    )
    from tfk8s_tpu_torch.cmd.server import Server

    if args.file:
        job = load_manifest(args.file)
        if job.metadata.namespace != opts.namespace:
            log.warning(
                "run: overriding manifest namespace %r with --namespace %r",
                job.metadata.namespace, opts.namespace,
            )
            job.metadata.namespace = opts.namespace
    elif args.entrypoint:
        job = TPUJob(
            metadata=ObjectMeta(name=args.name, namespace=opts.namespace),
            spec=TPUJobSpec(
                replica_specs={
                    ReplicaType.WORKER: ReplicaSpec(
                        replicas=args.replicas,
                        template=ContainerSpec(
                            entrypoint=args.entrypoint,
                            env=json.loads(args.env or "{}"),
                        ),
                    )
                },
                tpu=TPUSpec(accelerator=args.accelerator),
                run_policy=RunPolicy(scheduling=SchedulingPolicy(gang=True)),
            ),
        )
    else:
        log.error("run: one of --file or --entrypoint is required")
        return 2

    stop = threading.Event()
    server = Server(opts)
    server.run(stop, block=False)
    name = job.metadata.name
    server.clientset.tpujobs(opts.namespace).create(job)
    log.info("submitted %s/%s; waiting for completion", opts.namespace, name)

    deadline = time.time() + args.timeout
    code = 1
    while time.time() < deadline:
        try:
            cur = server.clientset.tpujobs(opts.namespace).get(name)
        except Exception:
            time.sleep(0.2)
            continue
        if helpers.has_condition(cur.status, JobConditionType.SUCCEEDED):
            log.info("job succeeded")
            code = 0
            break
        if helpers.has_condition(cur.status, JobConditionType.FAILED):
            cond = helpers.get_condition(cur.status, JobConditionType.FAILED)
            log.error("job failed: %s — %s", cond.reason, cond.message)
            code = 1
            break
        time.sleep(0.2)
    else:
        log.error("timed out after %.0fs", args.timeout)
    stop.set()
    server.shutdown()
    return code


def load_manifest(path: str):
    """Decode a TPUJob (or any scheme kind) from a YAML/JSON manifest. A
    host without PyYAML reads JSON only."""
    from tfk8s_tpu_torch.api import serde

    with open(path) as f:
        text = f.read()
    try:
        import yaml

        try:
            data = yaml.safe_load(text)
        except yaml.YAMLError as exc:
            raise ValueError(f"{path}: malformed YAML: {exc}") from exc
    except ImportError:
        data = json.loads(text)
    if not isinstance(data, dict):
        raise ValueError(
            f"{path}: manifest must be a mapping, got {type(data).__name__}"
        )
    return serde.decode_object(data)


def _cmd_train(args: argparse.Namespace) -> int:
    from tfk8s_tpu_torch.runtime import registry

    fn = registry.resolve(args.entrypoint)
    registry.call(fn, json.loads(args.env or "{}"), threading.Event())
    return 0


def _cmd_apiserver(args: argparse.Namespace) -> int:
    from tfk8s_tpu_torch.client.apiserver import APIServer, AuthConfig, TLSServerConfig
    from tfk8s_tpu_torch.client.store import ClusterStore

    tls = None
    ca_pem = ""
    if args.self_signed:
        # dev PKI: mint CA + server cert (SANs cover the bind host) so a
        # secured cluster comes up with one flag
        from tfk8s_tpu_torch.client.tlsutil import generate_ca, issue_cert

        ca = generate_ca()
        sans = [args.host] if args.host not in ("127.0.0.1", "localhost") else []
        sans += ["127.0.0.1", "localhost"]
        server_pair = issue_cert(ca, "tfk8s-apiserver", sans=sans)
        ca_cert_path, _ = ca.write(args.self_signed, "ca")
        cert_path, key_path = server_pair.write(args.self_signed, "apiserver")
        tls = TLSServerConfig(cert_path, key_path, client_ca_file=ca_cert_path)
        ca_pem = ca.cert_pem.decode()
    elif args.tls_cert or args.tls_key or args.client_ca:
        # half a TLS config must be a startup error, never a silent
        # downgrade to plaintext (tokens would go over the wire in clear)
        if not (args.tls_cert and args.tls_key):
            log.error("--tls-cert and --tls-key must be given together "
                      "(got cert=%r key=%r)", args.tls_cert, args.tls_key)
            return 2
        tls = TLSServerConfig(
            args.tls_cert, args.tls_key, client_ca_file=args.client_ca or None
        )
        if args.client_ca:
            with open(args.client_ca) as f:
                ca_pem = f.read()
    auth = AuthConfig.from_token_file(args.token_file) if args.token_file else None
    if auth is not None and tls is None:
        # bearer tokens over plaintext HTTP are sniffable: a silent
        # downgrade must be a startup error
        log.error("--token-file requires TLS (--tls-cert/--tls-key or "
                  "--self-signed): refusing to accept bearer tokens over "
                  "plaintext HTTP")
        return 2

    # the embedded credential must be able to WRITE (a kubelet or
    # operator bootstrapped from this kubeconfig creates pods); resolve
    # it BEFORE binding the listener so the error path leaks no socket
    rw_token = None
    if args.write_kubeconfig and auth and auth.tokens:
        rw_token = next(
            (t for t, u in auth.tokens.items() if not u.readonly), None
        )
        if rw_token is None:
            log.error("--write-kubeconfig: token file has only "
                      "readonly credentials; nothing usable to embed")
            return 2

    from tfk8s_tpu_torch.utils.logging import Metrics

    metrics = Metrics()
    store = ClusterStore(
        journal_dir=args.journal_dir or None,
        fsync=not args.no_fsync,
        metrics=metrics,
    )
    if args.journal_dir:
        log.info(
            "journal: %s (replayed to rv %d)", args.journal_dir, store.resource_version
        )
    server = APIServer(
        store, host=args.host, port=args.port, tls=tls, auth=auth,
        metrics=metrics,
    )
    if args.write_kubeconfig:
        kc: dict = {"server": server.url}
        if ca_pem:
            kc["certificate_authority_data"] = ca_pem
        if rw_token is not None:
            kc["token"] = rw_token
        with open(args.write_kubeconfig, "w") as f:
            json.dump(kc, f)
    log.info("apiserver listening on %s", server.url)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        log.info("interrupted; shutting down")
    finally:
        server.shutdown()
    return 0


def _cmd_kubelet(args: argparse.Namespace) -> int:
    from tfk8s_tpu_torch.client.remote import clientset_from_kubeconfig
    from tfk8s_tpu_torch.runtime.kubelet import LocalKubelet

    cs = clientset_from_kubeconfig(args.kubeconfig)
    kubelet = LocalKubelet(cs, name=args.name)
    stop = threading.Event()
    log.info("kubelet %s watching pods via %s", args.name, args.kubeconfig)
    try:
        kubelet.run(stop)
        stop.wait()
    except KeyboardInterrupt:
        log.info("interrupted; shutting down")
    finally:
        stop.set()
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    args = _build_parser().parse_args(argv)
    if args.command == "train":
        init_logging()
        return _cmd_train(args)
    if args.command == "apiserver":
        init_logging()
        return _cmd_apiserver(args)
    if args.command == "kubelet":
        init_logging()
        return _cmd_kubelet(args)
    opts = Options.from_args(args)
    init_logging(opts.log_level_int())
    if args.command == "operator":
        return _cmd_operator(opts)
    if args.command == "run":
        return _cmd_run(opts, args)
    return 2


if __name__ == "__main__":
    sys.exit(main())
