"""CLI entrypoint — SURVEY.md C1 (`tf_operator/main.go`; sequence
Main → Option → flags → initlog → Run server, images/tf2.png).

A copy of the JAX package's ``cmd/main.py``, on the port's control plane
and entry points:

- ``operator``  run the reconcile server (the reference's only mode), with
                ``--gateway-port`` the serving front door too, with
                ``--leader-elect`` behind a lease (HA), with
                ``--metrics-port`` the /metrics endpoint; with
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
- ``submit`` / ``get`` / ``describe`` / ``delete`` / ``logs`` / ``patch`` /
  ``scale`` / ``apply`` / ``suspend`` / ``resume``  the kubectl verbs of
                the reference workflow (k8s-operator.md:33-34 REST paths,
                :50-52 ``kubectl get pod``), driven over the same remote
                client the operator uses

``python -m tfk8s_tpu_torch.cmd.main run --entrypoint
tfk8s_tpu_torch.models.mlp:train --accelerator cpu-1 --env
'{"TFK8S_DEVICE": "cpu"}'`` runs a job on the CPU; ``--accelerator
h100-1`` and no ``TFK8S_DEVICE`` run it on the card. A pod's entry point
runs on the card unless its own env says ``TFK8S_DEVICE=cpu``; the
``kubelet`` verb sets no device for it (the reference's kubelet honours
``TFK8S_JAX_PLATFORM``, which the port has no counterpart of). Against an
``apiserver``, ``submit --kubeconfig kc.json --file job.json`` sends a job
and ``operator --kubeconfig kc.json --leader-elect`` reconciles it behind a
lease, with standbys taking over when the leader stops.
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

    # every scheme kind is reachable through the generic verbs; deriving
    # the choice list from the apiserver's plural table means a newly
    # registered kind is a one-line change (and the wire-conformance test
    # fails loudly if the tables ever drift apart)
    from tfk8s_tpu_torch.client.apiserver import PLURALS

    kind_choices = tuple(sorted(PLURALS))

    def kubectlish(name, help_):
        p = sub.add_parser(name, help=help_)
        p.add_argument("--kubeconfig", required=True)
        p.add_argument("-n", "--namespace", default="default")
        return p

    p_sub = kubectlish("submit", "create an object from a manifest "
                                 "(any scheme kind: TPUJob, TPUServe, ...)")
    p_sub.add_argument("--file", required=True,
                       help="manifest (YAML or JSON)")

    p_get = kubectlish("get", "list objects of a kind (or one by name)")
    p_get.add_argument("name", nargs="?", default="")
    p_get.add_argument("-o", "--output", choices=("table", "json"),
                       default="table")
    p_get.add_argument("--kind", default="tpujobs", choices=kind_choices)
    p_get.add_argument("-l", "--selector", default="",
                       help="label selector, e.g. a=b,c=d")
    p_get.add_argument("-w", "--watch", action="store_true",
                       help="after listing, stream changes (kubectl get -w)")
    p_get.add_argument("--watch-timeout", type=float, default=0.0,
                       help="stop watching after N seconds (0 = forever)")

    p_patch = kubectlish("patch", "merge-patch fields of one object "
                                  "(kubectl patch parity; RFC 7386)")
    p_patch.add_argument("name")
    p_patch.add_argument("-p", "--patch", required=True,
                         help='merge patch as JSON, e.g. '
                              '\'{"spec": {"runPolicy": {"suspend": true}}}\'')
    p_patch.add_argument("--kind", default="tpujobs", choices=kind_choices)
    p_patch.add_argument("--subresource", default="",
                         choices=("", "status"),
                         help="patch the status subresource instead")

    p_desc = kubectlish("describe", "full detail of one object + its events")
    p_desc.add_argument("name")
    p_desc.add_argument("--kind", default="tpujobs", choices=kind_choices)

    p_del = kubectlish("delete", "delete an object (finalizer-honoring)")
    p_del.add_argument("name")
    p_del.add_argument("--kind", default="tpujobs", choices=kind_choices)

    p_logs = kubectlish("logs", "print a pod's captured log tail")
    p_logs.add_argument("name", nargs="?", default="",
                        help="pod name (omit with --job to dump the whole job)")
    p_logs.add_argument("--job", default="",
                        help="print logs for every pod of this TPUJob")
    p_logs.add_argument("-f", "--follow", action="store_true",
                        help="stream new lines until the pod terminates "
                        "(single-pod form only)")
    p_logs.add_argument("--follow-timeout", type=float, default=0.0,
                        help="stop following after N seconds (0 = until "
                        "the pod terminates)")

    p_scale = kubectlish("scale", "change a TPUJob's replica count")
    p_scale.add_argument("name")
    p_scale.add_argument("--replicas", type=int, required=True)
    p_scale.add_argument("--replica-type", default="Worker",
                         help="which replica set to scale (default Worker)")

    p_apply = kubectlish("apply", "create or update a TPUJob from a manifest")
    p_apply.add_argument("--file", required=True,
                         help="TPUJob manifest (YAML or JSON)")

    p_sus = kubectlish("suspend", "evict a TPUJob's gang, freeing its slices")
    p_sus.add_argument("name")
    p_res = kubectlish("resume", "re-admit a suspended TPUJob (checkpoint resume)")
    p_res.add_argument("name")
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


def _job_phase(job) -> str:
    """Last True condition wins. Correct because ``helpers.set_condition``
    keeps exclusive conditions (Running/Succeeded/Failed/Restarting)
    mutually exclusive — at most one is True at a time."""
    for cond in reversed(job.status.conditions):
        if cond.status:
            return str(getattr(cond.type, "value", cond.type))
    return "Pending"


def _age(ts) -> str:
    import time

    if not ts:
        return "-"
    s = max(0, int(time.time() - ts))
    if s < 120:
        return f"{s}s"
    if s < 7200:
        return f"{s // 60}m"
    return f"{s // 3600}h"


def _load_job_for_namespace(args: argparse.Namespace, verb: str):
    """Shared by submit/apply: load the manifest and apply the -n
    override. -n always wins (matching _cmd_run): a manifest omitting
    the field decodes to "default", so "was it set?" is undetectable —
    warn only when the manifest visibly disagrees."""
    job = load_manifest(args.file)
    if job.metadata.namespace != args.namespace:
        log.warning(
            "%s: overriding manifest namespace %r with --namespace %r",
            verb, job.metadata.namespace, args.namespace,
        )
        job.metadata.namespace = args.namespace
    return job


def _cmd_submit(args: argparse.Namespace) -> int:
    from tfk8s_tpu_torch.client.apiserver import KIND_TO_PLURAL
    from tfk8s_tpu_torch.client.remote import clientset_from_kubeconfig

    cs = clientset_from_kubeconfig(args.kubeconfig)
    obj = _load_job_for_namespace(args, "submit")
    # generic by the manifest's own kind: `submit --file gpt-serve.yaml`
    # creates a TPUServe through the same verb
    created = cs.generic(obj.kind, obj.metadata.namespace).create(obj)
    singular = KIND_TO_PLURAL.get(created.kind, created.kind.lower() + "s")[:-1]
    print(f"{singular} {created.metadata.namespace}/{created.metadata.name} created")
    return 0


def _cmd_get(args: argparse.Namespace) -> int:
    from tfk8s_tpu_torch.api import serde
    from tfk8s_tpu_torch.client.apiserver import PLURALS, parse_selector
    from tfk8s_tpu_torch.client.remote import clientset_from_kubeconfig

    cs = clientset_from_kubeconfig(args.kubeconfig)
    client = cs.generic(PLURALS[args.kind], args.namespace)
    selector = parse_selector(getattr(args, "selector", ""))
    if args.name:
        objs = [client.get(args.name)]
        rv = objs[0].metadata.resource_version
    else:
        objs, rv = client.list(label_selector=selector or None)
    if args.output == "json":
        print(json.dumps([serde.to_wire(o) for o in objs], indent=2))
        if getattr(args, "watch", False):
            return _stream_watch(client, args, rv, selector)
        return 0
    if args.kind == "tpujobs":
        rows = [("NAME", "PHASE", "RESTARTS", "AGE")] + [
            (
                j.metadata.name,
                _job_phase(j),
                str(j.status.gang_restarts),
                _age(j.metadata.creation_timestamp),
            )
            for j in objs
        ]
    elif args.kind == "tpuserves":
        rows = [("NAME", "READY", "UPDATED", "VERSION", "AGE")] + [
            (
                s.metadata.name,
                f"{s.status.ready_replicas}/{s.spec.replicas}",
                str(s.status.updated_replicas),
                s.status.observed_version or "-",
                _age(s.metadata.creation_timestamp),
            )
            for s in objs
        ]
    elif args.kind == "events":
        rows = [("LAST SEEN", "REASON", "OBJECT", "COUNT", "MESSAGE")] + [
            (
                _age(e.last_timestamp),
                e.reason,
                f"{e.involved_kind}/{e.involved_key}",
                str(e.count),
                e.message[:60],
            )
            for e in sorted(objs, key=lambda e: e.last_timestamp or 0)
        ]
    else:
        def phase_of(o) -> str:
            status = getattr(o, "status", None)  # Services carry no status
            phase = getattr(status, "phase", "") if status is not None else ""
            return str(getattr(phase, "value", phase)) or "-"

        rows = [("NAME", "PHASE", "AGE")] + [
            (o.metadata.name, phase_of(o), _age(o.metadata.creation_timestamp))
            for o in objs
        ]
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    for r in rows:
        print("  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip())
    if getattr(args, "watch", False):
        return _stream_watch(client, args, rv, selector)
    return 0


def _stream_watch(
    client, args: argparse.Namespace, since_rv: int, selector=None
) -> int:
    """`kubectl get -w` parity: after the initial table, stream one line
    per change event from the apiserver's watch endpoint (the same
    List-then-Watch contract the reflector uses, images/informer1.png)
    until interrupted or --watch-timeout elapses. The `-l` selector that
    filtered the table filters the stream too (client-side — the watch
    endpoint streams the whole kind)."""
    import time as _time

    from tfk8s_tpu_torch.api import serde
    from tfk8s_tpu_torch.client.store import match_labels

    def phase_of(o) -> str:
        status = getattr(o, "status", None)
        phase = getattr(status, "phase", "") if status is not None else ""
        if args.kind == "tpujobs":
            phase = _job_phase(o)
        return str(getattr(phase, "value", phase)) or "-"

    w = client.watch(since_rv=since_rv)
    deadline = (
        _time.time() + args.watch_timeout if args.watch_timeout else None
    )
    try:
        while deadline is None or _time.time() < deadline:
            ev = w.next(timeout=0.5)
            if ev is None:
                continue
            if ev.object.metadata.namespace != args.namespace:
                continue
            if args.name and ev.object.metadata.name != args.name:
                continue
            if selector and not match_labels(selector, ev.object.metadata.labels):
                continue
            if args.output == "json":
                print(
                    json.dumps(
                        {"type": ev.type.value,
                         "object": serde.to_wire(ev.object)}
                    ),
                    flush=True,
                )
            else:
                print(
                    f"{ev.type.value:<9} {ev.object.metadata.name}  "
                    f"{phase_of(ev.object)}",
                    flush=True,
                )
    except KeyboardInterrupt:
        pass
    finally:
        w.stop()
    return 0


def _cmd_describe(args: argparse.Namespace) -> int:
    from tfk8s_tpu_torch.api import serde
    from tfk8s_tpu_torch.client.apiserver import PLURALS
    from tfk8s_tpu_torch.client.remote import clientset_from_kubeconfig

    cs = clientset_from_kubeconfig(args.kubeconfig)
    kind = PLURALS[getattr(args, "kind", "tpujobs")]
    obj = cs.generic(kind, args.namespace).get(args.name)
    print(json.dumps(serde.to_wire(obj), indent=2))
    # kubectl-describe parity: the object's event history, read from the
    # cluster's mirrored Event objects (operator EventRecorder sink)
    key = f"{args.namespace}/{args.name}"
    events, _rv = cs.generic("Event", args.namespace).list()
    mine = sorted(
        (e for e in events if e.involved_key == key),
        key=lambda e: e.last_timestamp or 0,
    )
    if mine:
        print("\nEvents:")
        for e in mine:
            print(
                f"  {_age(e.last_timestamp):>9}  {e.reason:<22} x{e.count}"
                + (f"  {e.message}" if e.message else "")
            )
    return 0


def _cmd_scale(args: argparse.Namespace) -> int:
    """The reference's 扩容 capability (k8s-operator.md:1) as a verb:
    edit the replica count; the controller re-admits the gang and
    replaces stale-env pods (trainer/tpujob_controller.py). TPU-type jobs
    couple replicas to slice shape, so the apiserver may 422 a count the
    accelerator cannot host — surfaced as-is."""
    from tfk8s_tpu_torch.api.types import ReplicaType
    from tfk8s_tpu_torch.client.remote import clientset_from_kubeconfig

    cs = clientset_from_kubeconfig(args.kubeconfig)
    try:
        rtype = ReplicaType(args.replica_type)
    except ValueError:
        log.error("scale: unknown replica type %r (use %s)",
                  args.replica_type, [t.value for t in ReplicaType])
        return 1
    job = cs.tpujobs(args.namespace).get(args.name)
    if rtype not in job.spec.replica_specs:
        log.error("scale: job %s has no %s replica set",
                  args.name, rtype.value)
        return 1
    # merge-patch touches ONLY the replica count — no resourceVersion, no
    # conflict with the operator's concurrent status writes
    cs.tpujobs(args.namespace).patch(
        args.name,
        {"spec": {"replicaSpecs": {rtype.value: {"replicas": args.replicas}}}},
    )
    print(f"tpujob {args.namespace}/{args.name} scaled: "
          f"{rtype.value}={args.replicas}")
    return 0


def _set_suspend(args: argparse.Namespace, value: bool) -> int:
    from tfk8s_tpu_torch.client.remote import clientset_from_kubeconfig

    cs = clientset_from_kubeconfig(args.kubeconfig)
    job = cs.tpujobs(args.namespace).get(args.name)
    if job.spec.run_policy.suspend == value:
        print(f"tpujob {args.namespace}/{args.name} already "
              f"{'suspended' if value else 'running'}")
        return 0
    # merge-patch on the one field this verb owns — conflict-free by
    # construction
    cs.tpujobs(args.namespace).patch(
        args.name, {"spec": {"runPolicy": {"suspend": value}}}
    )
    print(f"tpujob {args.namespace}/{args.name} "
          f"{'suspended' if value else 'resumed'}")
    return 0


def _cmd_suspend(args: argparse.Namespace) -> int:
    return _set_suspend(args, True)


def _cmd_resume(args: argparse.Namespace) -> int:
    return _set_suspend(args, False)


def _cmd_apply(args: argparse.Namespace) -> int:
    """kubectl-apply parity: create the manifest's job, or PATCH its spec
    when it already exists. The patch is computed as the exact diff
    (replace_patch): fields removed from the manifest get explicit nulls,
    so apply keeps REPLACE semantics over the conflict-free merge-patch
    verb — no resourceVersion, no retry loop (status stays untouched by
    the subresource isolation on the server)."""
    from tfk8s_tpu_torch.api import serde
    from tfk8s_tpu_torch.client.remote import clientset_from_kubeconfig
    from tfk8s_tpu_torch.client.store import AlreadyExists, NotFound, replace_patch

    cs = clientset_from_kubeconfig(args.kubeconfig)
    job = _load_job_for_namespace(args, "apply")
    client = cs.tpujobs(args.namespace)
    for _ in range(2):  # second pass only for the delete/create races
        try:
            client.create(job)
            print(f"tpujob {args.namespace}/{job.metadata.name} created")
            return 0
        except AlreadyExists:
            pass
        try:
            current = client.get(job.metadata.name)
            # default the manifest locally before diffing: current is
            # already defaulted, so an undefaulted desired spec would diff
            # (and null) every server-filled field just for admission to
            # put it back — and "unchanged" would never trigger
            from tfk8s_tpu_torch.api import set_defaults

            set_defaults(job)
            patch = replace_patch(
                serde.to_wire(current.spec), serde.to_wire(job.spec)
            )
            if not patch:
                print(f"tpujob {args.namespace}/{job.metadata.name} unchanged")
                return 0
            client.patch(job.metadata.name, {"spec": patch})
            print(f"tpujob {args.namespace}/{job.metadata.name} configured")
            return 0
        except NotFound:  # deleted since AlreadyExists; loop recreates
            continue
    log.error("apply: object is churning (concurrent delete/create); try again")
    return 1


def _cmd_delete(args: argparse.Namespace) -> int:
    from tfk8s_tpu_torch.client.apiserver import PLURALS
    from tfk8s_tpu_torch.client.remote import clientset_from_kubeconfig

    cs = clientset_from_kubeconfig(args.kubeconfig)
    plural = getattr(args, "kind", "tpujobs")
    cs.generic(PLURALS[plural], args.namespace).delete(args.name)
    print(f"{plural[:-1]} {args.namespace}/{args.name} deleted")
    return 0


def _cmd_patch(args: argparse.Namespace) -> int:
    """`kubectl patch` parity: an RFC 7386 merge patch straight to the
    wire verb — touch only the fields named; no resourceVersion, no
    read-modify-write. The server runs admission on the merged object
    (422 on an invalid result)."""
    from tfk8s_tpu_torch.client.apiserver import PLURALS
    from tfk8s_tpu_torch.client.remote import clientset_from_kubeconfig

    cs = clientset_from_kubeconfig(args.kubeconfig)
    try:
        patch = json.loads(args.patch)
    except ValueError as e:
        log.error("patch: --patch is not valid JSON: %s", e)
        return 1
    if not isinstance(patch, dict):
        log.error("patch: --patch must be a JSON object, got %s",
                  type(patch).__name__)
        return 1
    # catch silently-dropped fields before reporting success: subresource
    # isolation applies EXACTLY ONE side of the object per call, so any
    # key on the wrong side of the split would vanish while the CLI
    # printed "patched"
    if args.subresource == "status":
        if "status" not in patch:
            log.error(
                "patch: --subresource status expects the wrapper form "
                '\'{"status": {...}}\'; this patch would apply nothing'
            )
            return 1
        # envelope keys are server-honored on status patches
        # (apiVersion/kind are the wire envelope; within metadata ONLY
        # resourceVersion — the optimistic precondition — is read) —
        # every genuinely-dropped key is rejected
        extras = sorted(
            set(patch) - {"status", "metadata", "apiVersion", "kind"}
        )
        meta = patch.get("metadata") or {}
        if not isinstance(meta, dict):
            log.error(
                "patch: metadata must be a JSON object, got %s",
                type(meta).__name__,
            )
            return 1
        meta_extras = sorted(set(meta) - {"resourceVersion"})
        if extras or meta_extras:
            dropped = extras + [f"metadata.{k}" for k in meta_extras]
            log.error(
                "patch: --subresource status applies ONLY the status "
                "subtree (+ the metadata.resourceVersion precondition); "
                "%s would be silently dropped — patch them in a separate "
                "call without --subresource", dropped,
            )
            return 1
    elif "status" in patch:
        log.error(
            "patch: status is a subresource and would be dropped by "
            "subresource isolation — patch it in a separate call with "
            "--subresource status"
        )
        return 1
    kind = PLURALS[args.kind]
    client = cs.generic(kind, args.namespace)
    if args.subresource == "status":
        out = client.patch_status(args.name, patch)
    else:
        out = client.patch(args.name, patch)
    sub = "/status" if args.subresource else ""
    print(
        f"{args.kind[:-1]} {args.namespace}/{args.name}{sub} patched "
        f"(rv {out.metadata.resource_version})"
    )
    return 0


def _cmd_logs(args: argparse.Namespace) -> int:
    """`kubectl logs` parity: the tail rides pod status (captured by the
    kubelet, PodStatus.log_tail), so reading it is a plain GET — no
    kubelet proxy endpoint needed, unlike real k8s."""
    from tfk8s_tpu_torch.client.remote import clientset_from_kubeconfig
    from tfk8s_tpu_torch.trainer import labels as L

    cs = clientset_from_kubeconfig(args.kubeconfig)
    if bool(args.name) == bool(args.job):
        log.error("logs: pass exactly one of POD_NAME or --job JOB")
        return 1
    if getattr(args, "follow", False) and args.job:
        log.error("logs: --follow works with a single POD_NAME")
        return 1
    if args.name:
        pods = [cs.pods(args.namespace).get(args.name)]
    else:
        pods, _rv = cs.pods(args.namespace).list(
            label_selector=L.job_selector(args.job)
        )
        if not pods:
            log.error("logs: no pods found for job %r", args.job)
            return 1
    for pod in sorted(pods, key=lambda p: p.metadata.name):
        if args.job:
            print(f"==> {pod.metadata.namespace}/{pod.metadata.name} "
                  f"({pod.status.phase.value}) <==")
        for line in pod.status.log_tail:
            print(line)
    if getattr(args, "follow", False):
        return _follow_logs(cs, args, pods[0].status.log_tail)
    return 0


def _follow_logs(cs, args: argparse.Namespace, printed) -> int:
    """`kubectl logs -f` parity: poll the pod's bounded status.log_tail
    and print what's new. The tail is a rolling window, so new output is
    aligned by the largest overlap between the old tail's end and the
    new tail's start; a window that rotated entirely between polls
    prints whole (lines older than the window are gone by design)."""
    import time as _time

    from tfk8s_tpu_torch.api.types import PodPhase
    from tfk8s_tpu_torch.client.store import NotFound as _NotFound

    last = list(printed)
    deadline = (
        _time.time() + args.follow_timeout if args.follow_timeout else None
    )
    try:
        while deadline is None or _time.time() < deadline:
            _time.sleep(0.5)
            try:
                pod = cs.pods(args.namespace).get(args.name)
            except _NotFound:
                return 0  # pod deleted; stream over
            tail = pod.status.log_tail
            if tail != last:
                start = 0
                for k in range(min(len(last), len(tail)), 0, -1):
                    if last[-k:] == tail[:k]:
                        start = k
                        break
                for line in tail[start:]:
                    print(line, flush=True)
                last = list(tail)
            if pod.status.phase in (
                PodPhase.SUCCEEDED, PodPhase.FAILED, PodPhase.DRAINED
            ):
                return 0
    except KeyboardInterrupt:
        pass
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
    if args.command in (
        "submit", "get", "describe", "delete", "logs", "scale", "apply",
        "suspend", "resume", "patch",
    ):
        init_logging()
        handler = {
            "submit": _cmd_submit,
            "patch": _cmd_patch,
            "get": _cmd_get,
            "describe": _cmd_describe,
            "delete": _cmd_delete,
            "logs": _cmd_logs,
            "scale": _cmd_scale,
            "apply": _cmd_apply,
            "suspend": _cmd_suspend,
            "resume": _cmd_resume,
        }[args.command]
        from tfk8s_tpu_torch.client.store import StoreError

        try:
            return handler(args)
        except StoreError as exc:
            log.error("%s: %s", args.command, exc)
            return 1
        except (OSError, ValueError, KeyError) as exc:
            # missing kubeconfig/manifest file, malformed manifest,
            # unregistered kind — user errors, not stack traces
            log.error("%s: %s: %s", args.command, type(exc).__name__, exc)
            return 1
    opts = Options.from_args(args)
    init_logging(opts.log_level_int())
    if args.command == "operator":
        return _cmd_operator(opts)
    if args.command == "run":
        return _cmd_run(opts, args)
    return 2


if __name__ == "__main__":
    sys.exit(main())
