"""CLI entrypoint — SURVEY.md C1 (`tf_operator/main.go`; sequence
Main → Option → flags → initlog → Run server, images/tf2.png).

The job half of the JAX package's ``cmd/main.py``, on the port's control
plane and entry points:

- ``operator``  run the reconcile server (the reference's only mode), with
                ``--gateway-port`` the serving front door too. Its store
                is in this process and nothing outside can reach it, so
                it takes no jobs and no TPUServe until the port's
                apiserver and remote client (ROADMAP item 19)
- ``run``       end-to-end local run: operator + kubelet in-process,
                submit one TPUJob, wait for a terminal condition
- ``train``     run a model entrypoint directly in this process (the
                data-plane launcher, no control plane — for debugging)

``python -m tfk8s_tpu_torch.cmd.main run --entrypoint
tfk8s_tpu_torch.models.mlp:train --accelerator cpu-1 --env
'{"TFK8S_DEVICE": "cpu"}'`` runs a job on the CPU; ``--accelerator
h100-1`` and no ``TFK8S_DEVICE`` run it on the card. The reference's
``apiserver``, ``kubelet`` and kubectl-like verbs are later slices.
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

    p_op = sub.add_parser("operator", help="run the operator server (its store is in this "
                          "process, so no job reaches it yet: use run)")
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


def main(argv: Optional[List[str]] = None) -> int:
    args = _build_parser().parse_args(argv)
    if args.command == "train":
        init_logging()
        return _cmd_train(args)
    opts = Options.from_args(args)
    init_logging(opts.log_level_int())
    if args.command == "operator":
        return _cmd_operator(opts)
    if args.command == "run":
        return _cmd_run(opts, args)
    return 2


if __name__ == "__main__":
    sys.exit(main())
