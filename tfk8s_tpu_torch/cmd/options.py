"""Operator options/flags — SURVEY.md C2 (`tf_operator/app/options/
options.go`; 'Add flag' / 'Init flag and initlog' in images/tf2.png at
k8s-operator.md:57).

A copy of the JAX package's ``cmd/options.py``: the reconcile workers,
the client limits, leader election (``--leader-elect`` and the lease
flags), the host inventory, the remote apiserver (``--kubeconfig``) and
whether the in-process kubelet runs (``--no-local-kubelet``, for an
operator whose pods a ``kubelet`` process runs), the metrics endpoint
(``--metrics-port``) and the serving front door (``--gateway-port``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import socket
import uuid
from typing import Dict, Optional

from tfk8s_tpu_torch.controller.controller import DEFAULT_SYNC_WORKERS


@dataclasses.dataclass
class Options:
    # controller
    workers: int = DEFAULT_SYNC_WORKERS
    resync_period_s: float = 0.0
    namespace: str = "default"
    # client rate limits (C10: token-bucket on the REST client)
    qps: float = 50.0
    burst: int = 100
    # leader election (C17)
    leader_elect: bool = False
    lease_name: str = "tfk8s-tpu-operator"
    lease_duration_s: float = 15.0
    identity: str = ""
    # cluster inventory: accelerator type -> number of slices
    capacity: Dict[str, int] = dataclasses.field(default_factory=dict)
    # run the in-process kubelet (hermetic/local backend)
    local_kubelet: bool = True
    # path to a kubeconfig JSON ({"server": "http://host:port", ...});
    # when set, the operator talks to that remote apiserver instead of an
    # in-process store (the reference's kubeconfig flag,
    # k8s-operator.md:206-207)
    kubeconfig: str = ""
    # observability endpoint (/metrics, /healthz, /events, /traces);
    # 0 = disabled
    metrics_port: int = 0
    # inference front door (POST /v1/serve/<ns>/<name>); 0 = disabled
    gateway_port: int = 0
    # logging
    log_level: str = "info"

    def __post_init__(self):
        if not self.identity:
            # pid + random suffix: unique across processes on one host
            # (two identical operator processes routinely get the same
            # object address, so id(self) would collide)
            self.identity = (
                f"{socket.gethostname()}-{os.getpid()}-{uuid.uuid4().hex[:8]}"
            )

    @staticmethod
    def add_flags(parser: argparse.ArgumentParser) -> None:
        g = parser.add_argument_group("operator")
        g.add_argument("--workers", type=int, default=DEFAULT_SYNC_WORKERS,
                       help="reconcile worker count (Controller.Run N; "
                            "per-key in-flight exclusion makes raising "
                            "this safe)")
        g.add_argument("--resync-period", type=float, default=0.0, dest="resync_period_s",
                       help="informer resync period in seconds (0 = disabled)")
        g.add_argument("--namespace", default="default")
        g.add_argument("--qps", type=float, default=50.0,
                       help="client token-bucket refill rate")
        g.add_argument("--burst", type=int, default=100,
                       help="client token-bucket burst size")
        g.add_argument("--leader-elect", action="store_true", dest="leader_elect",
                       help="gate reconciling behind a lease (HA)")
        g.add_argument("--lease-name", default="tfk8s-tpu-operator")
        g.add_argument("--lease-duration", type=float, default=15.0,
                       dest="lease_duration_s")
        g.add_argument("--identity", default="",
                       help="leader-election identity (default: hostname-derived)")
        g.add_argument("--capacity", default="{}",
                       help='host inventory as JSON, e.g. \'{"h100-8": 4}\'')
        g.add_argument("--no-local-kubelet", action="store_false",
                       dest="local_kubelet",
                       help="do not run the in-process pod executor")
        g.add_argument("--kubeconfig", default="",
                       help="kubeconfig JSON path; talk to a remote "
                       "apiserver instead of the in-process store")
        g.add_argument("--metrics-port", type=int, default=0, dest="metrics_port",
                       help="serve /metrics, /healthz, /events, /traces "
                            "on this port (0=off)")
        g.add_argument("--gateway-port", type=int, default=0, dest="gateway_port",
                       help="serve the inference front door (POST "
                            "/v1/serve/<ns>/<name>) on this port (0=off)")
        g.add_argument("--log-level", default="info",
                       choices=["debug", "info", "warning", "error"])

    @classmethod
    def from_args(cls, args: argparse.Namespace) -> "Options":
        capacity = args.capacity
        if isinstance(capacity, str):
            capacity = json.loads(capacity or "{}")
        return cls(
            workers=args.workers,
            resync_period_s=args.resync_period_s,
            namespace=args.namespace,
            qps=args.qps,
            burst=args.burst,
            leader_elect=args.leader_elect,
            lease_name=args.lease_name,
            lease_duration_s=args.lease_duration_s,
            identity=args.identity,
            capacity=capacity,
            local_kubelet=args.local_kubelet,
            kubeconfig=getattr(args, "kubeconfig", ""),
            metrics_port=args.metrics_port,
            gateway_port=getattr(args, "gateway_port", 0),
            log_level=args.log_level,
        )

    def log_level_int(self) -> int:
        return getattr(logging, self.log_level.upper(), logging.INFO)
