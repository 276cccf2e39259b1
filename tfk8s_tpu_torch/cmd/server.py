"""Operator server — SURVEY.md C3 (`tf_operator/app/server.go`, 'Run
server' in images/tf2.png): wires clients → informers → controllers and
runs until stopped.

A copy of the JAX package's ``cmd/server.py``: the store (in this
process, or with ``Options.kubeconfig`` a remote apiserver reached
through ``client/remote.py``), the clientset, the gang allocator over the
host inventory, the TPUJob and TPUServe controllers, the local kubelet,
which runs the port's entry points (unless ``Options.local_kubelet`` is
off and a ``kubelet`` process runs them), and, with
``Options.gateway_port``, the serving front door (``gateway/server.py``)
over the port's replica table. The reference's leader election and
metrics endpoint are not ported yet (ROADMAP item 19b).
"""

from __future__ import annotations

import threading
from typing import Optional

from tfk8s_tpu_torch.client.clientset import Clientset, RESTConfig
from tfk8s_tpu_torch.client.store import ClusterStore
from tfk8s_tpu_torch.cmd.options import Options
from tfk8s_tpu_torch.obs.trace import get_tracer
from tfk8s_tpu_torch.runtime.kubelet import LocalKubelet
from tfk8s_tpu_torch.trainer.gang import SliceAllocator
from tfk8s_tpu_torch.trainer.serve_controller import TPUServeController
from tfk8s_tpu_torch.trainer.tpujob_controller import TPUJobController
from tfk8s_tpu_torch.utils.logging import EventRecorder, Metrics, get_logger, init_logging

log = get_logger("server")


class Server:
    """Owns every long-lived component of one operator process."""

    def __init__(self, opts: Options, store: Optional[ClusterStore] = None):
        self.opts = opts
        # ALWAYS the process-default tracer: the kubelet and trainer
        # threads resolve get_tracer() themselves, so only the global
        # ring can hold the whole reconcile→pod→kubelet→trainer chain.
        # Isolation (tests) swaps the global via obs.trace.set_tracer,
        # never per-Server.
        self.tracer = get_tracer()
        self.metrics = Metrics()
        self.tracer.set_metrics(self.metrics)
        qps, burst = opts.qps, opts.burst
        if store is not None:
            self.store = store
        elif opts.kubeconfig:
            # remote backend: kubeconfig -> RemoteStore; credentials (CA
            # pin, bearer token, client cert) ride along like rest.Config.
            # The kubeconfig's client limits take precedence: they
            # describe the server being talked to.
            from tfk8s_tpu_torch.client.remote import load_kubeconfig, store_from_kubeconfig

            cfg = load_kubeconfig(opts.kubeconfig)
            self.store = store_from_kubeconfig(cfg)
            qps, burst = cfg.qps, cfg.burst
        else:
            self.store = ClusterStore(metrics=self.metrics)
        self.clientset = Clientset.new_for_config(
            self.store, RESTConfig(qps=qps, burst=burst)
        )
        self.allocator = SliceAllocator(opts.capacity or None)
        self.recorder = EventRecorder(sink=self.clientset)
        # image-input decode metrics land on this registry: in the
        # single-process deployment (operator + local kubelet + trainer
        # threads) the data plane's counters sit beside the controller's
        from tfk8s_tpu_torch.data.images import set_metrics as _images_set_metrics

        _images_set_metrics(self.metrics)
        self.controller = TPUJobController(
            self.clientset,
            allocator=self.allocator,
            recorder=self.recorder,
            metrics=self.metrics,
            resync_period=opts.resync_period_s,
            tracer=self.tracer,
        )
        # the serving control plane (TPUServe -> model-server replicas)
        # shares the clientset/recorder/registry: the decode loop's
        # tfk8s_serving_* series land on the same registry
        from tfk8s_tpu_torch.runtime.server import set_metrics as _serve_set_metrics

        _serve_set_metrics(self.metrics)
        self.serve_controller = TPUServeController(
            self.clientset,
            recorder=self.recorder,
            metrics=self.metrics,
            resync_period=opts.resync_period_s,
            tracer=self.tracer,
        )
        self.kubelet = LocalKubelet(self.clientset) if opts.local_kubelet else None
        self.gateway = None  # started in run() when opts.gateway_port

    def run(self, stop: threading.Event, block: bool = True) -> None:
        """Start the gateway, the kubelet and both controllers. With
        ``block=False`` returns once everything is started."""
        init_logging(self.opts.log_level_int())
        if self.opts.gateway_port:
            # the front door routes to whatever replicas the port's table
            # holds, whichever controller reconciled them
            from tfk8s_tpu_torch.gateway.server import GatewayServer

            self.gateway = GatewayServer(
                self.clientset,
                port=self.opts.gateway_port,
                metrics=self.metrics,
            )
            gw_port = self.gateway.serve_background()
            log.info("gateway front door on 127.0.0.1:%d", gw_port)
        if self.kubelet:
            self.kubelet.run(stop)  # informer-driven; returns immediately
        log.info("starting controllers with %d workers", self.opts.workers)
        self.serve_controller.run(self.opts.workers, stop, block=False)
        self.controller.run(self.opts.workers, stop, block=block)
        if block:
            stop.wait()

    def shutdown(self) -> None:
        if self.gateway is not None:
            self.gateway.shutdown()
        self.controller.controller.shutdown()
        self.serve_controller.controller.shutdown()
