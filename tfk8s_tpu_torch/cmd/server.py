"""Operator server — SURVEY.md C3 (`tf_operator/app/server.go`, 'Run
server' in images/tf2.png): wires clients → informers → controller and
runs until stopped.

A copy of the JAX package's ``cmd/server.py`` for the job half: the
in-process store, the clientset, the gang allocator over the host
inventory, the TPUJob controller and the local kubelet, which runs the
port's entry points. The reference's leader election, remote store,
serving controller, gateway and metrics endpoint belong to later slices.
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
        self.store = store if store is not None else ClusterStore(metrics=self.metrics)
        self.clientset = Clientset.new_for_config(
            self.store, RESTConfig(qps=opts.qps, burst=opts.burst)
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
        self.kubelet = LocalKubelet(self.clientset)

    def run(self, stop: threading.Event, block: bool = True) -> None:
        """Start kubelet + controller. With ``block=False`` returns once
        everything is started."""
        init_logging(self.opts.log_level_int())
        self.kubelet.run(stop)  # informer-driven; returns immediately
        log.info("starting controllers with %d workers", self.opts.workers)
        self.controller.run(self.opts.workers, stop, block=block)
        if block:
            stop.wait()

    def shutdown(self) -> None:
        self.controller.controller.shutdown()
