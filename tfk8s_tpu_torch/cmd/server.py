"""Operator server — SURVEY.md C3 (`tf_operator/app/server.go`, 'Run
server' in images/tf2.png): wires clients → informers → controllers,
gates reconciling behind leader election when asked (k8s-operator.md:59),
and runs until stopped.

A copy of the JAX package's ``cmd/server.py``: the store (in this
process, or with ``Options.kubeconfig`` a remote apiserver reached
through ``client/remote.py``), the clientset, the gang allocator over the
host inventory, the TPUJob and TPUServe controllers, the local kubelet,
which runs the port's entry points (unless ``Options.local_kubelet`` is
off and a ``kubelet`` process runs them), with ``Options.leader_elect``
the lease gate ahead of both controllers (``controller/leaderelection.py``),
with ``Options.metrics_port`` the observability endpoint (/metrics,
/healthz, /events, /traces, /debug/*), and, with
``Options.gateway_port``, the serving front door (``gateway/server.py``)
over the port's replica table.
"""

from __future__ import annotations

import http.server
import json
import threading
import urllib.parse
from typing import Optional

from tfk8s_tpu_torch.client.clientset import Clientset, RESTConfig
from tfk8s_tpu_torch.client.store import ClusterStore
from tfk8s_tpu_torch.controller.leaderelection import LeaderElector
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
        # ring can hold the whole reconcile→pod→kubelet→trainer chain
        # /traces advertises. Isolation (tests) swaps the global via
        # obs.trace.set_tracer, never per-Server.
        self.tracer = get_tracer()
        self.metrics = Metrics()
        # span-drop pressure (tail sampling / ring eviction) surfaces on
        # this server's /metrics as tfk8s_trace_spans_dropped_total
        self.tracer.set_metrics(self.metrics)
        qps, burst = opts.qps, opts.burst
        if store is not None:
            self.store = store
        elif opts.kubeconfig:
            # remote backend: kubeconfig → RemoteStore, the reference's
            # BuildConfigFromFlags → NewForConfig path
            # (k8s-operator.md:92-102) — credentials (CA pin, bearer
            # token, client cert) ride along like rest.Config. The
            # kubeconfig's client limits take precedence — they describe
            # the server being talked to.
            from tfk8s_tpu_torch.client.remote import load_kubeconfig, store_from_kubeconfig

            cfg = load_kubeconfig(opts.kubeconfig)
            self.store = store_from_kubeconfig(cfg)
            qps, burst = cfg.qps, cfg.burst
        else:
            # the in-process store exports its watch-coalescing counter
            # (tfk8s_watch_coalesced_total) on this server's /metrics
            self.store = ClusterStore(metrics=self.metrics)
        self.clientset = Clientset.new_for_config(
            self.store, RESTConfig(qps=qps, burst=burst)
        )
        self.allocator = SliceAllocator(opts.capacity or None)
        self.recorder = EventRecorder(sink=self.clientset)
        # image-input decode metrics (tfk8s_images_decoded_total /
        # decode-seconds / queue-depth) land on this registry: in the
        # single-process deployment (operator + local kubelet + trainer
        # threads, the hermetic `tfk8s run` path) the data plane's
        # counters surface on the SAME /metrics the controller serves
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
        # the serving control plane (TPUServe -> batched model-server
        # replicas) shares the clientset/recorder/registry — the serving
        # data plane's request metrics land on the same /metrics
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
        self._threads: list = []
        self._http: Optional[http.server.ThreadingHTTPServer] = None
        self.gateway = None  # started in run() when opts.gateway_port

    # -- observability endpoint (SURVEY.md §5: absent in the reference;
    #    /metrics Prometheus text, /healthz, /events JSON, /traces JSON) --

    def start_metrics_server(self, port: int) -> int:
        """Bind and serve on a daemon thread; returns the bound port
        (useful with port=0 in tests)."""
        server = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                parsed = urllib.parse.urlparse(self.path)
                query = {
                    k: v[0]
                    for k, v in urllib.parse.parse_qs(parsed.query).items()
                }
                path = parsed.path
                if path == "/metrics":
                    body = server.metrics.prometheus_text().encode()
                    ctype = "text/plain; version=0.0.4"
                elif path == "/healthz":
                    body = b"ok"
                    ctype = "text/plain"
                elif path == "/events":
                    # ?key=<ns/name> and ?reason=<reason> filter
                    # server-side (EventRecorder.events already takes
                    # both; the handler forwards the query string)
                    body = json.dumps(
                        [
                            {
                                "ts": e.timestamp, "kind": e.kind, "key": e.key,
                                "reason": e.reason, "message": e.message,
                            }
                            for e in server.recorder.events(
                                key=query.get("key"),
                                reason=query.get("reason"),
                            )
                        ]
                    ).encode()
                    ctype = "application/json"
                elif path == "/debug/requests":
                    # zpages view of recently tail-sampled REQUEST traces
                    # (?trace_id= narrows; the gateway serves the same
                    # shape with its in-flight table populated)
                    from tfk8s_tpu_torch.gateway.server import debug_requests

                    body = json.dumps(debug_requests(
                        server.tracer,
                        trace_id=query.get("trace_id"),
                        limit=int(query.get("limit", "32")),
                    )).encode()
                    ctype = "application/json"
                elif path == "/debug/decode":
                    # live slot/page occupancy per registered replica
                    from tfk8s_tpu_torch.gateway.server import debug_decode

                    body = json.dumps(debug_decode()).encode()
                    ctype = "application/json"
                elif path == "/traces":
                    # one JSON object per trace, spans in start order;
                    # ?trace_id= narrows to one trace
                    want = query.get("trace_id")
                    body = json.dumps(
                        [
                            {
                                "trace_id": tid,
                                "spans": [s.to_dict() for s in spans],
                            }
                            for tid, spans in server.tracer.traces().items()
                            if want is None or tid == want
                        ]
                    ).encode()
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._http = http.server.ThreadingHTTPServer(("127.0.0.1", port), Handler)
        t = threading.Thread(target=self._http.serve_forever, daemon=True, name="metrics-http")
        t.start()
        self._threads.append(t)
        return self._http.server_address[1]

    def run(self, stop: threading.Event, block: bool = True) -> None:
        """Start kubelet + controller (possibly behind the leader gate).
        With ``block=False`` returns once everything is started."""
        init_logging(self.opts.log_level_int())
        if self.opts.metrics_port:
            port = self.start_metrics_server(self.opts.metrics_port)
            log.info("metrics endpoint on 127.0.0.1:%d", port)
        if self.opts.gateway_port:
            # the serving front door rides the leader-independent plane
            # (like the kubelet): it routes to whatever replicas exist,
            # regardless of which operator process reconciles them
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

        if not self.opts.leader_elect:
            log.info("starting controllers with %d workers", self.opts.workers)
            self.serve_controller.run(self.opts.workers, stop, block=False)
            self.controller.run(self.opts.workers, stop, block=block)
            if block:
                stop.wait()
            return

        elector = LeaderElector(
            self.clientset.generic("Lease", self.opts.namespace),
            identity=self.opts.identity,
            lease_name=self.opts.lease_name,
            namespace=self.opts.namespace,
            lease_duration_s=self.opts.lease_duration_s,
        )

        def lead(child_stop: threading.Event) -> None:
            log.info(
                "acquired lease %s as %s; starting controllers",
                self.opts.lease_name, self.opts.identity,
            )
            self.serve_controller.run(self.opts.workers, child_stop, block=False)
            self.controller.run(self.opts.workers, child_stop, block=False)

        def run_elector():
            elector.run(lead, stop, on_stopped_leading=self.shutdown)

        t = threading.Thread(target=run_elector, daemon=True, name="leader-elector")
        t.start()
        self._threads.append(t)
        self.elector = elector
        if block:
            stop.wait()

    def shutdown(self) -> None:
        if self._http is not None:
            self._http.shutdown()
        if self.gateway is not None:
            self.gateway.shutdown()
        self.controller.controller.shutdown()
        self.serve_controller.controller.shutdown()
