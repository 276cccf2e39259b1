"""The port's serve controller against the reference's, on the CPU.

One TPUServe (task ``echo``, the template pinning the port's serve
entrypoint so that both packages hash the same template) goes through
each control plane in turn: a fake cluster, its ``TPUServeController``
and its ``LocalKubelet`` in this process. The records must be equal:

- the rendered pods in wire form (names with the version hash, labels,
  env, resources), ids, times and the random traceparent stripped;
- the serve's status counts and conditions at Ready, after a checkpoint
  rollout (``maxSurge`` 1, ``maxUnavailable`` 0), at scale to zero (not
  ``Available``) and the event reasons through delete;
- the autoscaler's sizes on one fed sequence of queue depths;
- an unpinned serve takes the port's ``DEFAULT_SERVE_ENTRYPOINT``, so its
  hash differs from the reference's on purpose.
"""

import json
import threading

import pytest

import tfk8s_tpu.api as r_api
import tfk8s_tpu.api.serde as r_serde
import tfk8s_tpu.runtime.kubelet as r_kubelet
import tfk8s_tpu.trainer.serve_controller as r_sc
from tfk8s_tpu.client import FakeClientset as RFakeClientset
import tfk8s_tpu_torch.api as t_api
import tfk8s_tpu_torch.api.serde as t_serde
import tfk8s_tpu_torch.runtime.kubelet as t_kubelet
import tfk8s_tpu_torch.trainer.serve_controller as t_sc
from tfk8s_tpu_torch.api.defaults import DEFAULT_SERVE_ENTRYPOINT
from tfk8s_tpu_torch.client import FakeClientset as TFakeClientset
from tfk8s_tpu_torch.trainer import labels as L

from conftest import wait_for
import _torch_threads  # noqa: F401  (torch's threads under xdist)

PORT_SERVE = "tfk8s_tpu_torch.runtime.server:serve"
PLANES = {
    "reference": (r_api, r_serde, r_kubelet, r_sc, RFakeClientset),
    "port": (t_api, t_serde, t_kubelet, t_sc, TFakeClientset),
}


def make_serve(api, name, replicas=2, checkpoint="v1", entrypoint=PORT_SERVE, **spec_kw):
    serve = api.TPUServe(
        metadata=api.ObjectMeta(name=name),
        spec=api.TPUServeSpec(
            task="echo", checkpoint=checkpoint, replicas=replicas,
            batching=api.BatchingPolicy(max_batch_size=8, batch_timeout_ms=5.0,
                                        queue_limit=256),
            rolling_update=api.RollingUpdatePolicy(max_surge=1, max_unavailable=0),
            **spec_kw,
        ),
    )
    serve.spec.template.entrypoint = entrypoint
    serve.spec.template.env["TFK8S_SERVE_ECHO_DELAY_MS"] = "2"
    return serve


def _pod_wire(serde, pod):
    w = serde.to_wire(pod)
    meta = w["metadata"]
    for k in ("uid", "resourceVersion", "creationTimestamp", "deletionTimestamp"):
        meta.pop(k, None)
    for ref in meta.get("ownerReferences", []):
        ref.pop("uid", None)
    for c in w["spec"]["containers"]:
        c["env"].pop("TFK8S_TRACEPARENT", None)
    w.pop("status")
    return json.loads(json.dumps(w, sort_keys=True))


def _status(st):
    return {"replicas": st.replicas, "ready": st.ready_replicas,
            "updated": st.updated_replicas, "observed": st.observed_version,
            "endpoint": st.endpoint,
            "conditions": [(c.type.value, c.status, c.reason, c.message)
                           for c in st.conditions]}


def drive(plane, monkeypatch):
    """Submit, roll, scale to zero and delete one serve on ``plane``; the
    record of what the control plane showed at each point."""
    api, serde, kubelet_mod, sc_mod, fake = PLANES[plane]
    monkeypatch.setattr(kubelet_mod, "LOG_FLUSH_SECONDS", 0.05)
    monkeypatch.setattr(sc_mod, "AUTOSCALE_PERIOD_S", 0.1)
    cs = fake()
    ctrl = sc_mod.TPUServeController(cs)
    kubelet = kubelet_mod.LocalKubelet(cs)
    stop = threading.Event()
    kubelet.run(stop)
    assert ctrl.run(workers=2, stop=stop, block=False)
    name, rec = "echo-sc", {}

    def status():
        return cs.tpuserves().get(name).status

    def live_pods():
        pods, _ = cs.pods().list(label_selector=L.serve_selector(name))
        return sorted((p for p in pods if p.metadata.deletion_timestamp is None),
                      key=lambda p: p.metadata.name)

    def settled(ready, version=None):
        st = status()
        return (st.ready_replicas == ready and st.updated_replicas == ready
                and st.replicas == ready and len(live_pods()) == ready
                and (version is None or st.observed_version not in ("", version))
                and all(c.type.value != "Progressing" or not c.status
                        for c in st.conditions))

    try:
        cs.tpuserves().create(make_serve(api, name))
        assert wait_for(lambda: settled(2), timeout=30)
        rec["ready"] = _status(status())
        rec["ready_pods"] = [_pod_wire(serde, p) for p in live_pods()]
        v1 = status().observed_version

        cs.tpuserves().patch(name, {"spec": {"checkpoint": "v2"}})
        assert wait_for(lambda: settled(2, v1), timeout=30)
        rec["rolled"] = _status(status())
        rec["rolled_pods"] = [_pod_wire(serde, p) for p in live_pods()]

        cs.tpuserves().patch(name, {"spec": {"replicas": 0}})
        assert wait_for(lambda: settled(0), timeout=30)
        rec["zero"] = _status(status())

        cs.tpuserves().delete(name)

        def gone():
            try:
                cs.tpuserves().get(name)
            except Exception as e:  # noqa: BLE001 — either package's NotFound
                return type(e).__name__ == "NotFound"
            return False

        assert wait_for(gone, timeout=30)
        assert wait_for(lambda: not live_pods(), timeout=30)
        rec["reasons"] = sorted({e.reason for e in ctrl.recorder.events(key=f"default/{name}")})
    finally:
        stop.set()
        ctrl.controller.shutdown()
    return rec


def test_one_serve_through_both_controllers(monkeypatch):
    ref = drive("reference", monkeypatch)
    port = drive("port", monkeypatch)
    assert port == ref
    # the reference's own expectations, so equal records are right ones
    assert ref["ready"]["conditions"][:2] == [
        ("Available", True, "AllReplicasReady", "2/2 ready"),
        ("Progressing", False, "Complete", f"version {ref['ready']['observed']}")]
    assert ref["rolled"]["observed"] != ref["ready"]["observed"]
    assert {p["metadata"]["labels"][L.SERVE_VERSION] for p in ref["rolled_pods"]} == {
        ref["rolled"]["observed"]}
    assert ref["zero"]["conditions"][0][:3] == ("Available", False, "ScaledToZero")
    assert {"RolloutStarted", "RolloutComplete", "ReplicaDrained", "ServeDeleted"} <= set(
        ref["reasons"])
    pod = ref["ready_pods"][0]
    assert pod["metadata"]["name"] == f"echo-sc-srv-{ref['ready']['observed']}-0"
    assert pod["spec"]["containers"][0]["entrypoint"] == PORT_SERVE
    assert pod["spec"]["containers"][0]["env"]["TFK8S_SERVE_CHECKPOINT"] == "v1"


@pytest.mark.parametrize("phase_pools", [False, True], ids=["single", "disaggregated"])
def test_rendered_pods_equal(phase_pools):
    """``render_serve_pod`` over every pool of one spec, with the KV tier
    and scheduler knobs, in wire form."""
    out = []
    for plane in ("reference", "port"):
        api, serde, _k, sc_mod, _f = PLANES[plane]
        serve = make_serve(api, "render-s", kv_tier=api.KVTierPolicy(host_bytes=1 << 20))
        serve.spec.task = "gpt"
        if phase_pools:
            serve.spec.disaggregation = api.DisaggregationPolicy(prefill_replicas=1,
                                                                 decode_replicas=2)
        serve.spec.template.resources = {"nvidia.com/gpu": "1"}
        serve.metadata.uid = "u-1"
        serve = api.set_serve_defaults(serve)
        assert api.validate_serve(serve) == []
        version = sc_mod._serve_version(serve)
        pods = [sc_mod.render_serve_pod(serve, version, i, phase=phase)
                for phase, count in sc_mod.serve_pools(serve) for i in range(count)]
        out.append((version, sc_mod.serve_pools(serve), [_pod_wire(serde, p) for p in pods]))
    assert out[1] == out[0]
    assert out[0][2][0]["spec"]["containers"][0]["resources"] == {"nvidia.com/gpu": "1"}


def test_autoscaler_sizes_equal():
    """One fed sequence of queue depths through each controller's
    ``_autoscale`` (cooldown 0): the same spec.replicas after each feed,
    the fractional target's ceil(20 / 2.5) = 8 among them."""
    sizes = []
    for plane in ("reference", "port"):
        api, _serde, _k, sc_mod, fake = PLANES[plane]
        cs = fake()
        ctrl = sc_mod.TPUServeController(cs)
        cs.tpuserves().create(make_serve(api, "frac-s", autoscale=api.AutoscalePolicy(
            enabled=True, min_replicas=1, max_replicas=50, target_queue_depth=2.5,
            cooldown_s=0.0)))
        seen = []
        for depth in (10.0, 10.0, 0.2, 0.0, 0.0, 3.0, 40.0, 1.0):
            serve = cs.tpuserves().get("frac-s")
            pods = []
            for i in range(serve.spec.replicas):
                p = api.Pod(metadata=api.ObjectMeta(name=f"frac-{i}"))
                p.status.training = {"serving_queue_depth": depth, "serving_qps": 4.0}
                pods.append(p)
            ctrl._autoscale(serve, pods)
            cur = cs.tpuserves().get("frac-s")
            seen.append((cur.spec.replicas, serve.status.queue_depth, serve.status.qps))
        sizes.append(seen)
    assert sizes[1] == sizes[0]
    assert sizes[0][0][0] == 8


def test_unpinned_entrypoint_is_the_ports_own():
    """Defaults fill the port's serve entrypoint, so an unpinned serve's
    template (and so its version hash) differs from the reference's; a
    pinned one hashes alike."""
    versions = {}
    for plane in ("reference", "port"):
        api, _serde, _k, sc_mod, _f = PLANES[plane]
        unpinned = api.set_serve_defaults(make_serve(api, "s", entrypoint=""))
        pinned = api.set_serve_defaults(make_serve(api, "s"))
        versions[plane] = (unpinned.spec.template.entrypoint, sc_mod._serve_version(unpinned),
                           sc_mod._serve_version(pinned))
    assert versions["port"][0] == DEFAULT_SERVE_ENTRYPOINT == PORT_SERVE
    assert versions["reference"][0] == "tfk8s_tpu.runtime.server:serve"
    assert versions["port"][1] != versions["reference"][1]
    assert versions["port"][2] == versions["reference"][2]
