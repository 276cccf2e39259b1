"""The port's operator over the wire, on the CPU.

(i) The port's ``Server(Options(kubeconfig=...))`` against the port's
    ``APIServer`` on a thread of this process: the MLP job of
    ``tests/test_torch_operator_e2e.py``'s flows runs over HTTP; its
    condition types, event reasons and rendered pods equal those of the
    same manifest run through an in-process ``Server``, and the history its
    entry point returns equals a direct call on the same env.
(ii) Three processes, each ``python -m tfk8s_tpu_torch.cmd.main`` with JAX
    and the reference package unimportable (``tests/test_torch_imports.py``'s
    finder): ``apiserver`` with a journal, ``operator --no-local-kubelet``
    and ``kubelet``. An MLP TPUJob on ``cpu-1`` with ``backoffLimit: 0`` is
    submitted over the wire with the port's ``submit`` verb (``cmd.main.main``
    in this process); the apiserver is killed with SIGKILL while the
    pod runs and restarted on the same port from its journal; the job ends
    ``Succeeded`` with no restart.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest
import torch

from tfk8s_tpu_torch import api as tapi
from tfk8s_tpu_torch.api import helpers
from tfk8s_tpu_torch.api import serde as tserde
from tfk8s_tpu_torch.client.apiserver import APIServer
from tfk8s_tpu_torch.client.remote import clientset_from_kubeconfig
from tfk8s_tpu_torch.client.store import ClusterStore
from tfk8s_tpu_torch.cmd.main import main as tmain
from tfk8s_tpu_torch.cmd.options import Options
from tfk8s_tpu_torch.cmd.server import Server
from tfk8s_tpu_torch.models import mlp
from tfk8s_tpu_torch.runtime import registry
from tfk8s_tpu_torch.trainer import labels as L

from conftest import wait_for
from test_torch_imports import _BLOCK
from test_torch_operator_e2e import _stripped_pod
import _torch_threads  # noqa: F401  (torch's threads under xdist)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MLP_ENV = {"TFK8S_DEVICE": "cpu", "TFK8S_LOG_EVERY": "100"}
RUNS = {}  # backend -> (the env the entry point got, its history)


def _mlp(backend):
    def run(env, stop):
        RUNS[backend] = (dict(env), mlp.train(env, stop))
    return run


for _backend in ("store", "wire"):
    registry.register(f"test.remote.mlp.{_backend}", _mlp(_backend))


def make_job(name, entrypoint, env=None, backoff_limit=None):
    return tapi.TPUJob(
        metadata=tapi.ObjectMeta(name=name),
        spec=tapi.TPUJobSpec(
            replica_specs={tapi.ReplicaType.WORKER: tapi.ReplicaSpec(
                replicas=1, template=tapi.ContainerSpec(entrypoint=entrypoint, env=dict(env or {})))},
            tpu=tapi.TPUSpec(accelerator="cpu-1"),
            run_policy=tapi.RunPolicy(backoff_limit=backoff_limit,
                                      scheduling=tapi.SchedulingPolicy(gang=True)),
        ),
    )


def _has(status, cond):
    return helpers.has_condition(status, getattr(tapi.JobConditionType, cond.upper()))


@pytest.fixture
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _run_through(server, backend):
    """Run the MLP job through ``server``; return (condition types, event
    reasons, stripped pods)."""
    stop = threading.Event()
    server.run(stop, block=False)
    cs = server.clientset
    try:
        cs.tpujobs().create(make_job("mlp", f"test.remote.mlp.{backend}", MLP_ENV))
        assert wait_for(lambda: _has(cs.tpujobs().get("mlp").status, "Succeeded")
                        or _has(cs.tpujobs().get("mlp").status, "Failed"), timeout=60)

        def reasons():
            return list(dict.fromkeys(e.reason for e in server.recorder.events(key="default/mlp")))

        assert wait_for(lambda: "JobSucceeded" in reasons(), timeout=10)
        pods, _ = cs.pods().list(label_selector={L.JOB_NAME: "mlp"})
        return ([c.type.value for c in cs.tpujobs().get("mlp").status.conditions], reasons(),
                [_stripped_pod(tserde, p) for p in pods])
    finally:
        stop.set()
        server.shutdown()


def test_the_mlp_job_runs_alike_over_the_wire(tmp_path, two_threads):
    in_process = _run_through(Server(Options(workers=2)), "store")
    api = APIServer(ClusterStore(), port=0)
    api.serve_background()
    try:
        kc = tmp_path / "kc.json"
        kc.write_text(json.dumps({"server": api.url}))
        server = Server(Options(kubeconfig=str(kc), workers=2))
        assert type(server.store).__name__ == "RemoteStore"
        over_wire = _run_through(server, "wire")
        # the operator's writes went to the apiserver's store
        assert api.store.get("TPUJob", "default", "mlp").status.conditions
    finally:
        api.shutdown()
        api.server_close()
    assert over_wire[0] == in_process[0] and over_wire[0][-1] == "Succeeded"
    assert over_wire[1] == in_process[1] and "JobSucceeded" in over_wire[1]
    assert len(over_wire[2]) == 1
    # the pods differ in their entry point's registry name alone
    for pod in in_process[2]:
        c = pod["spec"]["containers"][0]
        c["entrypoint"] = c["entrypoint"].replace(".store", ".wire")
    assert over_wire[2] == in_process[2]
    assert over_wire[2][0]["status"]["phase"] == "Succeeded"

    env, history = RUNS["wire"]
    assert _untimed(RUNS["store"][1]) == _untimed(history)
    assert history[-1]["step"] == 300
    assert _untimed(mlp.train(env)) == _untimed(history)


def _untimed(history):
    return [{k: v for k, v in h.items() if k != "steps_per_s"} for h in history]


# -- three processes, and a kill -9 of the apiserver --------------------------------

_MAIN = _BLOCK + (
    "import runpy\n"
    "sys.argv = ['tfk8s_tpu_torch.cmd.main'] + sys.argv[1:]\n"
    "runpy.run_module('tfk8s_tpu_torch.cmd.main', run_name='__main__')\n")


def _start(args, log):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    return subprocess.Popen([sys.executable, "-c", _MAIN] + args, cwd=REPO, env=env,
                            stdout=log, stderr=subprocess.STDOUT)


def test_a_job_survives_a_kill_9_of_the_apiserver_across_three_processes(tmp_path):
    deadline = time.monotonic() + 35
    journal, kc = str(tmp_path / "journal"), str(tmp_path / "kc.json")
    logs = {n: open(tmp_path / f"{n}.log", "wb") for n in ("api1", "api2", "op", "kl")}
    procs = {}

    def tails():
        return "\n".join(f"--- {n}\n" + (tmp_path / f"{n}.log").read_text()[-1500:]
                         for n in logs)

    try:
        procs["api1"] = _start(["apiserver", "--port", "0", "--journal-dir", journal,
                                "--no-fsync", "--write-kubeconfig", kc], logs["api1"])
        assert wait_for(lambda: os.path.exists(kc) and os.path.getsize(kc) > 0,
                        timeout=deadline - time.monotonic()), tails()
        with open(kc) as f:
            port = int(json.load(f)["server"].rsplit(":", 1)[1])
        procs["op"] = _start(["operator", "--kubeconfig", kc, "--no-local-kubelet",
                              "--workers", "2"], logs["op"])
        procs["kl"] = _start(["kubelet", "--kubeconfig", kc, "--name", "node-0"], logs["kl"])
        cs = clientset_from_kubeconfig(kc)
        manifest = tmp_path / "mnist.json"
        manifest.write_text(json.dumps(tserde.to_wire(make_job(
            "mnist", "tfk8s_tpu_torch.models.mlp:train", MLP_ENV, backoff_limit=0))))
        assert tmain(["submit", "--kubeconfig", kc, "--file", str(manifest)]) == 0

        def pod_phase():
            pods, _ = cs.pods().list(label_selector={L.JOB_NAME: "mnist"})
            return pods[0].status.phase.value if pods else None

        assert wait_for(lambda: pod_phase() == "Running",
                        timeout=deadline - time.monotonic()), tails()
        rv = cs.tpujobs().get("mnist").metadata.resource_version
        procs["api1"].send_signal(signal.SIGKILL)
        procs["api1"].wait(5)
        procs["api2"] = _start(["apiserver", "--port", str(port), "--journal-dir", journal,
                                "--no-fsync"], logs["api2"])

        def status():
            try:
                return cs.tpujobs().get("mnist").status
            except Exception:  # noqa: BLE001 — the apiserver is restarting
                return None

        assert wait_for(lambda: status() is not None and (
            _has(status(), "Succeeded") or _has(status(), "Failed")),
            timeout=max(1.0, deadline - time.monotonic())), tails()
        job = cs.tpujobs().get("mnist")
        assert _has(job.status, "Succeeded"), (job.status, tails())
        assert job.status.gang_restarts == 0
        assert job.metadata.resource_version > rv
        (pod,) = cs.pods().list(label_selector={L.JOB_NAME: "mnist"})[0]
        assert (pod.status.phase.value, pod.status.host) == ("Succeeded", "node-0")
        assert pod.status.training["step"] == 300
        assert all(p.poll() is None for n, p in procs.items() if n != "api1"), tails()
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
            p.wait(10)
        for f in logs.values():
            f.close()
