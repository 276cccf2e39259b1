"""The elastic flows' shared parts, for ``tests/test_torch_elastic_e2e.py``,
``tests/test_torch_elastic_restarts.py`` and
``tests/test_torch_elastic_scale_up.py``: an entry point registered in
both packages' registries that runs the package's MLP through its
``run_task`` and records each incarnation's resume lineage, the elastic
``cpu-1`` job and the clusters' capacity."""

import dataclasses
import importlib
import re

from _torch_control import PACKAGES

OBS = {}  # (plane, job) -> one record per incarnation of each worker
CAPACITY = dict.fromkeys(PACKAGES, {"cpu-1": 2})


def _elastic_train(plane):
    P = PACKAGES[plane]

    def run(env, stop):
        """``tests/test_elastic_e2e.py``'s ``elastic-e2e.train`` in either
        package: each incarnation records what it saw, then trains."""
        mlp = importlib.import_module(f"{P.root}.models.mlp")
        run_task = importlib.import_module(f"{P.root}.runtime.train").run_task
        env = dict(env)
        ctx = P.launcher.ProcessContext.from_env(env)
        ckpt_step = None
        if ctx.checkpoint_dir and ctx.process_id == 0:
            probe = P.checkpoint.Checkpointer(ctx.checkpoint_dir)
            ckpt_step = probe.latest_step() if probe.enabled else None
            probe.close()
        rec = {"pid": ctx.process_id, "world": ctx.world_version,
               "gang_restarts": ctx.gang_restarts, "resuming": ctx.resuming,
               "ckpt_step_at_start": ckpt_step, "num_processes": ctx.num_processes}
        OBS.setdefault((plane, ctx.job_name), []).append(rec)
        if ctx.process_id != 0:
            env.pop("TFK8S_CHECKPOINT_DIR", None)  # process 0 owns the writer
        try:
            run_task(dataclasses.replace(mlp.make_task(), targets={}), env, stop)
        except P.registry.PodDrained as e:
            m = re.search(r"step (\d+)", str(e))
            rec["drain_step"] = int(m.group(1)) if m else None
            raise
    return run


for _name, _P in PACKAGES.items():
    _P.registry.register("telastic.train", _elastic_train(_name))


def fast_flush(monkeypatch):
    """The kubelets' progress flush and the serve autoscaler's period cut,
    as the reference's elastic flows cut them."""
    for P in PACKAGES.values():
        monkeypatch.setattr(P.kubelet, "LOG_FLUSH_SECONDS", 0.05)
        monkeypatch.setattr(P.trainer.serve_controller, "AUTOSCALE_PERIOD_S", 0.1)


def make_elastic_job(P, name, ckpt_dir, workers=4, min_r=2, debounce=300.0, ckpt_every=1000,
                     backoff=3):
    """``tests/test_elastic_e2e.py``'s elastic job in package ``P``."""
    t = P.t
    return t.TPUJob(
        metadata=t.ObjectMeta(name=name, annotations={
            P.trainer.replicas.CHECKPOINT_DIR_ANNOTATION: ckpt_dir}),
        spec=t.TPUJobSpec(
            replica_specs={t.ReplicaType.WORKER: t.ReplicaSpec(
                replicas=workers,
                template=t.ContainerSpec(entrypoint="telastic.train", env={
                    "TFK8S_TRAIN_STEPS": "50000", "TFK8S_CHECKPOINT_EVERY": str(ckpt_every),
                    "TFK8S_LOG_EVERY": "10", "TFK8S_DEVICE": "cpu"}))},
            tpu=t.TPUSpec(accelerator="cpu-1"),
            run_policy=t.RunPolicy(
                backoff_limit=backoff, scheduling=t.SchedulingPolicy(gang=True),
                elastic=t.ElasticPolicy(min_replicas=min_r, max_replicas=workers,
                                        resize_debounce_s=debounce)),
        ),
    )


def reported_step(c, pod_name):
    try:
        return c.cs.pods().get(pod_name).status.training.get("step", 0)
    except c.P.store.NotFound:
        return 0


def workers(c, name):
    return c.live_pods(name, replica_type="Worker")


def process0(c, name):
    return [r for r in OBS.get((c.name, name), []) if r["pid"] == 0]
