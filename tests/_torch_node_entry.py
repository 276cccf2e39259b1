"""The entry point the node-loss flow runs (``tests/test_torch_node_failure.py``).

No JAX here: a pod's rank processes import this module to resolve the
entry point they were started on. It is the port's MLP without its
accuracy target (the flow runs a few steps), through ``run_task``,
wrapped as a family's entry point is (``pod_ranks.entrypoint``), so a pod
whose mesh is larger than its processes runs its ranks on it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, Optional

from torch.optim.optimizer import register_optimizer_step_post_hook

from tfk8s_tpu_torch.models import mlp
from tfk8s_tpu_torch.runtime import pod_ranks
from tfk8s_tpu_torch.runtime.checkpoint import Checkpointer
from tfk8s_tpu_torch.runtime.train import join_mesh, run_task

# the update after which each rank of the pod's first run waits for its stop
HOLD_AT_ENV = "NODE_HOLD_AT"
# where the ranks write held-<rank>.json and rank 0 run-<gang restarts>.json
RECORD_DIR_ENV = "NODE_RECORD_DIR"


def _write(path: str, record: Dict[str, Any]) -> None:
    with open(path + ".tmp", "w") as f:
        json.dump(record, f)
    os.replace(path + ".tmp", path)


@pod_ranks.entrypoint
def mlp_held(env: Dict[str, str], stop: Optional[Any] = None):
    """The MLP's history. In the job's first run (``TFK8S_GANG_RESTARTS``
    0) every rank, after its ``NODE_HOLD_AT``-th update, writes
    ``held-<rank>.json`` (its pid) and waits for its stop; rank 0 of every
    run that ends writes ``run-<gang restarts>.json``: the committed step
    it found at its start and the steps it logged."""
    env = dict(env)
    ctx, device, mesh = join_mesh(env)
    records, run = env[RECORD_DIR_ENV], env.get("TFK8S_GANG_RESTARTS", "0")
    found = Checkpointer(ctx.checkpoint_dir).latest_step()
    updates = [0]

    def hook(opt, args, kwargs):
        # torch's state-dict loader steps a resumed optimizer once at lr 0
        if all(float(g.get("lr", 1.0)) == 0.0 for g in opt.param_groups):
            return
        updates[0] += 1
        if run == "0" and updates[0] == int(env[HOLD_AT_ENV]):
            _write(os.path.join(records, f"held-{ctx.process_id}.json"),
                   {"pid": os.getpid(), "at": time.time()})
            stop.wait(60)

    handle = register_optimizer_step_post_hook(hook)
    try:
        task = dataclasses.replace(mlp.make_task(mesh=mesh), targets={})
        history = run_task(task, env, stop, device=device, mesh=mesh)
    finally:
        handle.remove()
    if ctx.process_id == 0:
        _write(os.path.join(records, f"run-{run}.json"),
               {"found": found, "steps": [h["step"] for h in history]})
    return history
