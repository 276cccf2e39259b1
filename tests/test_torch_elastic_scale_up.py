"""The other elastic flow that ``tests/test_elastic_e2e.py`` marks ``slow``,
on the port's operator against the reference's, on the CPU, cut to run in
the tier-1 budget: a 5-step checkpoint cadence, a step threshold just past
the first committed save and a 2 s debounce, the assertions kept.

Capacity back: after a resize down the gang scales up to the spec count,
only after the debounce, resuming monotonically across both resizes. It
runs through both packages at once, as ``tests/test_torch_elastic_e2e.py``
says, with the same records held equal.
"""

import time

import pytest

from _torch_control import contract_env, side_by_side, wait
from _torch_elastic import (CAPACITY, OBS, fast_flush, make_elastic_job, process0,
                            reported_step, workers)
from chaos import ChaosInjector
import _torch_threads  # noqa: F401  (torch's threads under xdist)


@pytest.fixture(autouse=True)
def fast(monkeypatch):
    fast_flush(monkeypatch)


def test_capacity_return_scales_back_up_debounced(tmp_path):
    """After a resize down the controller restores the spec count, only once
    ``resize_debounce_s`` has passed, and the scale-up drains the running
    world first, so the resume is monotone through both resizes."""
    def flow(c):
        ckpt = str(tmp_path / c.name / "ckpt")
        name = "elastic-up"
        OBS.pop((c.name, name), None)
        c.cs.tpujobs().create(make_elastic_job(c.P, name, ckpt, debounce=2.0, ckpt_every=5))
        wait(lambda: c.has(name, "Running"))
        wait(lambda: reported_step(c, f"{name}-worker-0") >= 12)
        chaos = ChaosInjector(c.cs, c.kubelet, seed=3)
        t_down = time.time()
        chaos.reclaim(chaos.pick_worker(name, exclude_index_0=True), grace_s=5.0)
        wait(lambda: c.status(name).world_version == 1)
        # capacity "returns" (cpu slices are virtual): world 2 restores the
        # desired 4 workers after the debounce
        wait(lambda: (c.status(name).world_version, c.status(name).elastic_replicas) == (2, None))
        debounced = time.time() - t_down >= 2.0
        wait(lambda: c.has(name, "Running") and len(workers(c, name)) == 4)
        wait(lambda: any(r["world"] == 2 for r in process0(c, name)))
        w1 = next(r for r in process0(c, name) if r["world"] == 1)
        w2 = next(r for r in process0(c, name) if r["world"] == 2)
        return {
            "debounced": debounced, "record": c.record(name),
            "env": [contract_env(p) for p in workers(c, name)],
            "resizes": [c.counter("tfk8s_elastic_resizes_total", {"direction": d})
                        for d in ("down", "up")],
            "w2": {k: w2[k] for k in ("resuming", "num_processes")},
            "monotone": w2["ckpt_step_at_start"] >= w1["ckpt_step_at_start"] > 0,
            "reasons": c.reasons(name),
        }

    out = side_by_side(flow, CAPACITY)
    assert out["debounced"], "scale-up ignored the debounce"
    assert out["record"]["gang_restarts"] == 0
    assert [(e["TFK8S_WORLD_VERSION"], e["TFK8S_NUM_PROCESSES"]) for e in out["env"]] == [
        ("2", "4")] * 4
    assert out["resizes"] == [1.0, 1.0]
    assert out["w2"] == {"resuming": True, "num_processes": 4} and out["monotone"]
