"""One of the two elastic flows that ``tests/test_elastic_e2e.py`` marks
``slow``, on the port's operator against the reference's, on the CPU, cut
to run in the tier-1 budget: a 5-step checkpoint cadence and a step
threshold just past the first committed save, the assertions kept.

A dropped notice (``LocalKubelet.chaos_fail``, the host dying cold): the
whole-gang restart from checkpoint, one unit of backoff burned, no resize.
The other ``slow`` flow, capacity coming back, is
``tests/test_torch_elastic_scale_up.py`` (a file each keeps each under the
tier-1 budget's 40 s a file).

It runs through both packages at once, as ``tests/test_torch_elastic_e2e.py``
says, with the same records held equal. The reference's seeded chaos sweep
has no counterpart here.
"""

import pytest

from _torch_control import contract_env, side_by_side, wait
from _torch_elastic import (CAPACITY, OBS, fast_flush, make_elastic_job, process0,
                            reported_step, workers)
from chaos import ChaosInjector
import _torch_threads  # noqa: F401  (torch's threads under xdist)


@pytest.fixture(autouse=True)
def fast(monkeypatch):
    fast_flush(monkeypatch)


def test_dropped_notice_converges_via_legacy_restart(tmp_path):
    """A host dying with NO notice (``chaos_fail``) is the legacy failure
    model: a whole-gang restart from checkpoint, one unit of backoff."""
    def flow(c):
        ckpt = str(tmp_path / c.name / "ckpt")
        name = "elastic-drop"
        OBS.pop((c.name, name), None)
        c.cs.tpujobs().create(make_elastic_job(c.P, name, ckpt, ckpt_every=5))
        wait(lambda: c.has(name, "Running"))
        # past step 11 the step-5 save is durably COMMITTED (its marker is
        # written when the step-10 save starts)
        wait(lambda: reported_step(c, f"{name}-worker-0") >= 12)
        chaos = ChaosInjector(c.cs, c.kubelet, seed=11)
        victim = chaos.pick_worker(name, exclude_index_0=True)
        chaos.kill(victim)
        wait(lambda: c.status(name).gang_restarts == 1)

        def recovered():
            pods = workers(c, name)
            return c.has(name, "Running") and len(pods) == 4 and all(
                p.spec.containers[0].env.get("TFK8S_GANG_RESTARTS") == "1" for p in pods)

        wait(recovered)
        out = {"victim": victim.metadata.name, "record": c.record(name),
               "env": [contract_env(p) for p in workers(c, name)]}

        def resumed():
            return any(r["gang_restarts"] == 1 and r["resuming"]
                       and (r["ckpt_step_at_start"] or 0) > 0 for r in process0(c, name))

        wait(resumed)
        out["reasons"] = c.reasons(name)
        return out

    out = side_by_side(flow, CAPACITY)
    rec = out["record"]
    assert rec["gang_restarts"] == 1
    assert (rec["world_version"], rec["elastic_replicas"]) == (0, None), "no resize happened"
    assert [e["TFK8S_GANG_RESTARTS"] for e in out["env"]] == ["1"] * 4
    assert "GangRestart" in out["reasons"] and "ElasticResize" not in out["reasons"]
