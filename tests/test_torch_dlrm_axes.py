"""DLRM's tensor-split tables beside ``fsdp``, ``expert`` and ``sequence``,
against one process.

One gang of four real processes over gloo on the CPU (``_torch_gangs``),
run once per module, taking each layout in turn: the tiny DLRM (tables
of 101, 64 and 37 rows, split unevenly over tensor; embed 16, batch 32)
three steps through ``run_task`` on per_host input of four shards,
against one process on the same global batch:

- ``{"fsdp": 2, "tensor": 2}``: each table's and hidden width's tensor
  block split again on dim 0 over fsdp (``data_parallel.FsdpShards``), the
  rows of the batch over fsdp;
- ``{"expert": 2, "tensor": 2}`` and ``{"sequence": 2, "tensor": 2}``: the
  model replicated over expert and sequence, as the reference's specs
  leave it (a sequence rank holds its rows whole and carries half of
  their gradient into the reduction's sum over the sequence group).

In float32 (``dlrm.DTYPE`` patched) the loss, gradient norm and click
accuracy a step hold rtol 1e-5; in DLRM's own bfloat16 they hold the bf16
bounds (loss atol 2e-2, gradient norm rtol 5e-2), and the first update's
gradient of every table, gathered whole, holds 5e-2 relative L2 against
one process's.
"""

import os

import numpy as np
import pytest
import torch

import _torch_gangs as tg
from test_torch_tensor_parallel import BF16_GRAD_RTOL, BF16_LOSS_ATOL, _history

LAYOUTS = {"fsdp_tensor": {"fsdp": 2, "tensor": 2},
           "expert_tensor": {"expert": 2, "tensor": 2},
           "sequence_tensor": {"sequence": 2, "tensor": 2}}
TABLE_REL_L2 = 5e-2  # the bf16 bound on a gradient, relative L2


def _rel_l2(got, want):
    return float((got.double() - want.double()).norm() / want.double().norm())


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("one"))
    hist = {n: np.array(tg.one_process(n, grads=os.path.join(tmp, n)))
            for n in ("dlrm", "dlrm_bf16")}
    return hist, torch.load(os.path.join(tmp, "dlrm_bf16-0.pt"))


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dlrm"))
    runs = [tg.train_run(name, tag=f"{layout}/{name}", mesh=axes,
                         **({"grads": os.path.join(tmp, layout)} if name == "dlrm_bf16" else {}))
            for layout, axes in LAYOUTS.items() for name in ("dlrm", "dlrm_bf16")]
    return tg.gang(tmp, 4, LAYOUTS["fsdp_tensor"], runs), tmp


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_dlrm_gang_equals_one_process(layout, gang, one_process):
    """Float32: loss, gradient norm and click accuracy per step equal one
    process's on every rank."""
    outs, _ = gang
    want = one_process[0]["dlrm"]
    for out in outs:
        got = _history(out, f"{layout}/dlrm")
        assert len(got) == tg.STEPS
        np.testing.assert_allclose(got, want, rtol=tg.RTOL)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_dlrm_bf16_gang_is_within_the_bf16_bounds(layout, gang, one_process):
    """DLRM's own bfloat16: loss and gradient norm per step within the bf16
    bounds on every rank, and every table's first-update gradient (its
    blocks gathered whole) within 5e-2 relative L2 of one process's."""
    outs, tmp = gang
    hist, want_grads = one_process
    want = hist["dlrm_bf16"]
    for out in outs:
        got = np.array(_history(out, f"{layout}/dlrm_bf16"))
        assert got.shape == want.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got[:, 0], want[:, 0], atol=BF16_LOSS_ATOL)
        np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=BF16_GRAD_RTOL)
    for rank in range(4):
        grads = torch.load(os.path.join(tmp, f"{layout}-{rank}.pt"))
        assert set(grads) == set(want_grads)
        for t in range(3):
            name = f"table{t}.weight"
            assert grads[name].shape == want_grads[name].shape
            assert _rel_l2(grads[name], want_grads[name]) < TABLE_REL_L2, name
