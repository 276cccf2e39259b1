"""The masked token losses over the batch axes: the global masked mean.

BERT's MLM loss and T5's seq2seq loss are the mean over the masked (not
padded) positions of the GLOBAL batch, as the reference takes them under
GSPMD. Gangs of real processes over gloo on the CPU (``_torch_gangs``)
train both families, tiny float32, three steps, on per_host input whose
batch blocks hold different counts of masked positions (BERT's 15%
draws; T5's targets padded at random lengths), on ``{"data": 2}``
(DDP), ``{"fsdp": 2}`` (FSDP2) and ``{"data": 2, "fsdp": 2}`` (HSDP):

- loss, accuracy and gradient norm per step equal one process's at rtol
  1e-5;
- the same gangs with the blocks' own means averaged over the blocks
  (the formula before the repair) miss one process by more than that.
"""

import numpy as np
import pytest
import torch

import _torch_gangs as tg
from test_torch_tensor_parallel import _history
import _torch_threads  # noqa: F401  (torch's threads under xdist)

MESHES = {"data": {"data": 2}, "fsdp": {"fsdp": 2}, "hsdp": {"data": 2, "fsdp": 2}}
FAMILIES = ("bert", "t5")


def _gang_fixture(mesh):
    @pytest.fixture(scope="module")
    def run(tmp_path_factory):
        runs = [tg.train_run(f) for f in FAMILIES]
        runs += [tg.train_run(f, tag=f"{f}_old", old_formula=True) for f in FAMILIES]
        n = int(np.prod(list(MESHES[mesh].values())))
        return tg.gang(str(tmp_path_factory.mktemp(mesh)), n, MESHES[mesh], runs)

    return run


data_gang = _gang_fixture("data")
fsdp_gang = _gang_fixture("fsdp")
hsdp_gang = _gang_fixture("hsdp")


@pytest.fixture(scope="module")
def one_process():
    return {f: np.array(tg.one_process(f)) for f in FAMILIES}


@pytest.mark.parametrize("family", FAMILIES)
def test_batch_blocks_hold_different_masked_counts(family):
    """The input these gangs see: each step's four shards (a
    ``{"data": 2, "fsdp": 2}`` rank's block each) hold different counts of
    masked positions, so a mean of the blocks' means is not the global
    mean."""
    task = tg.task_of(tg.RUNS[family], torch.device("cpu"))
    for step in range(tg.STEPS):
        counts = []
        for shard in range(tg.SHARDS):
            batch = task.make_batch(np.random.default_rng(
                np.random.SeedSequence([0, step, shard])), task.batch_size // tg.SHARDS)
            counts.append(int(batch["mlm_mask"].sum() if family == "bert"
                              else (batch["tgt_out"] != 0).sum()))
        assert len(set(counts)) > 1, counts


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_masked_mean_gang_equals_one_process(mesh, family, one_process, request):
    outs = request.getfixturevalue(f"{mesh}_gang")
    for out in outs:
        got = _history(out, family)
        assert len(got) == tg.STEPS
        np.testing.assert_allclose(got, one_process[family], rtol=tg.RTOL)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_the_blocks_mean_of_means_misses_the_global_mean(mesh, family, one_process, request):
    outs = request.getfixturevalue(f"{mesh}_gang")
    want = one_process[family]
    for out in outs:
        got = np.array(_history(out, f"{family}_old"))
        assert got.shape == want.shape
        rel = np.abs(got - want) / np.abs(want).clip(1e-12)
        assert rel[0, 0] > 10 * tg.RTOL, rel  # the first loss already
        assert rel.max() > 10 * tg.RTOL
