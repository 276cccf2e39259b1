"""The port's ``fsdp`` axis beside ``expert`` and ``sequence``, against one
process.

Gangs of real processes over gloo on the CPU (``_torch_gangs``), each run
once per module, tiny float32 configs, three steps through each family's
training path, against one process on the same global batch at rtol 1e-5
(loss, gradient norm and accuracy a step). ``data_parallel.FsdpShards``
splits every parameter the rank holds (an expert shard's rows too) on
dim 0 over the fsdp axis, and the batch is split over fsdp:

- ``{"fsdp": 2, "expert": 2}``: the MoE GPT, BERT and T5 (the load-balance
  statistics over the fsdp ranks' rows); the MoE GPT's checkpoint holds
  whole tensors and resumes in one process;
- ``{"fsdp": 2, "sequence": 2}``: GPT, BERT, T5 (padded targets: the
  masked mean over the batch and sequence blocks together) and ViT
  through the policy (Ulysses), GPT pinned to the ring.
"""

import os

import numpy as np
import pytest
import torch

import _torch_gangs as tg
from test_torch_tensor_parallel import _history, _resumable
import _torch_threads  # noqa: F401  (torch's threads under xdist)

FSDP_EXPERT = ("gpt_moe", "bert_moe", "t5_moe")
FSDP_SEQUENCE = ("gpt", "bert63", "t5", "vit", "gpt_ring")


@pytest.fixture(scope="module")
def one_process():
    names = sorted(set(FSDP_EXPERT + FSDP_SEQUENCE))
    return {n: np.array(tg.one_process(n, tg.STEPS + 2 * (n == "gpt_moe"))) for n in names}


@pytest.fixture(scope="module")
def fsdp_expert_gang(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("fe"))
    ckpt = {"TFK8S_CHECKPOINT_DIR": os.path.join(tmp, "ckpt"),
            "TFK8S_CHECKPOINT_EVERY": str(tg.STEPS)}
    runs = [tg.train_run(n, env=ckpt if n == "gpt_moe" else {}) for n in FSDP_EXPERT]
    return tg.gang(tmp, 4, {"fsdp": 2, "expert": 2}, runs), tmp


@pytest.fixture(scope="module")
def fsdp_sequence_gang(tmp_path_factory):
    return tg.gang(str(tmp_path_factory.mktemp("fs")), 4, {"fsdp": 2, "sequence": 2},
                   [tg.train_run(n) for n in FSDP_SEQUENCE])


def _assert_gang(outs, name, want):
    for out in outs:
        got = _history(out, name)
        assert len(got) == tg.STEPS
        np.testing.assert_allclose(got, want[name][:tg.STEPS], rtol=tg.RTOL)


@pytest.mark.parametrize("name", FSDP_EXPERT)
def test_fsdp_expert_gang_equals_one_process(name, fsdp_expert_gang, one_process):
    _assert_gang(fsdp_expert_gang[0], name, one_process)


@pytest.mark.parametrize("name", FSDP_SEQUENCE)
def test_fsdp_sequence_gang_equals_one_process(name, fsdp_sequence_gang, one_process):
    _assert_gang(fsdp_sequence_gang, name, one_process)


def test_fsdp_expert_checkpoint_resumes_in_one_process(fsdp_expert_gang, one_process,
                                                        tmp_path):
    """The fsdp rows of the expert shards, gathered: whole tensors, and a
    resume in one process continues the uninterrupted run."""
    _, src = fsdp_expert_gang
    saved = torch.load(os.path.join(src, "ckpt", str(tg.STEPS), "state.pt"))
    assert saved["model"]["layers.1.moe.wi"].shape == (4, 32, 64)
    assert saved["optimizer"]["state"]["embed.tok.weight"]["exp_avg"].shape == (64, 32)
    ckpt = _resumable(os.path.join(src, "ckpt"), str(tmp_path / "one"), tg.STEPS)
    np.testing.assert_allclose(tg.one_process("gpt_moe", tg.STEPS + 2, ckpt=ckpt, resume=True),
                               one_process["gpt_moe"][tg.STEPS:], rtol=tg.RTOL)
