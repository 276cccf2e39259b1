"""Generation of a tensor-split GPT (and T5) against one process and the
JAX package.

Gangs of real processes over gloo on the CPU (``_torch_gangs``), the tiny
float32 GPT of seed 0's one-process initial parameters, each rank
holding its heads and vocab rows: on ``{"tensor": 2}`` and on ``{"data":
2, "tensor": 2}`` (each data rank decoding its block of the prompt rows)

- ``greedy_generate``, sampled ``generate`` and ``beam_generate`` give one
  process's tokens exactly, and the greedy tokens are the reference's
  unsharded ``greedy_generate``'s on the bridged parameters (the contract
  of the reference's ``tests/test_gpt.py``: a ``data x tensor`` decode
  equals the unsharded one);
- beam scores within 1e-5, and the prefilled cache's leaves, gathered over
  the tensor group, within 1e-5 of one process's;
- T5's ``greedy_generate`` gives one process's tokens;
- the paged path of a tensor-split model still raises, saying why.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfk8s_tpu.models import gpt as jgpt
from tfk8s_tpu_torch import bridge
from tfk8s_tpu_torch.models import gpt as tgpt
from tfk8s_tpu_torch.models import t5 as tt5
from tfk8s_tpu_torch.models.transformer import init_params

import _torch_gangs as tg
import _torch_threads  # noqa: F401  (torch's threads under xdist)

BATCH, PROMPT, TOKENS = 4, 12, 6
SCORE_ATOL = CACHE_ATOL = 1e-5
MESHES = {"tensor": {"tensor": 2}, "data_tensor": {"data": 2, "tensor": 2}}


def _prompt():
    return np.random.default_rng(9).integers(1, 64, (BATCH, PROMPT)).astype(np.int32)


@pytest.fixture(scope="module")
def one_process():
    cfg = tgpt.tiny_config(dtype=torch.float32, max_len=64)
    model = init_params(tgpt.GPTLM(cfg), torch.Generator().manual_seed(0))
    prompt = torch.from_numpy(_prompt())
    beam, scores = tgpt.beam_generate(cfg, model, prompt, TOKENS, num_beams=3, return_all=True)
    _, cache = tgpt.prefill_cache(dataclasses.replace(cfg, decode_cache_len=32), model, prompt)
    t5cfg = tt5.tiny_config(dtype=torch.float32)
    t5model = init_params(tt5.T5(t5cfg), torch.Generator().manual_seed(0))
    return {
        "params": bridge.state_dict_to_params(model.state_dict(), cfg),
        "greedy": tgpt.greedy_generate(cfg, model, prompt, TOKENS),
        "sampled": tgpt.generate(cfg, model, prompt, TOKENS, rng=7, temperature=0.8, top_k=20,
                                 top_p=0.9),
        "beam": beam, "scores": scores, "cache": list(zip(cache.keys, cache.values)),
        "t5_greedy": tt5.greedy_generate(t5cfg, t5model, prompt[:, :16] % 62 + 2, 8),
    }


def _gang_fixture(mesh):
    @pytest.fixture(scope="module")
    def run(tmp_path_factory):
        tmp = str(tmp_path_factory.mktemp(mesh))
        np.save(os.path.join(tmp, "prompt.npy"), _prompt())
        job = dict(kind="generate", batch=BATCH, tokens=TOKENS,
                   prompt=os.path.join(tmp, "prompt.npy"), out=os.path.join(tmp, "gen"))
        n = int(np.prod(list(MESHES[mesh].values())))
        tg.gang(tmp, n, MESHES[mesh], [job])
        return tg.load_parts(job, n)

    return run


tensor_gang = _gang_fixture("tensor")
data_tensor_gang = _gang_fixture("data_tensor")


def _rows(parts, key):
    """Each data rank's rows of ``key``, in row order, from the first
    tensor rank of each data block (the others hold the same)."""
    seen = {}
    for p in parts:
        seen.setdefault(tuple(p["rows"]), p[key])
    return torch.cat([seen[r] for r in sorted(seen)], dim=0)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("key", ["greedy", "sampled", "beam", "t5_greedy"])
def test_tensor_split_tokens_equal_one_process(mesh, key, one_process, request):
    parts = request.getfixturevalue(f"{mesh}_gang")
    for p in parts:
        assert p[key].dtype == one_process[key].dtype
    torch.testing.assert_close(_rows(parts, key), one_process[key], rtol=0, atol=0)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_tensor_split_greedy_equals_the_reference_unsharded(mesh, one_process, request):
    parts = request.getfixturevalue(f"{mesh}_gang")
    jcfg = jgpt.tiny_config(dtype=jnp.float32, max_len=64)
    want = np.asarray(jgpt.greedy_generate(jcfg, one_process["params"], jnp.asarray(_prompt()),
                                           TOKENS))
    np.testing.assert_array_equal(_rows(parts, "greedy").numpy(), want)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_beam_scores_and_cache_leaves_match_one_process(mesh, one_process, request):
    parts = request.getfixturevalue(f"{mesh}_gang")
    torch.testing.assert_close(_rows(parts, "scores"), one_process["scores"], rtol=0,
                               atol=SCORE_ATOL)
    for p in parts:
        rows = torch.tensor(p["rows"])
        for (k, v), (wk, wv) in zip(p["cache"], one_process["cache"]):
            assert k.shape[2] == wk.shape[2] == 4  # both heads' blocks, gathered
            torch.testing.assert_close(k, wk[rows], rtol=0, atol=CACHE_ATOL)
            torch.testing.assert_close(v, wv[rows], rtol=0, atol=CACHE_ATOL)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_paged_decoder_of_a_tensor_split_model_raises(mesh, request):
    for p in request.getfixturevalue(f"{mesh}_gang"):
        assert "paged serving of a tensor-split model is not ported" in p["paged"]
        assert "one device" in p["paged"]
