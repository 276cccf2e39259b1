"""Hugging Face GPT-2 import and export in the port (``gpt.load_hf_gpt2``,
``gpt.save_hf_gpt2``), against a randomly initialized
``transformers.GPT2LMHeadModel`` built from a config (no download), on
the CPU in float32: the imported model's logits within 1e-4 of HF's and
its greedy tokens equal to HF's iterative argmax; the import equal, leaf
for leaf, to the JAX package's import bridged to the port; an export that
HF runs to the same logits and that imports back exactly.
"""

import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (torch's threads under xdist)

transformers = pytest.importorskip("transformers")

from tfk8s_tpu.models import gpt as jgpt  # noqa: E402
from tfk8s_tpu_torch import bridge  # noqa: E402
from tfk8s_tpu_torch.models import gpt as tgpt  # noqa: E402
from tfk8s_tpu_torch.models.transformer import init_params  # noqa: E402

LOGIT_ATOL = 1e-4


def _hf(seed=0, **kw):
    cfg = dict(vocab_size=64, n_positions=32, n_embd=32, n_layer=2, n_head=4,
               resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    cfg.update(kw)
    torch.manual_seed(seed)
    return transformers.GPT2LMHeadModel(transformers.GPT2Config(**cfg)).eval()


@pytest.fixture(scope="module")
def hf():
    """The first GPT2LMHeadModel a process builds imports HF's modeling
    code (seconds); the module's tests share this one."""
    return _hf()


def _ids(b, n, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 64, (b, n)))


def test_import_matches_hf_logits_and_greedy_tokens(hf):
    cfg, model = tgpt.load_hf_gpt2(hf)
    assert cfg.ln_eps == pytest.approx(hf.config.layer_norm_epsilon)
    assert (cfg.mlp_dim, cfg.max_len, cfg.dtype) == (128, 32, torch.float32)
    ids = _ids(2, 12)
    with torch.no_grad():
        want = hf(ids).logits
        got = model(ids)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=LOGIT_ATOL)
    gen = tgpt.greedy_generate(cfg, model, ids[:, :8], 4)
    ref = ids[:, :8]
    with torch.no_grad():
        for _ in range(4):
            ref = torch.cat([ref, hf(ref).logits[:, -1].argmax(-1, keepdim=True)], dim=1)
    assert torch.equal(gen, ref[:, 8:])


def test_import_equals_the_reference_import():
    hf = _hf(seed=1)
    cfg, model = tgpt.load_hf_gpt2(hf)
    _jcfg, params = jgpt.load_hf_gpt2(hf)
    want = bridge.params_to_state_dict(params, cfg)
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        assert torch.equal(got[name], value), name


def test_export_runs_in_hf_and_imports_back_exactly():
    cfg = tgpt.tiny_config(dtype=torch.float32, embed_dim=32, num_heads=4, head_dim=8,
                           mlp_dim=80, max_len=48, ln_eps=1e-5)
    model = init_params(tgpt.GPTLM(cfg), torch.Generator().manual_seed(3)).eval()
    ids = _ids(2, 12, seed=4)
    hf = tgpt.save_hf_gpt2(cfg, model)
    with torch.no_grad():
        np.testing.assert_allclose(hf(ids).logits.numpy(), model(ids).numpy(), atol=LOGIT_ATOL)
    cfg2, back = tgpt.load_hf_gpt2(hf)
    assert (cfg2.mlp_dim, cfg2.ln_eps, cfg2.max_len) == (80, pytest.approx(1e-5), 48)
    theirs = back.state_dict()
    for name, value in model.state_dict().items():
        assert torch.equal(theirs[name], value), name
    # a state_dict exports the same model
    hf2 = tgpt.save_hf_gpt2(cfg, model.state_dict())
    for name, value in hf.state_dict().items():
        assert torch.equal(hf2.state_dict()[name], value), name


@pytest.mark.parametrize("bad", [
    {"activation_function": "gelu"},
    {"scale_attn_by_inverse_layer_idx": True},
    {"reorder_and_upcast_attn": True},
    {"scale_attn_weights": False},
])
def test_import_refuses_a_forward_this_stack_does_not_run(bad):
    with pytest.raises(ValueError):
        tgpt.load_hf_gpt2(_hf(**bad))
