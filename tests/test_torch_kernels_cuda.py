"""The port's CUDA flash-attention kernels against their plain versions,
on the card. Every test here is marked ``cuda`` and skips without one.

This file imports neither JAX nor the JAX package, so it runs on the
machine with the card, from the root of a checkout:

    python -m pytest --noconftest -q -m cuda tests/test_torch_kernels_cuda.py

float32 inputs (TF32 off): outputs agree to atol 1e-5, gradients to 1e-4.
"""

import numpy as np
import pytest
import torch

from tfk8s_tpu_torch.ops import flash_attention as tfa

OUT_ATOL, GRAD_ATOL = 1e-5, 1e-4
RAGGED = 5  # rows past a multiple of 16: the kernels mask the ragged edge


def _key_mask(lengths, lk, left=False):
    m = np.zeros((len(lengths), lk), bool)
    for i, n in enumerate(lengths):
        if left:
            m[i, lk - n:] = True
        else:
            m[i, :n] = True
    return m


# name -> (lq, lk, causal, mask or None), as in test_torch_flash_attention
CASES = {
    "self": (32, 32, False, None),
    "causal": (32, 32, True, None),
    "key_mask": (32, 32, False, _key_mask([32, 20], 32)),
    "causal_left_pad": (32, 32, True, _key_mask([24, 32], 32, left=True)),
    "causal_lq_lt_lk": (16, 32, True, None),
    "cross_key_mask": (16, 32, False, _key_mask([32, 24], 32)),
    "fully_masked_row": (32, 32, False, _key_mask([32, 0], 32)),
    "long_causal": (300, 300, True, None),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(case, d, device, seed=4):
    lq, lk, causal, mask = CASES[case]
    rng = np.random.default_rng(seed)
    b, h = 2, 3
    shapes = [(b, lq + RAGGED, h, d), (b, lk + RAGGED, h, d), (b, lk + RAGGED, h, d),
              (b, lq + RAGGED, h, d)]
    q, k, v, g = (torch.tensor(rng.standard_normal(s).astype(np.float32), device=device)
                  for s in shapes)
    q = q / d ** 0.5
    tm = None
    if mask is not None:
        mask = np.pad(mask, ((0, 0), (0, RAGGED)), constant_values=True)
        if case == "fully_masked_row":
            mask[1] = False
        tm = torch.tensor(mask, device=device)
    return q, k, v, g, tm, causal


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_kernels_match_plain(card, case, d):
    q, k, v, g, tm, causal = _case(case, d, card)
    o_c, lse_c = tfa.flash_fwd_cuda(q, k, v, tm, causal)
    o_p, lse_p = tfa.flash_fwd_plain(q, k, v, tm, causal)
    torch.testing.assert_close(o_c, o_p, atol=OUT_ATOL, rtol=0)
    live = lse_p > -1e29
    torch.testing.assert_close(lse_c > -1e29, live)
    torch.testing.assert_close(lse_c[live], lse_p[live], atol=OUT_ATOL, rtol=0)
    dq_c = tfa.flash_bwd_dq_cuda(q, k, v, g, o_p, lse_p, tm, causal)
    dq_p = tfa.flash_bwd_dq_plain(q, k, v, g, o_p, lse_p, tm, causal)
    torch.testing.assert_close(dq_c, dq_p, atol=GRAD_ATOL, rtol=0)
    for got, want in zip(tfa.flash_bwd_dkv_cuda(q, k, v, g, o_p, lse_p, tm, causal),
                         tfa.flash_bwd_dkv_plain(q, k, v, g, o_p, lse_p, tm, causal)):
        torch.testing.assert_close(got, want, atol=GRAD_ATOL, rtol=0)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["causal", "fully_masked_row", "causal_lq_lt_lk"])
def test_autograd_on_the_card_matches_the_cpu_and_counts_launches(card, case):
    q, k, v, g, tm, causal = _case(case, 64, card, seed=5)
    outs = []
    for dev in (card, torch.device("cpu")):
        ts = [t.detach().to(dev).requires_grad_() for t in (q, k, v)]
        mask = None if tm is None else tm.to(dev)
        tfa.reset_launches()
        out = tfa.flash_attention(*ts, mask=mask, causal=causal)
        out.backward(g.to(dev))
        outs.append([t.detach().cpu() for t in (out, *(x.grad for x in ts))])
        launches = dict(tfa.LAUNCHES)
        assert launches == dict.fromkeys(tfa.KERNELS, 1 if dev.type == "cuda" else 0)
    for got, want in zip(*outs):
        torch.testing.assert_close(got, want, atol=GRAD_ATOL, rtol=0)


@pytest.mark.cuda
def test_bf16_at_a_training_shape(card):
    gen = torch.Generator(device=card).manual_seed(0)
    q, k, v, g = (torch.randn(2, 1024, 12, 64, generator=gen, device=card).to(torch.bfloat16)
                  for _ in range(4))
    q = (q.float() / 8).to(torch.bfloat16)
    o_c, lse_c = tfa.flash_fwd_cuda(q, k, v, None, True)
    o_p, _ = tfa.flash_fwd_plain(q, k, v, None, True)
    # atol 2e-2 plus one bf16 rounding step (2^-7 of the value)
    torch.testing.assert_close(o_c.float(), o_p.float(), atol=2e-2, rtol=2 ** -7)
    dq_c = tfa.flash_bwd_dq_cuda(q, k, v, g, o_c, lse_c, None, True)
    dq_p = tfa.flash_bwd_dq_plain(q, k, v, g, o_c, lse_c, None, True)
    torch.testing.assert_close(dq_c.float(), dq_p.float(), atol=2e-2, rtol=2 ** -7)


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernels_do_not_take(card):
    q = torch.zeros(1, 16, 2, 64, device=card)
    with pytest.raises(TypeError):
        tfa.flash_fwd_cuda(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="head_dim"):
        z = torch.zeros(1, 16, 2, 48, device=card)
        tfa.flash_fwd_cuda(z, z, z)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros(1, 2, 16, 64, device=card).transpose(1, 2)
        tfa.flash_fwd_cuda(t, t, t)
