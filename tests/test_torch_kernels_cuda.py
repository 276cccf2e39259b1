"""The port's CUDA kernels (flash attention, GroupNorm forward and
backward, the block copy) against their plain versions, on the card.
Every test here is marked ``cuda`` and skips without one.

This file imports neither JAX nor the JAX package, so it runs on the
machine with the card, from the root of a checkout:

    python -m pytest --noconftest -q -m cuda tests/test_torch_kernels_cuda.py

float32 inputs (TF32 off): outputs agree to atol 1e-5, gradients to 1e-4.
GroupNorm in bfloat16: outputs and dx within one bfloat16 rounding step
of the plain version's (atol 2e-2 plus rtol 2^-7), the float32 dscale and
dbias to atol 1e-2 + rtol 1e-3 (sums over up to 12.8 M values in another
order). The copy is bit-exact.
"""

import numpy as np
import pytest
import torch

from tfk8s_tpu_torch.ops import block_copy as tbc
from tfk8s_tpu_torch.ops import flash_attention as tfa
from tfk8s_tpu_torch.ops import group_norm as tgn

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


# -- GroupNorm ------------------------------------------------------------------

# (shape [B, H, W, C], groups, relu): small and ragged cases, then the
# ResNet-50 shapes (the two largest norm sites and the widest)
GN_SMALL = [
    ((2, 8, 8, 64), 32, True),
    ((2, 10, 20, 24), 24, False),   # groups = C, several ragged chunks
    ((3, 7, 9, 48), 8, True),       # ragged H x W
    ((2, 5, 5, 6), 3, True),        # C not a multiple of 16 bytes
    ((4, 4, 4, 32), 1, False),
    ((2, 3, 5, 4096), 32, True),    # two channel tiles (ResNet-50 at width 128)
    ((2, 6, 7, 3000), 8, False),    # a ragged last channel tile
    ((1, 4, 4, 8192), 1, True),     # one group across four tiles
]
GN_RESNET = [
    ((256, 112, 112, 64), 32, True),
    ((256, 56, 56, 256), 32, False),
    ((256, 7, 7, 2048), 32, True),
]


def _gn_inputs(shape, dtype, device, seed=0, mean=0.5):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn(shape, generator=gen, device=device) * 2 + mean).to(dtype)
    dy = torch.randn(shape, generator=gen, device=device).to(dtype)
    scale = torch.randn(shape[-1], generator=gen, device=device)
    bias = torch.randn(shape[-1], generator=gen, device=device)
    return x, dy, scale, bias


def _gn_check(shape, groups, relu, dtype, device):
    x, dy, scale, bias = _gn_inputs(shape, dtype, device)
    y_k, m_k, r_k = tgn.group_norm_fwd_cuda(x, scale, bias, groups, relu=relu)
    y_p, m_p, r_p = tgn.group_norm_fwd_plain(x, scale, bias, groups, relu=relu)
    bf16 = dtype == torch.bfloat16
    out_tol = dict(atol=2e-2, rtol=2 ** -7) if bf16 else dict(atol=OUT_ATOL, rtol=0)
    torch.testing.assert_close(m_k, m_p, atol=OUT_ATOL, rtol=1e-5)
    torch.testing.assert_close(r_k, r_p, atol=OUT_ATOL, rtol=1e-5)
    torch.testing.assert_close(y_k.float(), y_p.float(), **out_tol)
    # both backwards from the kernel's statistics: the ReLU mask must agree
    dx_k, ds_k, db_k = tgn.group_norm_bwd_cuda(dy, x, scale, bias, m_k, r_k, groups, relu)
    dx_p, ds_p, db_p = tgn.group_norm_bwd_plain(dy, x, scale, bias, m_k, r_k, groups, relu)
    grad_tol = dict(atol=2e-2, rtol=2 ** -7) if bf16 else dict(atol=GRAD_ATOL, rtol=0)
    torch.testing.assert_close(dx_k.float(), dx_p.float(), **grad_tol)
    par_tol = dict(atol=1e-2, rtol=1e-3) if x.numel() > 1e6 else dict(atol=GRAD_ATOL, rtol=0)
    torch.testing.assert_close(ds_k, ds_p, **par_tol)
    torch.testing.assert_close(db_k, db_p, **par_tol)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,groups,relu", GN_SMALL)
def test_group_norm_kernels_match_plain_small(card, shape, groups, relu, dtype):
    _gn_check(shape, groups, relu, dtype, card)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,groups,relu", GN_RESNET)
def test_group_norm_kernels_match_plain_at_resnet50_shapes(card, shape, groups, relu, dtype):
    _gn_check(shape, groups, relu, dtype, card)


@pytest.mark.cuda
def test_group_norm_kernel_keeps_a_stable_variance_at_large_mean(card):
    x, _, scale, bias = _gn_inputs((2, 16, 16, 32), torch.float32, card, mean=0.0)
    x = x * 1e-2 + 1e3
    y_k, _, r_k = tgn.group_norm_fwd_cuda(x, scale, bias, 8)
    xd = x.double().reshape(2, -1, 8, 4)
    var = xd.var(dim=(1, 3), unbiased=False)
    torch.testing.assert_close(r_k.double(), torch.rsqrt(var + 1e-6), rtol=2e-2, atol=0)
    assert torch.isfinite(y_k).all()


@pytest.mark.cuda
def test_group_norm_kernel_puts_eps_inside_the_square_root(card):
    """A variance of 1e-6, the size of eps: eps 1e-5 in its place, or eps
    outside the square root, would move rstd by a factor of 2 or more."""
    x, _, scale, bias = _gn_inputs((2, 8, 8, 32), torch.float32, card, mean=0.0)
    x = x * 5e-4
    for eps in (1e-6, 1e-5):
        _, _, r_k = tgn.group_norm_fwd_cuda(x, scale, bias, 8, eps=eps)
        var = x.double().reshape(2, -1, 8, 4).var(dim=(1, 3), unbiased=False)
        torch.testing.assert_close(r_k.double(), torch.rsqrt(var + eps), rtol=1e-4, atol=0)


@pytest.mark.cuda
def test_group_norm_kernel_repeats_bit_for_bit(card):
    x, dy, scale, bias = _gn_inputs((8, 28, 28, 512), torch.bfloat16, card)
    outs = []
    for _ in range(2):
        y, m, r = tgn.group_norm_fwd_cuda(x, scale, bias, 32, relu=True)
        outs.append((y, m, r, *tgn.group_norm_bwd_cuda(dy, x, scale, bias, m, r, 32, True)))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_group_norm_autograd_on_the_card_never_reaches_the_plain_path(card, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    x, dy, scale, bias = _gn_inputs((2, 6, 10, 64), torch.float32, card, seed=3)
    outs = []
    for dev in (card, torch.device("cpu")):
        if dev.type == "cuda":
            monkeypatch.setattr(tgn, "group_norm_fwd_plain", refuse)
            monkeypatch.setattr(tgn, "group_norm_bwd_plain", refuse)
        ts = [t.detach().to(dev).requires_grad_() for t in (x, scale, bias)]
        tgn.reset_launches()
        y = tgn.fused_group_norm(*ts, 32, relu=True)
        y.backward(dy.to(dev))
        outs.append([t.detach().cpu() for t in (y, *(u.grad for u in ts))])
        want = 1 if dev.type == "cuda" else 0
        assert tgn.LAUNCHES == dict.fromkeys(tgn.KERNELS, want)
        monkeypatch.undo()
    for got, want in zip(*outs):
        torch.testing.assert_close(got, want, atol=GRAD_ATOL, rtol=0)


@pytest.mark.cuda
def test_group_norm_wrapper_refuses_what_the_kernels_do_not_take(card):
    s = torch.ones(16, device=card)
    with pytest.raises(TypeError):
        tgn.group_norm_fwd_cuda(torch.zeros(1, 2, 2, 16, device=card).half(), s, s, 4)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros(1, 16, 2, 2, device=card).permute(0, 2, 3, 1)[:, :, :1]
        tgn.group_norm_fwd_cuda(t, s, s, 4)
    with pytest.raises(ValueError, match="float32"):
        tgn.group_norm_fwd_cuda(torch.zeros(1, 2, 2, 16, device=card), s.half(), s, 4)


# -- block copy -------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cols", [(8192, 8192), (9, 7), (1, 3), (33, 4), (100, 1001)])
def test_block_copy_is_bit_exact(card, rows, cols):
    x = torch.randn(rows, cols, device=card)
    out = torch.full_like(x, float("nan"))
    tbc.reset_launches()
    assert tbc.block_copy(x, out) is out
    torch.cuda.synchronize()
    assert torch.equal(out, tbc.block_copy_plain(x)) and tbc.LAUNCHES == {"block_copy": 1}


@pytest.mark.cuda
def test_block_copy_refuses_misaligned_views(card):
    x = torch.zeros(4 * 64 + 1, device=card)[1:].reshape(4, 64)
    with pytest.raises(ValueError, match="aligned"):
        tbc.block_copy(x)
