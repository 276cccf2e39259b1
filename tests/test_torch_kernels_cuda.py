"""The port's CUDA kernels (flash attention, GroupNorm forward and
backward, the block copy) against their plain versions, on the card.
Every test here is marked ``cuda`` and skips without one.

This file imports neither JAX nor the JAX package, so it runs on the
machine with the card, from the root of a checkout:

    python -m pytest --noconftest -q -m cuda tests/test_torch_kernels_cuda.py

float32 inputs (TF32 off) run the CUDA-core flash kernels: outputs agree
to atol 1e-5, gradients to 1e-4. bfloat16 inputs run the tensor-core
kernels (wgmma, TMA: the forward, the D pre-pass, dq and dk/dv): within
atol 2e-2 plus one bfloat16 rounding step (rtol 2^-7) of the plain
version's, which computes in float32 from the same bfloat16 inputs; the
kernels round P and dS to bfloat16 before their second products.
GroupNorm in bfloat16: outputs and dx within one bfloat16 rounding step
of the plain version's (atol 2e-2 plus rtol 2^-7). The float32 dscale and
dbias, in both types, against the float64 sums of the same float32 terms,
within PARAM_EPS float32 rounding steps of the terms' L2 norm, a bound
that grows with the sum's length as its rounding does. The copy is
bit-exact.
"""

import math

import numpy as np
import pytest
import torch

from tfk8s_tpu_torch.ops import block_copy as tbc
from tfk8s_tpu_torch.ops import flash_attention as tfa
from tfk8s_tpu_torch.ops import group_norm as tgn
import _torch_threads  # noqa: F401  (torch's threads under xdist)

OUT_ATOL, GRAD_ATOL = 1e-5, 1e-4
BF16_TOL = dict(atol=2e-2, rtol=2 ** -7)
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


def _case(case, d, device, seed=4, dtype=torch.float32):
    lq, lk, causal, mask = CASES[case]
    rng = np.random.default_rng(seed)
    b, h = 2, 3
    shapes = [(b, lq + RAGGED, h, d), (b, lk + RAGGED, h, d), (b, lk + RAGGED, h, d),
              (b, lq + RAGGED, h, d)]
    q, k, v, g = (torch.tensor(rng.standard_normal(s).astype(np.float32), device=device)
                  for s in shapes)
    q = q / d ** 0.5
    q, k, v, g = (t.to(dtype) for t in (q, k, v, g))
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
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_bf16_kernels_match_plain(card, case, d):
    """The tensor-core forward, then the backward fed by it: one pre-pass
    for the tensor-core dq and dk/dv."""
    q, k, v, g, tm, causal = _case(case, d, card, dtype=torch.bfloat16)
    tfa.reset_launches()
    o_c, lse_c = tfa.flash_fwd_cuda(q, k, v, tm, causal)
    o_p, lse_p = tfa.flash_fwd_plain(q, k, v, tm, causal)
    torch.testing.assert_close(o_c.float(), o_p.float(), **BF16_TOL)
    live = lse_p > -1e29
    torch.testing.assert_close(lse_c > -1e29, live)
    torch.testing.assert_close(lse_c[live], lse_p[live], **BF16_TOL)
    for got, want in zip(tfa.flash_bwd_cuda(q, k, v, g, o_c, lse_c, tm, causal),
                         tfa.flash_bwd_plain(q, k, v, g, o_c, lse_c, tm, causal)):
        torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES == {**dict.fromkeys(tfa.KERNELS, 0),
                            **dict.fromkeys(tfa.TENSOR_CORE_KERNELS, 1)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_bf16_dq_wgmma_matches_plain(card, case, d):
    """The tensor-core dq on the pre-pass's (D, lse2), and ``flash_bwd_dq_cuda``,
    which runs the same two kernels, bit for bit."""
    q, k, v, g, tm, causal = _case(case, d, card, seed=6, dtype=torch.bfloat16)
    o, lse = tfa.flash_fwd_cuda(q, k, v, tm, causal)
    dsum, lse2 = tfa.flash_bwd_dsum_cuda(g, o, lse)
    tfa.reset_launches()
    dq_c = tfa.flash_bwd_dq_wgmma_cuda(q, k, v, g, dsum, lse2, tm, causal)
    dq_p = tfa.flash_bwd_dq_plain(q, k, v, g, o, lse, tm, causal)
    torch.testing.assert_close(dq_c.float(), dq_p.float(), **BF16_TOL)
    assert torch.equal(tfa.flash_bwd_dq_cuda(q, k, v, g, o, lse, tm, causal), dq_c)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES == {**dict.fromkeys(tfa.KERNELS, 0), "flash_bwd_dq_wgmma": 2,
                            "flash_bwd_dsum": 1}


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
        want = dict.fromkeys(tfa.KERNELS, 0)
        if dev.type == "cuda":  # float32: the CUDA-core kernels
            want.update(dict.fromkeys(tfa.SIMT_KERNELS, 1))
        assert launches == want
    for got, want in zip(*outs):
        torch.testing.assert_close(got, want, atol=GRAD_ATOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["causal", "fully_masked_row", "causal_lq_lt_lk"])
def test_bf16_autograd_reaches_only_the_tensor_core_kernels(card, case, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    for name in ("flash_fwd_plain", "flash_bwd_plain", "flash_bwd_dq_plain",
                 "flash_bwd_dkv_plain", "flash_bwd_dsum_plain"):
        monkeypatch.setattr(tfa, name, refuse)
    q, k, v, g, tm, causal = _case(case, 64, card, seed=5, dtype=torch.bfloat16)
    ts = [t.detach().requires_grad_() for t in (q, k, v)]
    tfa.reset_launches()
    out = tfa.flash_attention(*ts, mask=tm, causal=causal)
    out.backward(g)
    torch.cuda.synchronize()
    # one pre-pass feeds both dq and dk/dv
    assert tfa.LAUNCHES == {**dict.fromkeys(tfa.KERNELS, 0),
                            **dict.fromkeys(tfa.TENSOR_CORE_KERNELS, 1)}
    monkeypatch.undo()
    o_p, lse_p = tfa.flash_fwd_plain(q, k, v, tm, causal)
    torch.testing.assert_close(out.detach().float(), o_p.float(), **BF16_TOL)
    for got, want in zip((t.grad for t in ts),
                         tfa.flash_bwd_plain(q, k, v, g, out.detach(), lse_p, tm, causal)):
        torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)


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
    for got, want in zip(tfa.flash_bwd_dkv_cuda(q, k, v, g, o_c, lse_c, None, True),
                         tfa.flash_bwd_dkv_plain(q, k, v, g, o_c, lse_c, None, True)):
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2 ** -7)


# name -> (lq, lk, key lengths or None): the non-causal shapes the BERT,
# ViT and T5 families give the kernels at full width (12 heads of 64)
FAMILY_CASES = {
    "bert_non_causal_512": (512, 512, None),
    "vit_b16_ragged_196": (196, 196, None),  # 3 x 64 + 4: the ragged edge
    "t5_cross_padded_keys_512": (512, 512, [384, 256]),  # a quarter, a half padded
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(FAMILY_CASES))
def test_kernels_at_the_families_shapes(card, case, dtype):
    """The forward, then the backward as training runs it, at [2, l, 12,
    64], non-causal: bfloat16 through the tensor-core kernels, float32
    through the CUDA-core ones, each against the plain versions."""
    lq, lk, lengths = FAMILY_CASES[case]
    _check_at_shape(card, lq, lk, 12, lengths, False, dtype)


def _check_at_shape(card, lq, lk, heads, lengths, causal, dtype):
    gen = torch.Generator(device=card).manual_seed(3)
    q, g = (torch.randn(2, lq, heads, 64, generator=gen, device=card) for _ in range(2))
    k, v = (torch.randn(2, lk, heads, 64, generator=gen, device=card) for _ in range(2))
    q, k, v, g = ((q / 8).to(dtype), k.to(dtype), v.to(dtype), g.to(dtype))
    mask = None
    if lengths is not None:
        mask = torch.tensor(_key_mask(lengths, lk), device=card)
    tol = BF16_TOL if dtype == torch.bfloat16 else dict(atol=OUT_ATOL, rtol=0)
    grad_tol = BF16_TOL if dtype == torch.bfloat16 else dict(atol=GRAD_ATOL, rtol=0)
    tfa.reset_launches()
    o_c, lse_c = tfa.flash_fwd_cuda(q, k, v, mask, causal)
    o_p, lse_p = tfa.flash_fwd_plain(q, k, v, mask, causal)
    torch.testing.assert_close(o_c.float(), o_p.float(), **tol)
    torch.testing.assert_close(lse_c, lse_p, **tol)
    for got, want in zip(tfa.flash_bwd_cuda(q, k, v, g, o_c, lse_c, mask, causal),
                         tfa.flash_bwd_plain(q, k, v, g, o_c, lse_c, mask, causal)):
        torch.testing.assert_close(got.float(), want.float(), **grad_tol)
    torch.cuda.synchronize()
    kernels = tfa.TENSOR_CORE_KERNELS if dtype == torch.bfloat16 else tfa.SIMT_KERNELS
    assert tfa.LAUNCHES == {**dict.fromkeys(tfa.KERNELS, 0), **dict.fromkeys(kernels, 1)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [False, True], ids=["non_causal", "causal"])
def test_kernels_at_the_ulysses_local_shape(card, causal, dtype):
    """Ulysses' local call over two sequence ranks at BERT-base and
    GPT-2-small width: the whole 512-token sequence, 6 of the 12 heads
    ([2, 512, 6, 64]), through the kernels against the plain versions."""
    _check_at_shape(card, 512, 512, 6, None, causal, dtype)


@pytest.mark.cuda
def test_bf16_dkv_repeats_bit_for_bit(card):
    gen = torch.Generator(device=card).manual_seed(3)
    q, k, v, g = (torch.randn(2, 777, 4, 64, generator=gen, device=card).to(torch.bfloat16)
                  for _ in range(4))
    mask = torch.arange(777, device=card)[None] < torch.tensor([[777], [500]], device=card)
    o, lse = tfa.flash_fwd_cuda(q, k, v, mask, True)
    first = tfa.flash_bwd_dkv_cuda(q, k, v, g, o, lse, mask, True)
    for _ in range(3):
        for a, b in zip(first, tfa.flash_bwd_dkv_cuda(q, k, v, g, o, lse, mask, True)):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_bf16_dq_repeats_bit_for_bit(card):
    gen = torch.Generator(device=card).manual_seed(4)
    q, k, v, g = (torch.randn(2, 777, 4, 64, generator=gen, device=card).to(torch.bfloat16)
                  for _ in range(4))
    mask = torch.arange(777, device=card)[None] < torch.tensor([[777], [500]], device=card)
    o, lse = tfa.flash_fwd_cuda(q, k, v, mask, True)
    dsum, lse2 = tfa.flash_bwd_dsum_cuda(g, o, lse)
    first = tfa.flash_bwd_dq_wgmma_cuda(q, k, v, g, dsum, lse2, mask, True)
    for _ in range(3):
        assert torch.equal(first, tfa.flash_bwd_dq_wgmma_cuda(q, k, v, g, dsum, lse2, mask, True))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 64, 128])
def test_bf16_backward_is_exactly_zero_on_fully_masked_rows(card, d):
    """A batch row whose keys are all masked, over several q tiles and a
    ragged edge: its lse2 is +inf, so dq, dk and dv are exactly zero."""
    gen = torch.Generator(device=card).manual_seed(d)
    q, k, v, g = (torch.randn(2, 200, 3, d, generator=gen, device=card).to(torch.bfloat16)
                  for _ in range(4))
    mask = torch.arange(200, device=card)[None] < torch.tensor([[150], [0]], device=card)
    o, lse = tfa.flash_fwd_cuda(q, k, v, mask, False)
    dq, dk, dv = tfa.flash_bwd_cuda(q, k, v, g, o, lse, mask, False)
    torch.cuda.synchronize()
    for t in (o, dq, dk, dv):
        assert torch.isfinite(t).all() and t[1].abs().max() == 0
    assert dq[0].abs().max() > 0


@pytest.mark.cuda
def test_bf16_kernels_refuse_misaligned_views(card):
    """TMA reads 16-byte aligned tensors: a view one element in raises."""
    n = 2 * 32 * 2 * 64
    flat = torch.zeros(n + 1, device=card, dtype=torch.bfloat16)
    bad = flat[1:].view(2, 32, 2, 64)
    good = torch.zeros(2, 32, 2, 64, device=card, dtype=torch.bfloat16)
    lse = torch.zeros(2, 2, 32, device=card)
    dsum = lse2 = torch.zeros(2 * 2, 64, device=card)
    with pytest.raises(ValueError, match="aligned"):
        tfa.flash_fwd_cuda(bad, good, good)
    with pytest.raises(ValueError, match="aligned"):
        tfa.flash_bwd_dkv_cuda(good, bad, good, good, good, lse)
    with pytest.raises(ValueError, match="aligned"):
        tfa.flash_bwd_dkv_cuda(good, good, good, bad, good, lse)
    with pytest.raises(ValueError, match="aligned"):
        tfa.flash_bwd_dq_cuda(good, good, bad, good, good, lse)
    for i in range(4):  # each of q, k, v, dO
        args = [good] * 4
        args[i] = bad
        with pytest.raises(ValueError, match="aligned"):
            tfa.flash_bwd_dq_wgmma_cuda(*args, dsum, lse2)


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


# dscale and dbias: each channel's distance from the float64 sum of its
# float32 terms stays within PARAM_EPS float32 rounding steps (2^-23) of
# the terms' L2 norm. A float32 sum taken in blocks, in any order, errs by
# a few such steps (for terms of one size the bound grows as the square
# root of the sum's length); one term dropped from a long sum exceeds it.
PARAM_EPS = 32


def _gn_param_check(ds_k, db_k, dy, x, scale, bias, mean, rstd, groups, relu):
    """dscale and dbias against the float64 sums of the float32 terms
    dz * xhat and dz, formed as the plain version forms them."""
    b, h, w, c = x.shape
    cg = c // groups
    xhat = (x.float().reshape(b, h * w, groups, cg) - mean[:, None, :, None]) \
        * rstd[:, None, :, None]
    dz = dy.float().reshape(b, h * w, groups, cg)
    if relu:
        pre = xhat * scale.reshape(groups, cg) + bias.reshape(groups, cg)
        dz = torch.where(pre > 0, dz, torch.zeros((), device=dz.device))
    for name, got, terms in (("dscale", ds_k, dz * xhat), ("dbias", db_k, dz)):
        t = terms.double().reshape(-1, c)
        err = (got.double() - t.sum(0)).abs()
        bound = PARAM_EPS * 2.0 ** -23 * t.square().sum(0).sqrt()
        share = float((err / bound.clamp_min(1e-300)).max())
        assert bool((err <= bound).all()), f"{name}: {share:.3g} times the bound"


def _gn_check(shape, groups, relu, dtype, device, x=None):
    """Both kernels against their plain versions on one case; each launch
    must count under the path that the layout rule gives the case and
    x's alignment."""
    x_, dy, scale, bias = _gn_inputs(shape, dtype, device)
    x = x_ if x is None else x.copy_(x_)
    tgn.reset_launches()
    y_k, m_k, r_k = tgn.group_norm_fwd_cuda(x, scale, bias, groups, relu=relu)
    y_p, m_p, r_p = tgn.group_norm_fwd_plain(x, scale, bias, groups, relu=relu)
    bf16 = dtype == torch.bfloat16
    out_tol = dict(atol=2e-2, rtol=2 ** -7) if bf16 else dict(atol=OUT_ATOL, rtol=0)
    torch.testing.assert_close(m_k, m_p, atol=OUT_ATOL, rtol=1e-5)
    torch.testing.assert_close(r_k, r_p, atol=OUT_ATOL, rtol=1e-5)
    torch.testing.assert_close(y_k.float(), y_p.float(), **out_tol)
    # both backwards from the kernel's statistics: the ReLU mask must agree
    dx_k, ds_k, db_k = tgn.group_norm_bwd_cuda(dy, x, scale, bias, m_k, r_k, groups, relu)
    dx_p, _, _ = tgn.group_norm_bwd_plain(dy, x, scale, bias, m_k, r_k, groups, relu)
    grad_tol = dict(atol=2e-2, rtol=2 ** -7) if bf16 else dict(atol=GRAD_ATOL, rtol=0)
    torch.testing.assert_close(dx_k.float(), dx_p.float(), **grad_tol)
    _gn_param_check(ds_k, db_k, dy, x, scale, bias, m_k, r_k, groups, relu)
    torch.cuda.synchronize()
    want = dict.fromkeys(tgn.KERNELS, 0)
    for backward in (False, True):
        want[tgn.kernel_name(shape, groups, dtype, backward, tgn.alignment(x))] = 1
    assert tgn.LAUNCHES == want


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
@pytest.mark.parametrize("shape,dtype", [
    ((8, 28, 28, 512), torch.bfloat16),   # clusters of one block
    ((2, 112, 112, 64), torch.bfloat16),  # clusters of 8
    ((2, 112, 112, 64), torch.float32),   # clusters of 7
    ((1, 176, 176, 32), torch.bfloat16),  # the two-read path (one group, G = 1)
], ids=["k1", "k8", "k7_f32", "two_read"])
def test_group_norm_kernel_repeats_bit_for_bit(card, shape, dtype):
    groups = 1 if shape[-1] == 32 else 32
    x, dy, scale, bias = _gn_inputs(shape, dtype, card)
    outs = []
    for _ in range(2):
        tgn.reset_launches()
        y, m, r = tgn.group_norm_fwd_cuda(x, scale, bias, groups, relu=True)
        outs.append((y, m, r, *tgn.group_norm_bwd_cuda(dy, x, scale, bias, m, r, groups, True)))
        assert tgn.LAUNCHES[tgn.kernel_name(shape, groups, dtype, False)] == 1
        assert tgn.LAUNCHES[tgn.kernel_name(shape, groups, dtype, True)] == 1
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# forward cluster size -> a case that takes it: [B, H, W, C] with C = 64 in
# 32 groups (tiles of 64 bytes a position), H x W growing
GN_CLUSTERS = {1: (2, 40, 40, 64), 2: (2, 56, 56, 64), 4: (2, 80, 80, 64),
               8: (2, 160, 160, 64)}


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [False, True], ids=["plain", "relu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("k", list(GN_CLUSTERS))
def test_group_norm_one_read_kernels_at_each_cluster_size(card, k, dtype, relu):
    shape = GN_CLUSTERS[k]
    assert tgn.cluster_size(shape, 32, dtype, False) == k
    assert tgn.cluster_size(shape, 32, dtype, True) >= k
    _gn_check(shape, 32, relu, dtype, card)


# (shape, groups, dtype, forward path, backward path): each side of the
# one-read / two-read boundary, in slab size (one group across the image)
# and in tile width (one group across C)
GN_BOUNDARY = [
    ((1, 112, 112, 32), 1, torch.bfloat16, "one", "one"),
    ((1, 160, 160, 32), 1, torch.bfloat16, "one", "two"),
    ((1, 176, 176, 32), 1, torch.bfloat16, "two", "two"),
    ((1, 4, 4, 2048), 1, torch.float32, "one", "one"),
    ((1, 4, 4, 4096), 1, torch.float32, "two", "two"),
    ((1, 4, 4, 4096), 1, torch.bfloat16, "one", "two"),
    ((1, 4, 4, 8192), 1, torch.bfloat16, "two", "two"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,groups,dtype,fwd,bwd", GN_BOUNDARY,
                         ids=[f"{'x'.join(map(str, c[0]))}_{str(c[2])[6:]}" for c in GN_BOUNDARY])
def test_group_norm_path_on_each_side_of_the_one_read_boundary(card, shape, groups, dtype, fwd,
                                                               bwd):
    for backward, want in ((False, fwd), (True, bwd)):
        assert (tgn.cluster_size(shape, groups, dtype, backward) > 0) == (want == "one")
    _gn_check(shape, groups, True, dtype, card)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,groups", [((2, 9, 7, 15), 5), ((2, 6, 5, 40), 10)],
                         ids=["c15_odd", "c40_g10"])
def test_group_norm_one_read_without_tma(card, shape, groups, dtype):
    """C * elt not a multiple of 16 bytes (in bfloat16 for C = 40): the
    slab arrives by cp.async (a single bfloat16 at a time for odd C)
    instead of TMA boxes."""
    assert tgn.cluster_size(shape, groups, dtype, False) > 0
    _gn_check(shape, groups, True, dtype, card)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,groups,dtype,offset,path", [
    ((2, 8, 8, 64), 32, torch.float32, 2, "one"),    # 8 bytes past: 8-byte loads
    ((2, 8, 8, 64), 32, torch.bfloat16, 1, "one"),   # 2 bytes past: a value a load
    ((1, 4, 4, 2048), 1, torch.float32, 1, "two"),   # 4 bytes past: 2048 columns of one value
], ids=["f32_8B", "bf16_2B", "f32_4B_wide"])
def test_group_norm_path_of_a_misaligned_tensor(card, shape, groups, dtype, offset, path):
    """A view that starts mid-buffer keeps the one-read kernel (cp.async
    loads as wide as its alignment allows) while its tile fits 512
    columns; the same shape 16-byte aligned would take TMA boxes."""
    x = torch.empty(math.prod(shape) + offset, dtype=dtype, device=card)[offset:].view(shape)
    assert x.is_contiguous() and tgn.alignment(x) == offset * x.element_size()
    for backward in (False, True):
        got = tgn.cluster_size(shape, groups, dtype, backward, tgn.alignment(x)) > 0
        assert got == (path == "one")
    _gn_check(shape, groups, True, dtype, card, x=x)


@pytest.mark.cuda
def test_group_norm_stem_backward_in_f32_holds_the_largest_slab(card):
    """ResNet-50's stem at batch 256, float32: 1.6 MB of x and dy a
    (sample, two-group tile), held by the largest cluster the rule gives a
    ResNet-50 site."""
    shape = (256, 112, 112, 64)
    assert tgn.cluster_size(shape, 32, torch.float32, True) == 7
    _gn_check(shape, 32, True, torch.float32, card)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,groups", [((4, 56, 56, 64), 32), ((1, 176, 176, 32), 1)],
                         ids=["one_read", "two_read"])
def test_group_norm_backward_writes_every_per_sample_partial(card, shape, groups):
    """dscale and dbias come from [B, C] per-sample partials in a [2, B, C]
    buffer that torch.empty hands over unwritten: fill the allocator's
    cached blocks of that size with NaN first, so that an entry the kernels
    left unwritten would show."""
    x, dy, scale, bias = _gn_inputs(shape, torch.float32, card, seed=5)
    b, c = shape[0], shape[-1]
    junk = [torch.full((2, b, c), float("nan"), device=card) for _ in range(64)]
    del junk
    _, m, r = tgn.group_norm_fwd_cuda(x, scale, bias, groups, relu=True)
    _, ds_k, db_k = tgn.group_norm_bwd_cuda(dy, x, scale, bias, m, r, groups, True)
    assert torch.isfinite(ds_k).all() and torch.isfinite(db_k).all()
    _gn_param_check(ds_k, db_k, dy, x, scale, bias, m, r, groups, True)


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
        want = dict.fromkeys(tgn.KERNELS, 0)
        if dev.type == "cuda":  # one launch a direction, both of the one-read kernels
            want.update(dict.fromkeys(tgn.ONE_READ_KERNELS, 1))
        assert tgn.LAUNCHES == want
        monkeypatch.undo()
    for got, want in zip(*outs):
        torch.testing.assert_close(got, want, atol=GRAD_ATOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,groups,dtype,kernels", [
    ((4, 56, 56, 64), 32, torch.bfloat16, tgn.ONE_READ_KERNELS),
    ((2, 7, 7, 2048), 32, torch.float32, tgn.ONE_READ_KERNELS),
    ((1, 176, 176, 32), 1, torch.bfloat16, tgn.TWO_READ_KERNELS),
], ids=["one_read_bf16", "one_read_f32", "two_read_bf16"])
def test_group_norm_autograd_launch_counts(card, shape, groups, dtype, kernels):
    """fused_group_norm under autograd, three steps: each step launches one
    forward and one backward kernel of the path its shape takes, and no
    other GroupNorm kernel."""
    x, dy, scale, bias = _gn_inputs(shape, dtype, card, seed=2)
    for t in (x, scale, bias):
        t.requires_grad_()
    tgn.reset_launches()
    for _ in range(3):
        tgn.fused_group_norm(x, scale, bias, groups, relu=True).backward(dy)
    torch.cuda.synchronize()
    want = dict.fromkeys(tgn.KERNELS, 0)
    want.update(dict.fromkeys(kernels, 3))
    assert tgn.LAUNCHES == want
    assert torch.isfinite(x.grad).all() and torch.isfinite(scale.grad).all()


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
@pytest.mark.parametrize("rows,cols", [(8192, 8192), (9, 7), (1, 3), (33, 4), (100, 1001),
                                       (4097, 1025)])  # bytes not a multiple of 16
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
