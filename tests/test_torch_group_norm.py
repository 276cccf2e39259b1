"""The port's GroupNorm against the JAX package's.

The same numpy inputs go through the JAX ``fused_group_norm_interpret``
(its Pallas kernels in interpret mode, as ``tests/test_group_norm.py``
runs them on the CPU) and ``reference_group_norm``, and through the port's
plain forward and backward (what its CUDA kernels compute; on CPU tensors
``fused_group_norm`` runs them). float32: outputs agree to atol 1e-5 and
gradients to atol 1e-4. bfloat16 inputs: outputs within one bfloat16
rounding step (2^-7 of the value, plus 2^-7 absolute near zero), since
the two sides round the same float32 value and may land on either side.

The kernels themselves run only on the card, in
``tests/test_torch_kernels_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfk8s_tpu.ops.group_norm import fused_group_norm_interpret, reference_group_norm
from tfk8s_tpu_torch.ops import group_norm as tgn
import _torch_threads  # noqa: F401  (torch's threads under xdist)

OUT_ATOL, GRAD_ATOL = 1e-5, 1e-4
BF16_STEP = 2.0 ** -7

# (shape [B, H, W, C], groups): C < 128, groups = C, one group, ragged H x W,
# and C past one of the CUDA kernels' 2048-channel tiles (ResNet-50 at
# width 128 reaches 4096; 3000 leaves a ragged last tile)
CASES = {
    "c64_g32": ((2, 8, 8, 64), 32),
    "c16_g4": ((2, 4, 4, 16), 4),
    "groups_eq_c": ((2, 5, 3, 24), 24),
    "one_group": ((3, 4, 6, 32), 1),
    "ragged_hw": ((2, 7, 9, 48), 8),
    "wide_c4096": ((2, 2, 3, 4096), 32),
    "wide_c3000": ((1, 3, 2, 3000), 8),
}


def _inputs(shape, seed=0, mean=0.0):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.standard_normal(shape) * 2.0 + mean).astype(np.float32)
    scale = rng.standard_normal(c).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    ct = rng.standard_normal(shape).astype(np.float32)
    return x, scale, bias, ct


def _t(*arrays, grad=False):
    return [torch.tensor(a, requires_grad=grad) for a in arrays]


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_pallas_interpret_and_reference(case, relu):
    shape, groups = CASES[case]
    x, scale, bias, _ = _inputs(shape, seed=1, mean=3.0)
    want_k = np.asarray(fused_group_norm_interpret(x, scale, bias, groups, relu=relu))
    want_r = np.asarray(reference_group_norm(x, scale, bias, groups, relu=relu))
    y, mean, rstd = tgn.group_norm_fwd_plain(*_t(x, scale, bias), groups, relu=relu)
    np.testing.assert_allclose(y.numpy(), want_k, atol=OUT_ATOL, rtol=0)
    np.testing.assert_allclose(y.numpy(), want_r, atol=OUT_ATOL, rtol=0)
    xg = x.reshape(shape[0], -1, groups, shape[-1] // groups)
    np.testing.assert_allclose(mean.numpy(), xg.mean(axis=(1, 3)), atol=OUT_ATOL, rtol=0)
    np.testing.assert_allclose(rstd.numpy(), 1 / np.sqrt(xg.var(axis=(1, 3)) + 1e-6),
                               rtol=1e-5)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_gradients_match_pallas_interpret(case, relu):
    shape, groups = CASES[case]
    x, scale, bias, ct = _inputs(shape, seed=2)

    def loss(impl):
        return lambda x, s, b: jnp.sum(impl(x, s, b, groups, 1e-6, relu) * ct)

    want_k = jax.grad(loss(fused_group_norm_interpret), argnums=(0, 1, 2))(x, scale, bias)
    want_r = jax.grad(loss(reference_group_norm), argnums=(0, 1, 2))(x, scale, bias)
    xt, st, bt = _t(x, scale, bias, grad=True)
    (tgn.fused_group_norm(xt, st, bt, groups, relu=relu) * torch.tensor(ct)).sum().backward()
    # the plain backward on its own, from the plain forward's statistics
    _, mean, rstd = tgn.group_norm_fwd_plain(*_t(x, scale, bias), groups, relu=relu)
    plain = tgn.group_norm_bwd_plain(*_t(ct, x, scale, bias), mean, rstd, groups, relu)
    for name, got, via, a, b in zip(("dx", "dscale", "dbias"), (xt.grad, st.grad, bt.grad),
                                    plain, want_k, want_r):
        np.testing.assert_allclose(got.numpy(), np.asarray(a), atol=GRAD_ATOL, err_msg=name)
        np.testing.assert_allclose(got.numpy(), np.asarray(b), atol=GRAD_ATOL, err_msg=name)
        np.testing.assert_allclose(via.numpy(), got.numpy(), atol=0, rtol=0, err_msg=name)


def test_reference_group_norm_autograd_matches_the_fused_backward():
    x, scale, bias, ct = _inputs((2, 6, 6, 32), seed=3)
    grads = []
    for fn in (tgn.reference_group_norm, tgn.fused_group_norm):
        ts = _t(x, scale, bias, grad=True)
        (fn(*ts, 8, relu=True) * torch.tensor(ct)).sum().backward()
        grads.append([t.grad for t in ts])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=GRAD_ATOL, rtol=0)


@pytest.mark.parametrize("case", ["c64_g32", "ragged_hw"])
def test_bf16_within_one_rounding_step(case):
    shape, groups = CASES[case]
    x, scale, bias, _ = _inputs(shape, seed=4, mean=1.0)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(fused_group_norm_interpret(xb, scale, bias, groups, relu=True),
                      np.float32)
    xt = torch.tensor(np.asarray(xb, np.float32)).to(torch.bfloat16)
    y = tgn.fused_group_norm(xt, *_t(scale, bias), groups, relu=True)
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().numpy(), want, atol=BF16_STEP, rtol=BF16_STEP)


def test_large_mean_keeps_the_two_pass_variance():
    """|mean| = 1e3 >> std = 0.02: a one-pass float32 E[x^2] - mean^2 gives
    variances of -0.125 to 0.56 here against a true 4e-4 (normalized values
    off by 10x or NaN); the two-pass one is off only by the float32
    rounding of the mean near 1e3 (ulp 6e-5, 0.3% of std, times |xhat *
    scale| up to ~10), so atol 5e-2."""
    x, scale, bias, _ = _inputs((2, 8, 8, 16), seed=5)
    x = (x * 1e-2 + 1e3).astype(np.float32)
    xg = x.astype(np.float64).reshape(2, -1, 4, 4)
    xhat = (xg - xg.mean(axis=(1, 3), keepdims=True)) / np.sqrt(
        xg.var(axis=(1, 3), keepdims=True) + 1e-6)
    want = xhat.reshape(x.shape) * scale + bias
    y, _, _ = tgn.group_norm_fwd_plain(*_t(x, scale, bias), 4)
    np.testing.assert_allclose(y.numpy(), want, atol=5e-2)


def test_cpu_tensors_take_the_plain_path(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor reached a CUDA wrapper")

    monkeypatch.setattr(tgn, "group_norm_fwd_cuda", refuse)
    monkeypatch.setattr(tgn, "group_norm_bwd_cuda", refuse)
    tgn.reset_launches()
    x, scale, bias, ct = _inputs((2, 4, 4, 16), seed=6)
    xt, st, bt = _t(x, scale, bias, grad=True)
    (tgn.fused_group_norm(xt, st, bt, 4, relu=True) * torch.tensor(ct)).sum().backward()
    assert xt.grad is not None and tgn.LAUNCHES == dict.fromkeys(tgn.KERNELS, 0)


def test_validation_raises_as_the_reference_does():
    x = torch.zeros(2, 4, 4, 16)
    s = torch.ones(16)
    with pytest.raises(NotImplementedError, match="rank-4"):
        tgn.fused_group_norm(x[0], s, s, 4)
    with pytest.raises(ValueError, match="not divisible"):
        tgn.fused_group_norm(x, s, s, 5)
    with pytest.raises(NotImplementedError):
        tgn.reference_group_norm(x.reshape(2, 16, 16), s, s, 4)
