"""The port's flash attention against the JAX package's.

The same numpy inputs go through the JAX ``flash_attention`` (its Pallas
kernels in interpret mode, as ``tests/test_flash_attention.py`` runs them
on the CPU), the JAX ``dot_product_attention``, and the port's
``flash_attention``, which on CPU tensors runs the plain PyTorch versions
of its three CUDA kernels. float32 throughout: outputs agree to atol 1e-5
and gradients to atol 1e-4, the JAX package's own flash tolerances.

The kernels themselves run only on the card, in
``tests/test_torch_kernels_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfk8s_tpu.models.transformer import dot_product_attention as jax_dpa
from tfk8s_tpu.ops.flash_attention import (
    _flash_bwd_impl,
    _flash_fwd_impl,
    flash_attention as jax_flash,
)
from tfk8s_tpu_torch.models.transformer import dot_product_attention as torch_dpa
from tfk8s_tpu_torch.ops import flash_attention as tfa

OUT_ATOL, GRAD_ATOL = 1e-5, 1e-4
BLOCK = 16  # Pallas blocks for the interpret-mode reference


def _key_mask(lengths, lk, left=False):
    m = np.zeros((len(lengths), lk), bool)
    for i, n in enumerate(lengths):
        if left:
            m[i, lk - n:] = True
        else:
            m[i, :n] = True
    return m


# name -> (lq, lk, causal, mask or None)
CASES = {
    "self": (32, 32, False, None),
    "causal": (32, 32, True, None),
    "key_mask": (32, 32, False, _key_mask([32, 20], 32)),
    "causal_left_pad": (32, 32, True, _key_mask([24, 32], 32, left=True)),
    "causal_lq_lt_lk": (16, 32, True, None),
    "cross_key_mask": (16, 32, False, _key_mask([32, 24], 32)),
    "fully_masked_row": (32, 32, False, _key_mask([32, 0], 32)),
}
# cases where every query row sees at least one key: there the plain XLA
# attention is a reference too (it averages uniformly over a dead row)
NO_DEAD_ROWS = ("self", "causal", "key_mask", "causal_lq_lt_lk", "cross_key_mask")


def _inputs(lq, lk, b=2, h=2, d=8, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, lq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, lk, h, d)).astype(np.float32)
    v = rng.standard_normal((b, lk, h, d)).astype(np.float32)
    g = rng.standard_normal((b, lq, h, d)).astype(np.float32)
    return q, k, v, g


def _jax_out_and_grads(fn, q, k, v, g):
    out, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _torch_out_and_grads(fn, q, k, v, g):
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = fn(*ts)
    out.backward(torch.tensor(g))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _port(mask, causal):
    tm = None if mask is None else torch.tensor(mask)
    return lambda q, k, v: tfa.flash_attention(q, k, v, mask=tm, causal=causal)


@pytest.mark.parametrize("case", list(CASES))
def test_matches_jax_flash(case):
    lq, lk, causal, mask = CASES[case]
    q, k, v, g = _inputs(lq, lk)
    jm = None if mask is None else jnp.asarray(mask)
    want, want_g = _jax_out_and_grads(
        lambda q, k, v: jax_flash(
            q, k, v, mask=jm, causal=causal, block_q=BLOCK, block_k=BLOCK),
        q, k, v, g)
    got, got_g = _torch_out_and_grads(_port(mask, causal), q, k, v, g)
    np.testing.assert_allclose(got, want, atol=OUT_ATOL)
    for a, b in zip(got_g, want_g):
        np.testing.assert_allclose(a, b, atol=GRAD_ATOL)


@pytest.mark.parametrize("case", NO_DEAD_ROWS)
def test_matches_jax_dot_product_attention(case):
    lq, lk, causal, mask = CASES[case]
    q, k, v, g = _inputs(lq, lk, seed=1)
    jm = None if mask is None else jnp.asarray(mask)
    want, want_g = _jax_out_and_grads(
        lambda q, k, v: jax_dpa(q, k, v, mask=jm, causal=causal), q, k, v, g)
    got, got_g = _torch_out_and_grads(_port(mask, causal), q, k, v, g)
    np.testing.assert_allclose(got, want, atol=OUT_ATOL)
    for a, b in zip(got_g, want_g):
        np.testing.assert_allclose(a, b, atol=GRAD_ATOL)
    # the port's own plain attention is the same function
    tm = None if mask is None else torch.tensor(mask)
    plain = torch_dpa(*(torch.tensor(x) for x in (q, k, v)), mask=tm, causal=causal)
    np.testing.assert_allclose(plain.numpy(), want, atol=OUT_ATOL)


@pytest.mark.parametrize("case", ["causal", "causal_left_pad", "cross_key_mask"])
def test_each_kernel_function_matches_its_pallas_kernel(case):
    """Forward (o, lse), dq and dk/dv one by one, against the JAX
    package's ``_flash_fwd_impl``/``_flash_bwd_impl`` on the same o/lse:
    the plain versions that the card holds each backward kernel to."""
    lq, lk, causal, mask = CASES[case]
    q, k, v, g = _inputs(lq, lk, seed=2)
    b, _, h, _ = q.shape
    jq, jk, jv, jg = (jnp.asarray(x) for x in (q, k, v, g))
    jm = None if mask is None else jnp.asarray(mask)
    o_j, lse_j = _flash_fwd_impl(jq, jk, jv, jm, causal, BLOCK, BLOCK, True)
    dq_j, dk_j, dv_j = _flash_bwd_impl(
        jq, jk, jv, jm, o_j, lse_j, jg, causal, BLOCK, BLOCK, True)
    lse_j = np.asarray(lse_j)[..., 0].reshape(b, h, lq)

    tq, tk, tv, tg = (torch.tensor(x) for x in (q, k, v, g))
    tm = None if mask is None else torch.tensor(mask)
    o_t, lse_t = tfa.flash_fwd(tq, tk, tv, tm, causal)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=OUT_ATOL)
    live = lse_j > -1e29  # a dead row's lse is -1e30 on both sides
    np.testing.assert_array_equal(lse_t.numpy() > -1e29, live)
    np.testing.assert_allclose(lse_t.numpy()[live], lse_j[live], atol=OUT_ATOL)

    # the backward functions read the JAX forward's o and lse
    o_in = torch.tensor(np.asarray(o_j))
    lse_in = torch.tensor(np.where(live, lse_j, -1e30).astype(np.float32))
    dq_t = tfa.flash_bwd_dq_plain(tq, tk, tv, tg, o_in, lse_in, tm, causal)
    dk_t, dv_t = tfa.flash_bwd_dkv_plain(tq, tk, tv, tg, o_in, lse_in, tm, causal)
    for got, want in ((dq_t, dq_j), (dk_t, dk_j), (dv_t, dv_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=GRAD_ATOL)


@pytest.mark.parametrize("case", list(CASES))
def test_routed_backward_matches_the_pallas_backward(case):
    """``flash_bwd``, the backward that autograd runs (on the CPU its plain
    route, which recomputes the probabilities once for dq, dk and dv),
    against the JAX package's ``_flash_bwd_impl`` on the same o/lse."""
    lq, lk, causal, mask = CASES[case]
    q, k, v, g = _inputs(lq, lk, seed=6)
    b, _, h, _ = q.shape
    jq, jk, jv, jg = (jnp.asarray(x) for x in (q, k, v, g))
    jm = None if mask is None else jnp.asarray(mask)
    o_j, lse_j = _flash_fwd_impl(jq, jk, jv, jm, causal, BLOCK, BLOCK, True)
    want = _flash_bwd_impl(jq, jk, jv, jm, o_j, lse_j, jg, causal, BLOCK, BLOCK, True)
    lse_j = np.asarray(lse_j)[..., 0].reshape(b, h, lq)
    lse_in = torch.tensor(np.where(lse_j > -1e29, lse_j, -1e30).astype(np.float32))
    tm = None if mask is None else torch.tensor(mask)
    got = tfa.flash_bwd(*(torch.tensor(x) for x in (q, k, v, g)),
                        torch.tensor(np.asarray(o_j)), lse_in, tm, causal)
    assert len(got) == 3
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=GRAD_ATOL)


def test_fully_masked_row_gives_zero_output_and_grads():
    lq, lk, causal, mask = CASES["fully_masked_row"]
    q, k, v, g = _inputs(lq, lk, seed=3)
    out, (dq, dk, dv) = _torch_out_and_grads(_port(mask, causal), q, k, v, g)
    assert np.isfinite(out).all() and all(np.isfinite(x).all() for x in (dq, dk, dv))
    for x in (out, dq, dk, dv):
        np.testing.assert_array_equal(x[1], 0.0)


def test_contract_errors():
    q, k, v, _ = _inputs(32, 32)
    tq, tk, tv = (torch.tensor(x) for x in (q, k, v))
    with pytest.raises(NotImplementedError):
        tfa.flash_attention(tq, tk, tv, mask=torch.ones(2, 32, 32, dtype=torch.bool))
    with pytest.raises(ValueError, match="lq <= lk"):
        tfa.flash_attention(tq, tk[:, :16], tv[:, :16], causal=True)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfa.flash_fwd(tq.to("meta"), tk.to("meta"), tv.to("meta"))


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    q, k, v, g = _inputs(32, 32)
    tfa.reset_launches()
    _torch_out_and_grads(_port(None, True), q, k, v, g)
    assert tfa.LAUNCHES == dict.fromkeys(tfa.KERNELS, 0)


def test_lse_saved_only_when_a_backward_follows(monkeypatch):
    seen = []
    real = tfa.flash_fwd

    def spy(*args, **kwargs):
        seen.append(kwargs["save_lse"])
        return real(*args, **kwargs)

    monkeypatch.setattr(tfa, "flash_fwd", spy)
    q, k, v, g = _inputs(16, 16)
    tq, tk, tv = (torch.tensor(x) for x in (q, k, v))
    with torch.no_grad():
        tfa.flash_attention(tq, tk, tv, causal=True)
    _torch_out_and_grads(_port(None, True), q, k, v, g)
    assert seen == [False, True]


def test_auto_policy():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert tfa.auto_flash_attn_fn("flash", 16, cpu) is tfa.flash_attention
    assert tfa.auto_flash_attn_fn("full", 4096, cuda) is None
    assert tfa.auto_flash_attn_fn("auto", 1024, cuda) is tfa.flash_attention
    assert tfa.auto_flash_attn_fn("auto", 512, cuda) is None
    assert tfa.auto_flash_attn_fn("auto", 4096, cpu) is None
    with pytest.raises(ValueError, match="unknown attention_impl"):
        tfa.auto_flash_attn_fn("flsh", 1024, cuda)


def _bad_inputs(which):
    """Kernel inputs with one defect each (checked before any launch)."""
    q = torch.zeros(2, 16, 2, 64)
    k, v, mask = q.clone(), q.clone(), None
    lse = torch.zeros(2, 2, 16)
    if which == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif which == "head_dim":
        q, k, v = (torch.zeros(2, 16, 2, 48) for _ in range(3))
    elif which == "strides":
        q = torch.zeros(2, 2, 16, 64).transpose(1, 2)
    elif which == "kv_shape":
        v = torch.zeros(2, 8, 2, 64)
    elif which == "mask_shape":
        mask = torch.ones(2, 15, dtype=torch.bool)
    elif which == "lse_dtype":
        lse = lse.double()
    elif which == "misaligned":  # bf16 one element into its buffer: TMA refuses it
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
        q = torch.zeros(q.numel() + 1, dtype=torch.bfloat16)[1:].view(q.shape)
    return q, k, v, mask, lse


@pytest.mark.parametrize("which,error", [
    ("dtype", TypeError), ("head_dim", ValueError), ("strides", ValueError),
    ("kv_shape", ValueError), ("mask_shape", ValueError), ("lse_dtype", ValueError),
    ("misaligned", ValueError),
])
def test_kernel_wrappers_validate_before_launching(which, error):
    q, k, v, mask, lse = _bad_inputs(which)
    with pytest.raises(error):
        tfa._check_cuda(q, k, v, mask, do=q, o=q, lse=lse)


@pytest.mark.parametrize("lq", [5, 64, 100])
def test_dsum_plain_pads_rows_and_marks_the_dead_ones(lq):
    """The dk/dv pre-pass's function: D = rowsum(dO * O) and lse * log2(e)
    per (batch, head) row, padded to a multiple of 64; padding rows and
    fully masked rows (lse <= -1e29) get lse2 = +inf."""
    rng = np.random.default_rng(lq)
    b, h, d = 2, 3, 16
    do, o = (rng.standard_normal((b, lq, h, d)).astype(np.float32) for _ in range(2))
    lse = rng.standard_normal((b, h, lq)).astype(np.float32)
    lse[1, 2, 0] = -1e30
    dsum, lse2 = tfa.flash_bwd_dsum_plain(*(torch.tensor(x) for x in (do, o, lse)))
    lqp = -(-lq // 64) * 64
    assert dsum.shape == lse2.shape == (b * h, lqp)
    want = np.einsum("bqhd,bqhd->bhq", do, o).reshape(b * h, lq)
    np.testing.assert_allclose(dsum[:, :lq].numpy(), want, atol=1e-5)
    assert (dsum[:, lq:] == 0).all() and torch.isinf(lse2[:, lq:]).all()
    flat = lse.reshape(b * h, lq)
    live = flat > -1e29
    np.testing.assert_allclose(lse2[:, :lq].numpy()[live], flat[live] * np.log2(np.e), rtol=1e-6)
    assert torch.isinf(lse2[5, 0]) and lse2[5, 0] > 0
