"""The port's jax.random-exact sampling against jax on the CPU.

``ops/jax_random`` rebuilds the threefry stream in torch integer ops:
keys, ``fold_in``, the partitionable 32-bit bits, the uniform and Gumbel
floats and the categorical draw must equal ``jax.random``'s bit for bit
(the Gumbel noise to 0 ulp, which needs XLA:CPU's own float32 log). Then
the per-row filters and ``sample_tokens`` must pick exactly the tokens the
reference picks, over rows that mix temperature, top_k and top_p, ties
included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfk8s_tpu.models import gpt as jgpt
from tfk8s_tpu_torch.models import gpt as tgpt
from tfk8s_tpu_torch.ops import jax_random as jr


def _pairs(n, seed):
    rng = np.random.default_rng(seed)
    seeds = rng.integers(-2 ** 31, 2 ** 31 - 1, n).astype(np.int32)
    seeds[:4] = [0, 1, -1, 2 ** 31 - 1]
    folds = rng.integers(0, 2 ** 31 - 1, n).astype(np.int32)
    folds[:4] = [0, 1023, 7, 2 ** 31 - 1]
    return seeds, folds


def _jax_keys(seeds, folds):
    return jax.vmap(
        lambda s, p: jax.random.key_data(jax.random.fold_in(jax.random.PRNGKey(s), p))
    )(seeds, folds)


def _port_keys(seeds, folds):
    return jr.fold_in(jr.prng_key(torch.from_numpy(seeds)), torch.from_numpy(folds))


def test_prng_key_matches_jax():
    seeds, _ = _pairs(512, 0)
    want = jax.vmap(lambda s: jax.random.key_data(jax.random.PRNGKey(s)))(seeds)
    assert np.array_equal(np.asarray(want).astype(np.int64), jr.prng_key(torch.from_numpy(seeds)).numpy())


def test_fold_in_matches_jax_over_many_seed_position_pairs():
    seeds, folds = _pairs(4096, 1)
    assert np.array_equal(np.asarray(_jax_keys(seeds, folds)).astype(np.int64),
                          _port_keys(seeds, folds).numpy())


@pytest.mark.parametrize("shape", [(1, 64), (1, 1001), (3, 5, 7)], ids=str)
def test_random_bits_match_jax(shape):
    seeds, folds = _pairs(64, 2)
    want = jax.vmap(lambda s, p: jax.random.bits(
        jax.random.fold_in(jax.random.PRNGKey(s), p), shape))(seeds, folds)
    got = jr.random_bits(_port_keys(seeds, folds), shape)
    assert got.shape == (64, *shape)
    assert np.array_equal(np.asarray(want).astype(np.int64), got.numpy())


def test_uniform_and_gumbel_match_jax_to_the_bit():
    seeds, folds = _pairs(256, 3)
    tiny = float(jnp.finfo(jnp.float32).tiny)
    keys = _port_keys(seeds, folds)

    def jax_draw(fn):
        return np.asarray(jax.vmap(lambda s, p: fn(jax.random.fold_in(jax.random.PRNGKey(s), p)))(
            seeds, folds))

    u_want = jax_draw(lambda k: jax.random.uniform(k, (1, 2048), minval=tiny, maxval=1.0))
    u_got = jr.uniform(keys, (1, 2048), minval=tiny, maxval=1.0).numpy()
    assert np.array_equal(u_want.view(np.int32), u_got.view(np.int32))
    g_want = jax_draw(lambda k: jax.random.gumbel(k, (1, 2048)))
    g_got = jr.gumbel(keys, (1, 2048)).numpy()
    assert g_got.dtype == np.float32
    assert np.array_equal(g_want.view(np.int32), g_got.view(np.int32))  # 0 ulp


def test_xla_cpu_log_matches_jax_log_to_the_bit():
    """Over normal floats from 1e-38 to 1e6 (the Gumbel draw takes the
    log of [tiny, 1) and of (0, 88])."""
    rng = np.random.default_rng(4)
    x = np.exp(rng.uniform(np.log(1.2e-38), np.log(1e6), 1 << 18)).astype(np.float32)
    x[:4] = [np.float32(1.1754944e-38), np.float32(1.0), np.float32(0.5), np.nextafter(np.float32(1), 0)]
    want = np.asarray(jax.jit(jnp.log)(x))
    got = jr.xla_cpu_log(torch.from_numpy(x)).numpy()
    assert np.array_equal(want.view(np.int32), got.view(np.int32))


def test_categorical_matches_jax():
    seeds, folds = _pairs(512, 5)
    logits = (np.random.default_rng(6).standard_normal((512, 300)) * 3).astype(np.float32)
    logits[::7, 10:200] = -np.inf  # filtered rows
    want = jax.vmap(lambda s, p, row: jax.random.categorical(
        jax.random.fold_in(jax.random.PRNGKey(s), p), row[None, :], axis=-1)[0])(
            seeds, folds, logits)
    got = jr.categorical(_port_keys(seeds, folds), torch.from_numpy(logits))
    assert np.array_equal(np.asarray(want), got.numpy())


def _logits(rows, vocab, seed, ties):
    rng = np.random.default_rng(seed)
    if ties:
        # integer-valued logits: many exact ties, at the top-k threshold too
        return rng.integers(-4, 5, (rows, vocab)).astype(np.float32)
    return (rng.standard_normal((rows, vocab)) * 2).astype(np.float32)


def _knobs(rows, seed):
    rng = np.random.default_rng(seed)
    temperature = rng.choice([0.0, 0.5, 0.8, 1.0, 1.7], rows).astype(np.float32)
    top_k = rng.choice([0, 1, 3, 10, 50], rows).astype(np.int32)
    top_p = rng.choice([1.0, 0.95, 0.8, 0.5, 0.1], rows).astype(np.float32)
    seeds = rng.integers(0, 2 ** 31 - 1, rows).astype(np.int32)
    folds = rng.integers(0, 1024, rows).astype(np.int32)
    return temperature, top_k, top_p, seeds, folds


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_filter_logits_rows_matches_reference(ties):
    logits = _logits(256, 97, 7, ties)
    _t, top_k, top_p, _s, _f = _knobs(256, 8)
    want = np.asarray(jgpt.filter_logits_rows(jnp.asarray(logits), jnp.asarray(top_k), jnp.asarray(top_p)))
    got = tgpt.filter_logits_rows(torch.from_numpy(logits), torch.from_numpy(top_k),
                                  torch.from_numpy(top_p)).numpy()
    assert np.array_equal(want, got)


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (5, 1.0), (0, 0.7), (8, 0.9), (1, 0.3)])
@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_filter_logits_matches_reference(top_k, top_p, ties):
    logits = _logits(64, 97, 9, ties)
    want = np.asarray(jgpt.filter_logits(jnp.asarray(logits), top_k=top_k, top_p=top_p))
    got = tgpt.filter_logits(torch.from_numpy(logits), top_k=top_k, top_p=top_p).numpy()
    assert np.array_equal(want, got)


@pytest.mark.parametrize("vocab", [64, 1000], ids=["v64", "v1000"])
@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_sample_tokens_picks_match_reference(vocab, ties):
    """Rows mixing greedy (temperature 0), temperature, top_k and top_p,
    each under its own seed and position fold: the same picks."""
    rows = 512
    logits = _logits(rows, vocab, 10 + vocab, ties)
    knobs = _knobs(rows, 11 + vocab)
    want = np.asarray(jax.jit(jgpt.sample_tokens)(jnp.asarray(logits), *map(jnp.asarray, knobs)))
    got = tgpt.sample_tokens(torch.from_numpy(logits), *map(torch.from_numpy, knobs))
    assert got.dtype == torch.int32
    assert np.array_equal(want, got.numpy())
    greedy = knobs[0] <= 0
    assert np.array_equal(got.numpy()[greedy], logits[greedy].argmax(-1))


def test_sample_packed_folds_each_column_at_its_position():
    rng = np.random.default_rng(12)
    logits = rng.standard_normal((4, 6, 80)).astype(np.float32)
    positions = np.array([0, 5, 17, 300], np.int32)
    samp_f = np.array([[0.0, 1.0], [0.8, 0.9], [1.1, 1.0], [0.6, 0.5]], np.float32)
    samp_i = np.array([[0, 0], [7, 3], [0, 99], [4, 12345]], np.int32)
    want = np.asarray(jgpt._sample_packed(jnp.asarray(logits), jnp.asarray(positions),
                                          (jnp.asarray(samp_f), jnp.asarray(samp_i))))
    got = tgpt._sample_packed(torch.from_numpy(logits), torch.from_numpy(positions),
                              (torch.from_numpy(samp_f), torch.from_numpy(samp_i)))
    assert np.array_equal(want, got.numpy())
