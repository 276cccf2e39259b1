"""``jax.random``'s threefry stream in torch integer ops, so a request
sampled by the port draws the same tokens as the JAX package under the
same seed.

What is reproduced, bit for bit against jax 0.9.0 on the CPU (where
``jax_threefry_partitionable`` is True):

- :func:`threefry2x32`: the Threefry-2x32 hash, 20 rounds;
- :func:`prng_key`: ``jax.random.PRNGKey(seed)`` for an int32 seed, the
  pair ``(seed >> 32, seed & 0xFFFFFFFF)`` = ``(0, seed mod 2^32)``;
- :func:`fold_in`: ``threefry2x32(key, (0, data))``;
- :func:`random_bits`: the partitionable 32-bit draw over a shape, counts
  the uint64 iota of the flattened shape split into (hi, lo) words and
  the bits the XOR of the hash's two outputs;
- :func:`uniform`: the mantissa bits OR'd into 1.0, minus 1, scaled to
  ``[minval, maxval)`` and floored at ``minval``;
- :func:`gumbel` (``mode="low"``): ``-log(-log(u))`` with ``u`` uniform in
  ``[tiny, 1)``, where ``log`` is XLA:CPU's float32 log (the Cephes
  polynomial with its fused multiply-adds, :func:`xla_cpu_log`), not
  torch's, which differs from it in the last place for ~14% of inputs;
- :func:`categorical`: ``argmax(gumbel + logits)`` along the last axis,
  one key a row; :func:`categorical_shared` the same with one key for the
  whole batch, the noise drawn over the logits' full shape.

torch has no full uint32 arithmetic, so every word is an int64 tensor
held in ``[0, 2^32)``: additions are masked with ``& 0xFFFFFFFF`` and
rotations are built from shifts of the masked word. Keys are int64
tensors of shape ``[..., 2]`` and broadcast like any tensor, so one call
serves a batch of rows, each with its own key.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

# XLA:CPU's float32 log (Cephes logf) constants
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375
# the same, rounded to float32 (the values the float32 polynomial uses)
_LOG_P32 = [float(np.float32(c)) for c in _LOG_P]
_LOG_Q1_32 = float(np.float32(_LOG_Q1))
_SQRTHF = 0.707106781186547524
_F32_TINY = 1.1754943508222875e-38  # jnp.finfo(float32).tiny
_INV_EXP_MASK = 0x807FFFFF - 2 ** 32  # ~0x7F800000 as an int32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 of the count words ``(x1, x2)`` under the key
    ``(k1, k2)``; all int64 in ``[0, 2^32)``, broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [(x1 + ks[0]) & MASK32, (x2 + ks[1]) & MASK32]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & MASK32
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & MASK32
        x[1] = (x[1] + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x[0], x[1]


def prng_key(seed: torch.Tensor) -> torch.Tensor:
    """``jax.random.PRNGKey`` of int32 seeds: ``[..., 2]`` int64 keys."""
    seed = torch.as_tensor(seed).to(torch.int64)
    lo = seed & MASK32
    return torch.stack([torch.zeros_like(lo), lo], dim=-1)


def fold_in(key: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in``: the key hashed with the count ``(0, data)``
    (``data`` converted to uint32, so a negative int wraps)."""
    data = torch.as_tensor(data, device=key.device).to(torch.int64) & MASK32
    o1, o2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    return torch.stack([o1, o2], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Partitionable 32-bit random bits of ``shape`` for each key: keys
    ``[*batch, 2]`` give bits ``[*batch, *shape]`` (int64 in [0, 2^32))."""
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    flat = torch.arange(n, dtype=torch.int64, device=key.device)
    hi, lo = (flat >> 32).reshape(shape), (flat & MASK32).reshape(shape)
    lead = key.shape[:-1]
    expand = (slice(None),) * len(lead) + (None,) * len(shape)
    b1, b2 = threefry2x32(key[..., 0][expand], key[..., 1][expand], hi, lo)
    return b1 ^ b2


def _bits_to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    """float32 in [0, 1): the top 23 bits as the mantissa of a float in
    [1, 2), minus 1 (jax's construction)."""
    words = (bits >> 9) | 0x3F800000  # < 2^31: exact as int32
    return words.to(torch.int32).view(torch.float32) - 1.0


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32."""
    floats = _bits_to_unit_float(random_bits(key, shape))
    # the bounds and their difference rounded to float32, as jax does;
    # Python scalars keep the host from waiting on a copy to the card
    lo = float(np.float32(minval))
    span = float(np.float32(np.float32(maxval) - np.float32(minval)))
    return torch.clamp_min(floats * span + lo, lo)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 fused multiply-add: the product of two floats is exact in
    float64, so one float64 add and one rounding give a*b+c rounded once."""
    b = b.double() if isinstance(b, torch.Tensor) else float(b)
    c = c.double() if isinstance(c, torch.Tensor) else float(c)
    return (a.double() * b + c).float()


def xla_cpu_log(x: torch.Tensor) -> torch.Tensor:
    """float32 natural log as XLA:CPU computes it: the Cephes ``logf``
    polynomial XLA emits for ``log``, with the multiply-adds LLVM fuses
    there. Defined for finite positive ``x`` (all the Gumbel draw needs)."""
    t = torch.clamp_min(x.float(), _F32_TINY)  # the smallest normal float
    bits = t.view(torch.int32)
    e = (bits >> 23).float() - 127.0 + 1.0  # exponent field as (1 + e)
    # keep the sign and mantissa under the exponent of 0.5: t in [0.5, 1)
    t = ((bits & _INV_EXP_MASK) | 0x3F000000).view(torch.float32)
    small = t < _SQRTHF
    e = e - small.float()
    t = (t - 1.0) + torch.where(small, t, torch.zeros_like(t))
    x2 = t * t
    x3 = x2 * t
    p = _LOG_P32
    y = _fma(t, p[0], p[1])
    y1 = _fma(t, p[3], p[4])
    y2 = _fma(t, p[6], p[7])
    y = _fma(y, t, p[2])
    y1 = _fma(y1, t, p[5])
    y2 = _fma(y2, t, p[8])
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, _LOG_Q1_32 * e)
    t = _fma(x2, -0.5, t)
    t = t + y
    return _fma(e, _LOG_Q2, t)


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel`` (float32, ``mode="low"``)."""
    u = uniform(key, shape, minval=_F32_TINY, maxval=1.0)
    return -xla_cpu_log(-xla_cpu_log(u))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)`` for float32
    ``logits [*batch, n]`` and keys ``[*batch, 2]``: the Gumbel-max draw,
    first index on ties."""
    noise = gumbel(key, logits.shape[-1:])  # [*batch, n]
    return torch.argmax(noise + logits.float(), dim=-1)


def categorical_shared(key: torch.Tensor, logits: torch.Tensor,
                       rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)`` with ONE key ``[2]``
    for float32 ``logits [*batch, n]``: jax draws the Gumbel noise over the
    logits' whole shape from that key. ``rows = (first, total)``: the
    logits are rows ``[first, first + b)`` of a ``[total, n]`` batch (a
    data-parallel block), drawn with those rows of the whole batch's noise."""
    if rows is None:
        noise = gumbel(key, logits.shape)
    else:
        first, total = rows
        noise = gumbel(key, (total, *logits.shape[1:]))[first:first + logits.shape[0]]
    return torch.argmax(noise + logits.float(), dim=-1)
