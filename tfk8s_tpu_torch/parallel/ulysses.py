"""Ulysses sequence parallelism, ported from the JAX package's
``parallel/ulysses.py``: one all-to-all trades the sequence split of
q/k/v (``[b, L/n, h, d]`` on each rank) for a head split (``[b, L, h/n,
d]``), the ``inner`` attention runs over the whole sequence with the
global causal and key masks, and a second all-to-all trades back. On a
mesh with a tensor axis the heads a rank holds are its tensor block
(``h/t``), so the inner attention sees ``h/(t n)``; that per-rank count
must divide by the sequence degree (beyond it the policy picks ring
attention). The ``[b, L/n]`` local key masks are gathered along the
sequence; a full ``[lq, lk]`` mask is refused.

``inner`` defaults to the reference's plain ``dot_product_attention``;
passing the port's ``flash_attention`` is the documented composition
(the reference's ``tests/test_ulysses.py``), which on the card launches
the flash kernels on the head-sliced, full-length blocks; the families'
attention policy (``models.transformer.select_attn_fn``) takes it there.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from tfk8s_tpu_torch.parallel.collectives import all_gather, all_to_all
from tfk8s_tpu_torch.parallel.mesh import AXIS_SEQUENCE, AXIS_TENSOR, Mesh
from tfk8s_tpu_torch.parallel.ring_attention import sequence_group


def make_ulysses_attn_fn(mesh=None, seq_axis: str = AXIS_SEQUENCE,
                         inner: Optional[Callable] = None):
    """An ``attn_fn(q, k, v, mask=None, causal=False)`` over ``mesh``'s
    ``seq_axis`` group, on this rank's ``[b, L/n, h/t, d]`` blocks. With
    one process there is nothing to exchange and it is ``inner`` itself."""
    if inner is None:
        from tfk8s_tpu_torch.models.transformer import dot_product_attention

        inner = dot_product_attention
    group, sp = sequence_group(mesh, seq_axis, "ulysses attention")
    tp = mesh.size(AXIS_TENSOR) if isinstance(mesh, Mesh) else 1

    def attn_fn(q, k, v, mask=None, causal=False):
        if mask is not None and mask.dim() != 2:
            raise NotImplementedError(
                "ulysses attention: only 2-D [batch, key_len] key-padding masks "
                f"are supported; got mask.ndim={mask.dim()}"
            )
        h_local = q.shape[2]  # this rank's tensor block of the heads
        if h_local % sp:
            raise ValueError(
                f"ulysses attention: per-device head count {h_local} "
                f"(= {h_local * tp} heads / tensor={tp}) is not divisible by "
                f"sequence={sp}; use ring attention beyond the head count "
                "(parallel/ring_attention.py)"
            )
        full_mask = None if mask is None else all_gather(
            mask.to(torch.uint8), 1, group).to(mask.dtype)
        # sequence-split -> head-split, attend, and back
        out = inner(all_to_all(q, 2, 1, group), all_to_all(k, 2, 1, group),
                    all_to_all(v, 2, 1, group), mask=full_mask, causal=causal)
        return all_to_all(out, 1, 2, group)

    attn_fn.inner = inner
    return attn_fn
