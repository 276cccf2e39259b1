"""Ring attention: exact attention over a sequence-sharded mesh axis, ported
from the JAX package's ``parallel/ring_attention.py``.

Each rank of the sequence group holds one Q/K/V block of the sequence; the
K/V blocks travel around the ring (:func:`collectives.ring_shift`, point-
to-point sends over the group, the reference's ``lax.ppermute``) while the
queries stay, and the softmax is accumulated online, so the result is the
full attention. One ``torch.autograd.Function`` holds the FlashAttention-2
recomputation scheme of the reference's ``custom_vjp``:

- forward: each held block is consumed in ``block_k``-wide chunks
  (:func:`_pick_bk`), so live scores are ``[lq, block_k]``; it saves only
  ``(q, k, v, out, lse)``;
- backward: a second ring pass recomputes the probabilities from ``lse``,
  accumulating dq locally while ``(k, v)`` and their ``(dk, dv)``
  accumulators rotate together; after the full ring each block's dk/dv
  has every rank's part and is back home.

A ``[b, lk]`` key mask rotates with its K/V block. Causal attention is
end-aligned for unequal lengths (query i sees keys ``j <= i + (Lk -
Lq)``, global positions), and a fully masked row gives finite gradients
(the reference's where-guard). A full ``[lq, lk]`` mask is refused: its
rows and columns are sharded differently. The arithmetic is float32
einsums, as the reference's; no Pallas kernel computes it there.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tfk8s_tpu_torch.parallel.collectives import group_rank, group_size, ring_shift
from tfk8s_tpu_torch.parallel.mesh import AXIS_SEQUENCE, Mesh

_NEG = -1e30

# inner chunk-width candidates; a block shorter than all of them (or that
# none divides) is consumed whole
_BLOCK_K_CANDIDATES = (512, 256, 128)


def _pick_bk(lk: int, block_k: Optional[int]) -> int:
    if block_k is not None:
        bk = min(block_k, lk)
        if lk % bk:
            # a non-dividing chunk would drop the trailing lk % bk keys
            raise ValueError(
                f"ring attention block_k={block_k} does not divide the "
                f"local K/V block length {lk}"
            )
        return bk
    return next((c for c in _BLOCK_K_CANDIDATES if lk % c == 0), lk)


def _chunk_scores(qf, q_pos, ks, mt_chunk, k_start, causal):
    """Scores of one key chunk and which entries are allowed (None: all)."""
    s = torch.einsum("bqhd,bkhd->bhqk", qf, ks)
    allowed = None
    if causal:
        k_pos = k_start + torch.arange(ks.shape[1], device=qf.device)
        allowed = (q_pos[:, None] >= k_pos[None, :])[None, None]
    if mt_chunk is not None:
        vm = mt_chunk[:, None, None, :] > 0
        allowed = vm if allowed is None else allowed & vm
    if allowed is not None:
        s = torch.where(allowed, s, torch.full_like(s, _NEG))
    return s, allowed


def _online_block(qf, q_pos, kt, vt, mt, src, bk, causal, m, l, o):
    """Fold one held K/V block into the online softmax, ``bk`` columns at a
    time. Carries: running max ``m`` and denominator ``l`` ``[b, h, lq]``,
    unnormalized output ``o`` ``[b, lq, h, d]``."""
    lk = kt.shape[1]
    for cb in range(lk // bk):
        cols = slice(cb * bk, (cb + 1) * bk)
        s, _ = _chunk_scores(qf, q_pos, kt[:, cols].float(),
                             None if mt is None else mt[:, cols],
                             src * lk + cb * bk, causal)
        m_new = torch.maximum(m, s.max(dim=-1).values)
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        o = o * corr.transpose(1, 2)[..., None] + torch.einsum(
            "bhqk,bkhd->bqhd", p, vt[:, cols].float())
        m = m_new
    return m, l, o


def _q_pos(q, k, ring, me):
    """Global query positions, end-aligned for unequal lengths."""
    lq, lk = q.shape[1], k.shape[1]
    return me * lq + torch.arange(lq, device=q.device) + ring * (lk - lq)


def _ring_fwd(q, k, v, mask, group, causal, block_k):
    ring, me = group_size(group), group_rank(group)
    b, lq, h, d = q.shape
    bk = _pick_bk(k.shape[1], block_k)
    qf = q.float()
    q_pos = _q_pos(q, k, ring, me)
    m = torch.full((b, h, lq), _NEG, device=q.device)
    l = torch.zeros((b, h, lq), device=q.device)
    o = torch.zeros((b, lq, h, d), device=q.device)
    blocks = [k, v] if mask is None else [k, v, mask]
    for t in range(ring):
        if t:
            # the held block moves on; the last one needs no send
            blocks = ring_shift(blocks, group)
        mt = blocks[2] if mask is not None else None
        m, l, o = _online_block(qf, q_pos, blocks[0], blocks[1], mt, (me - t) % ring,
                                bk, causal, m, l, o)
    # fully padded query rows keep the uniform-weight value the unsharded
    # softmax also gives; the loss masks them
    l_safe = torch.clamp_min(l, 1e-30)
    out = (o / l_safe.transpose(1, 2)[..., None]).to(q.dtype)
    return out, m + torch.log(l_safe)


def _block_grads(qf, q_pos, do, dvec, lse, kt, vt, mt, src, bk, causal):
    """dq of the held block, and the block's own (dk, dv)."""
    lk = kt.shape[1]
    dq = torch.zeros_like(qf)
    dks, dvs = [], []
    for cb in range(lk // bk):
        cols = slice(cb * bk, (cb + 1) * bk)
        ks, vs = kt[:, cols].float(), vt[:, cols].float()
        # masked before the exp: a raw score against a fully padded row's
        # lse (~ -1e30) would overflow
        s, allowed = _chunk_scores(qf, q_pos, ks, None if mt is None else mt[:, cols],
                                   src * lk + cb * bk, causal)
        p = torch.exp(s - lse[..., None])
        if mt is not None:
            # a row with no visible key has lse ~ _NEG, so its masked
            # entries would give 1/L: zero them exactly
            p = torch.where(allowed, p, torch.zeros_like(p))
        dvs.append(torch.einsum("bhqk,bqhd->bkhd", p, do))
        dp = torch.einsum("bqhd,bkhd->bhqk", do, vs)
        ds = p * (dp - dvec[..., None])
        dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, ks)
        dks.append(torch.einsum("bhqk,bqhd->bkhd", ds, qf))
    return dq, torch.cat(dks, dim=1), torch.cat(dvs, dim=1)


def _ring_bwd(q, k, v, mask, out, lse, g, group, causal, block_k):
    ring, me = group_size(group), group_rank(group)
    bk = _pick_bk(k.shape[1], block_k)
    qf, do = q.float(), g.float()
    q_pos = _q_pos(q, k, ring, me)
    dvec = (do * out.float()).sum(dim=-1).transpose(1, 2)  # D = rowsum(dO * O)
    dq = torch.zeros_like(qf)
    dk = torch.zeros(k.shape, device=k.device)
    dv = torch.zeros(v.shape, device=v.device)
    blocks = [k, v] if mask is None else [k, v, mask]
    for t in range(ring):
        if t:
            # dk/dv ride the same rotation as their k/v block
            blocks = ring_shift(blocks, group)
            dk, dv = ring_shift([dk, dv], group)
        mt = blocks[2] if mask is not None else None
        dq_c, dk_b, dv_b = _block_grads(qf, q_pos, do, dvec, lse, blocks[0], blocks[1], mt,
                                        (me - t) % ring, bk, causal)
        dq, dk, dv = dq + dq_c, dk + dk_b, dv + dv_b
    # the accumulators take their ring-th hop home
    dk, dv = ring_shift([dk, dv], group)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class RingAttention(torch.autograd.Function):
    """``(q, k, v, mask, group, causal, block_k) -> out``; ``mask`` is the
    local float 0/1 ``[b, lk]`` key block or None."""

    @staticmethod
    def forward(ctx, q, k, v, mask, group, causal, block_k):
        out, lse = _ring_fwd(q, k, v, mask, group, causal, block_k)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.args = (group, causal, block_k)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, out, lse = ctx.saved_tensors
        dq, dk, dv = _ring_bwd(q, k, v, mask, out, lse, g, *ctx.args)
        return dq, dk, dv, None, None, None, None


def sequence_group(mesh, seq_axis: str, what: str) -> Tuple[object, int]:
    """``(group, size)`` of the sequence axis a sequence-parallel attention
    runs over: ``(None, 1)`` for one process (a ring of one). A mesh of
    several ranks without that axis raises the reference's
    construction-time error."""
    if not isinstance(mesh, Mesh) or mesh.cfg.size() == 1:
        return None, 1
    if seq_axis not in mesh.axis_names:
        raise ValueError(
            f"{what} needs a {seq_axis!r} axis on the mesh; this mesh has "
            f"{tuple(mesh.axis_names)} — add sequence=N to the job's MeshSpec "
            f"(or drop the explicit pin)"
        )
    return mesh.group(seq_axis), mesh.size(seq_axis)


def make_ring_attn_fn(mesh=None, seq_axis: str = AXIS_SEQUENCE, block_k: Optional[int] = None):
    """An ``attn_fn(q, k, v, mask=None, causal=False)`` running ring
    attention over ``mesh``'s ``seq_axis`` group, on this rank's
    ``[b, L/n, h, d]`` blocks. ``mask`` is the local ``[b, L/n]`` key
    validity (bool or 0/1); ``block_k`` the inner chunk width (None: the
    largest of 512/256/128 dividing the local block). With one process
    (``mesh`` a device, None or a one-rank mesh) it is a ring of one."""
    group, _ = sequence_group(mesh, seq_axis, "ring attention")

    def attn_fn(q, k, v, mask=None, causal=False):
        if mask is not None and mask.dim() != 2:
            raise NotImplementedError(
                "ring attention: only 2-D [batch, key_len] key-padding masks "
                f"are supported; got mask.ndim={mask.dim()}"
            )
        mk = None if mask is None else mask.float()
        return RingAttention.apply(q, k, v, mk, group, causal, block_k)

    return attn_fn
