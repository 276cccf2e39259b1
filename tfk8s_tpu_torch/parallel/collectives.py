"""The collectives the expert, sequence and tensor axes run, over one
process group each, with the autograd rules the model needs. They stand
where GSPMD and ``shard_map`` put ``psum``, ``all_to_all`` and
``ppermute`` in the JAX package.

- :func:`sum_over` / :func:`copy_over`: the conjugate pair of a region
  computed in parts by the ranks of a group (each expert rank's experts,
  each sequence rank's tokens). ``sum_over`` sums the parts in the forward
  and passes the gradient through, since what follows is the same on every
  rank; ``copy_over`` passes the input in and sums the parts' gradients on
  the way back.
- :func:`gather_along`: a sequence block gathered whole, for the MoE
  routing that queues tokens over the whole sequence;
- :func:`gather_whole`: a tensor split's column blocks gathered whole for
  a computation every rank then runs alike (DLRM's dense layers): the
  gradient of this rank's block is its block of the whole, replicated
  gradient;
- the vocab-parallel head of the tensor axis, each rank holding rows
  ``[lo, lo + n)`` of a table and so the matching columns of the logits:
  :func:`vocab_parallel_lookup` (ids outside the rows masked, looked up,
  summed over the group), :func:`vocab_parallel_cross_entropy` (a global
  max, a global sum of exponentials and the target's logit, one
  all-reduce each) and :func:`vocab_parallel_argmax` (ties to the lowest
  global index, as ``jnp.argmax``);
- :func:`all_to_all`: Ulysses' exchange of a sequence split for a head
  split, whose gradient is the exchange back.
- :func:`all_gather` and :func:`ring_shift` (no autograd): a key mask
  gathered along the sequence, and the ring's rotation of K/V blocks to
  the next rank;
- :func:`exchange` and :func:`broadcast_from` (no autograd): the
  pipeline's non-circular neighbour sends (a stage's output to the next
  stage and its input gradient to the previous one, the reference's
  ``ppermute`` with ``perm = [(i, i + 1)]``) and the last stage's outputs
  (the first stage's input gradient) given to every stage.

On the card, gloo takes CUDA tensors for ``all_reduce``, ``broadcast``
and ``all_gather`` but not for point-to-point sends, and some torch
releases' gloo has no all-to-all at all (``chip_smoke.py``'s parallel
phase probes each). Under gloo the all-to-all is pairwise sends, and the sends of CUDA
tensors go through host memory, on purpose and said once per kind in the
log and in :data:`HOST_STAGED`; NCCL runs them all on the card. Only the
transfer moves: the computation stays on the card.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Set

import torch
import torch.distributed as dist
import torch.nn.functional as F

from tfk8s_tpu_torch.utils.logging import get_logger

log = get_logger("collectives")

# the kinds of collective staged through host memory in this process
HOST_STAGED: Set[str] = set()


def _staged(kind: str, t: torch.Tensor, group) -> bool:
    """Whether ``kind`` on ``t`` goes through host memory: a CUDA tensor
    on a gloo group."""
    if not t.is_cuda or dist.get_backend(group) != "gloo":
        return False
    if kind not in HOST_STAGED:
        HOST_STAGED.add(kind)
        log.info("gloo: %s of CUDA tensors staged through host memory", kind)
    return True


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of ``t`` (a new contiguous tensor, as NCCL
    requires; ``t`` if no group)."""
    if group is None:
        return t
    out = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


def all_reduce_max(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max over ``group`` of ``t`` (no gradient)."""
    if group is None:
        return t
    out = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order."""
    if group is None:
        return t
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _all_to_all(t: torch.Tensor, split_dim: int, concat_dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    host = _staged("all_to_all", t, group)
    src = t.cpu() if host else t
    ins = [c.contiguous() for c in src.chunk(n, dim=split_dim)]
    outs = [torch.empty_like(c) for c in ins]
    if dist.get_backend(group) == "gloo":
        # gloo has no all-to-all in every torch release: pairwise sends
        me = dist.get_group_rank(group, dist.get_rank())
        outs[me] = ins[me]
        peers = [j for j in range(n) if j != me]
        ops = [dist.P2POp(dist.isend, ins[j], dist.get_global_rank(group, j), group)
               for j in peers]
        ops += [dist.P2POp(dist.irecv, outs[j], dist.get_global_rank(group, j), group)
                for j in peers]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    else:
        dist.all_to_all(outs, ins, group=group)
    return torch.cat(outs, dim=concat_dim).to(t.device)


def ring_shift(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """Send each tensor to the next rank of ``group`` and return the ones
    the previous rank sent (the reference's ``ppermute`` with ``perm =
    [(i, (i + 1) % n)]``)."""
    if group is None:
        return list(tensors)
    n, me = dist.get_world_size(group), dist.get_group_rank(group, dist.get_rank())
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    host = any(_staged("send/recv", t, group) for t in tensors)
    srcs = [(t.cpu() if host else t).contiguous() for t in tensors]
    outs = [torch.empty_like(t) for t in srcs]
    ops = [dist.P2POp(dist.isend, t, nxt, group) for t in srcs]
    ops += [dist.P2POp(dist.irecv, t, prv, group) for t in outs]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [o.to(t.device) for o, t in zip(outs, tensors)]


def exchange(send: Optional[torch.Tensor], dst: Optional[int], like: Optional[torch.Tensor],
             src: Optional[int], group) -> Optional[torch.Tensor]:
    """Send ``send`` to global rank ``dst`` and receive a tensor shaped and
    typed as ``like`` from global rank ``src``, posted as one
    ``batch_isend_irecv``; either half may be absent (None), and the
    received tensor is returned (None when nothing is received). Every
    send must meet its receive in the peer's call of the same turn."""
    ops, host = [], False
    for t in (send, like):
        host = host or (t is not None and _staged("send/recv", t, group))
    out = None
    if send is not None:
        ops.append(dist.P2POp(dist.isend, (send.cpu() if host else send).contiguous(), dst,
                              group))
    if like is not None:
        out = torch.empty(like.shape, dtype=like.dtype, device="cpu" if host else like.device)
        ops.append(dist.P2POp(dist.irecv, out, src, group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out.to(like.device) if out is not None else None


def broadcast_from(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """``t`` as global rank ``src`` of ``group`` holds it, on every rank
    (in place; ``t`` if no group)."""
    if group is not None:
        dist.broadcast(t, src=src, group=group)
    return t


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


class _SumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


class _GatherAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.size = dim, group, x.shape[dim]
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        me = dist.get_group_rank(ctx.group, dist.get_rank())
        part = all_reduce_sum(g, ctx.group).narrow(ctx.dim, me * ctx.size, ctx.size)
        return part.contiguous(), None, None


class _GatherWhole(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.size = dim, x.shape[dim]
        ctx.me = dist.get_group_rank(group, dist.get_rank())
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.me * ctx.size, ctx.size).contiguous(), None, None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group):
        ctx.dims, ctx.group = (split_dim, concat_dim), group
        return _all_to_all(x, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return _all_to_all(g, concat_dim, split_dim, ctx.group), None, None, None


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """Sum the ranks' parts of ``x`` over ``group``; the gradient passes
    through unchanged (what follows is computed alike on every rank)."""
    return x if group is None else _SumOver.apply(x, group)


def copy_over(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as is, entering a region each rank of ``group`` computes a
    part of: its gradient is the sum of the parts'."""
    return x if group is None else _CopyOver.apply(x, group)


def sum_replicated(x: torch.Tensor, group) -> torch.Tensor:
    """Sum the ranks' parts of ``x`` into a value that everything after it
    computes alike on every rank, each rank carrying ``1 / n`` of the
    gradient (:func:`scale_grad` at the objective): the parts' gradient
    is the sum over the ranks."""
    return x if group is None else _SumReplicated.apply(x, group)


def gather_along(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's block of ``x`` concatenated along ``dim``, for a region
    each rank of ``group`` then computes whole from its own block's
    gradient: this rank's block's gradient is the sum of every rank's."""
    return x if group is None else _GatherAlong.apply(x, dim, group)


def gather_whole(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's equal block of ``x`` concatenated along ``dim``, for a
    computation every rank of ``group`` then runs alike: the gradient
    that comes back is the same on every rank, and this rank's block of
    it is its block's gradient."""
    return x if group is None else _GatherWhole.apply(x, dim, group)


def vocab_parallel_lookup(weight: torch.Tensor, ids: torch.Tensor, lo: int,
                          group) -> torch.Tensor:
    """Rows ``ids`` of a table whose rows ``[lo, lo + len(weight))`` this
    rank holds: each rank looks up the ids it holds, zeros the others,
    and the group sums (each id is held by one rank, so the sum is
    exact). The gradient reaches only the rows looked up here."""
    if group is None:
        return F.embedding(ids, weight)
    local = ids.long() - lo
    inside = (local >= 0) & (local < weight.shape[0])
    rows = F.embedding(local.clamp(0, weight.shape[0] - 1), weight)
    return sum_over(rows.masked_fill(~inside[..., None], 0.0), group)


def _local_targets(target: torch.Tensor, lo: int, n: int):
    local = target.long() - lo
    inside = (local >= 0) & (local < n)
    return local.clamp(0, n - 1), inside


def vocab_parallel_cross_entropy(logits: torch.Tensor, target: torch.Tensor, lo: int,
                                 group) -> torch.Tensor:
    """The per-position softmax cross-entropy of float32 logits split by
    columns over ``group`` (this rank's are vocab ``[lo, lo + n)``): a
    global max, a global sum of exponentials and the target's logit, one
    all-reduce each. Its gradient is this rank's columns of ``softmax -
    one_hot``."""
    logits = logits.float()
    m = all_reduce_max(logits.detach().amax(dim=-1), group)
    shifted = logits - m[..., None]
    total = sum_over(shifted.exp().sum(dim=-1), group)
    local, inside = _local_targets(target, lo, logits.shape[-1])
    picked = shifted.gather(-1, local[..., None])[..., 0].masked_fill(~inside, 0.0)
    return total.log() - sum_over(picked, group)


def vocab_parallel_argmax(logits: torch.Tensor, lo: int, group) -> torch.Tensor:
    """The global argmax over logits split by columns over ``group``:
    each rank's first maximum, then the first rank holding the largest,
    so a tie goes to the lowest global index, as ``jnp.argmax``'s."""
    if group is None:
        return logits.argmax(dim=-1)
    value, index = logits.detach().max(dim=-1)
    values = all_gather(value[None].contiguous(), 0, group)
    indices = all_gather((index + lo)[None].contiguous(), 0, group)
    return indices.gather(0, values.argmax(dim=0, keepdim=True))[0]


def scale_grad(x: torch.Tensor, scale: float) -> torch.Tensor:
    """``x`` as is, its gradient times ``scale``."""
    return x if scale == 1 else _ScaleGrad.apply(x, scale)


def all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int, group) -> torch.Tensor:
    """Split ``x`` into ``n`` chunks along ``split_dim``, send chunk j to
    rank j, and concatenate what arrives along ``concat_dim`` (``tiled``
    ``lax.all_to_all``); differentiable."""
    return x if group is None else _AllToAll.apply(x, split_dim, concat_dim, group)


def group_size(group: Optional[object]) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group: Optional[object]) -> int:
    return 0 if group is None else dist.get_group_rank(group, dist.get_rank())
