"""Switch-style Mixture-of-Experts over the mesh's ``expert`` axis, ported
from the JAX package's ``parallel/moe.py`` with its exact formulation:

- the router runs in float32 (``x @ router``, a softmax over experts);
- each expert holds ``c = max(int(capacity_factor * top_k * s / e), 1)``
  slots per batch row; tokens queue for them in sequence order, top-2's
  second choices behind every first choice, and a token past capacity
  drops to the residual (its dispatch row is zero);
- dispatch and combine are float32 einsums against the capacity-bucketed
  one-hot; the expert FFN (``wi``, tanh gelu, ``wo``) runs in
  ``cfg.dtype``;
- the load-balancing loss is ``e * sum(importance * load)``, importance
  the mean router probability and load the share of first choices.

Expert parallelism follows what GSPMD makes of the reference's rules
(``expert`` shards ``wi``/``wo`` on dim 0; the batch is not split over
``expert``): each expert rank holds ``E / n`` experts and computes their
slots for all of its tokens, and the combine is summed over the expert
group (:func:`collectives.sum_over`). With the batch split over data (and
fsdp) ranks, importance and load are means over the GLOBAL batch, as
GSPMD computes them: summed over the batch group before their product.
On a sequence-sharded mesh the block gathers the sequence and runs whole
on every sequence rank, so capacities and queues count over the whole
sequence as in the reference. On a tensor mesh each expert's hidden
width is split as the reference's ``expert_mlp`` rule splits it: ``wi``
``[e_local, m, h/t]`` a column block and ``wo`` ``[e_local, h/t, m]`` a
row block, whose products are summed over the tensor group on the
float32 wire before the combine (``tensor_parallel.sum_blocks``, as a
row split's); the router, the dispatch and the combine stay whole on
every tensor rank. The routing is computed alike on every
rank; the tokens and router probabilities enter the per-rank part through
:func:`collectives.copy_over`, so everything before the block gets the
whole gradient on every rank, and each rank's ``wi``/``wo`` get their
experts' gradient. Dispatch and combine are plain einsums: no Pallas
kernel computes them in the reference either.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tfk8s_tpu_torch.parallel.collectives import (
    all_reduce_sum,
    copy_over,
    gather_along,
    group_rank,
    group_size,
    scale_grad,
    sum_over,
    sum_replicated,
)
from tfk8s_tpu_torch.parallel.mesh import AXIS_EXPERT, AXIS_SEQUENCE, BATCH_AXES, Mesh
from tfk8s_tpu_torch.parallel.tensor_parallel import Split, TensorShard, enter, sum_blocks


@dataclasses.dataclass(frozen=True)
class ExpertShard:
    """Where an MoE block sits on the mesh: it holds block ``index`` of
    ``size`` of the experts over the expert ``group``, its batch rows are
    one block of those over ``batch_group``, and its tokens one block of
    the sequence over ``seq_group`` (None: all of them)."""

    group: object
    index: int
    size: int
    batch_group: object = None
    seq_group: object = None

    @classmethod
    def of(cls, mesh) -> Optional["ExpertShard"]:
        """The place on a :class:`parallel.mesh.Mesh` (None for one
        process, or a device)."""
        if not isinstance(mesh, Mesh) or mesh.cfg.size() == 1:
            return None
        return cls(mesh.group(AXIS_EXPERT), mesh.index(AXIS_EXPERT), mesh.size(AXIS_EXPERT),
                   mesh.group(*BATCH_AXES), mesh.group(AXIS_SEQUENCE))


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.nn.one_hot`` in float32: an index outside ``[0, n)`` gives a
    zero row."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _dispatch_mask(onehot: torch.Tensor, pos: torch.Tensor, capacity: int) -> torch.Tensor:
    """``[g,s,e]`` one-hot + queue positions -> ``[g,s,e,c]`` dispatch mask;
    slots beyond capacity fall out."""
    pos_sel = (pos * onehot).sum(-1)  # [g, s] slot of the token
    slot = _one_hot(pos_sel.to(torch.int32), capacity)
    return onehot[..., None] * slot[:, :, None, :]


def compute_dispatch(probs: torch.Tensor, top_k: int, capacity: int) -> torch.Tensor:
    """``[g,s,e]`` router probabilities -> the gate-weighted ``[g,s,e,c]``
    dispatch tensor: top-1 keeps the raw argmax gate; top-2 normalizes the
    chosen pair's gates to sum to 1 and queues second choices behind all
    first choices. ``argmax`` takes the first maximum, as ``jnp.argmax``."""
    e = probs.shape[-1]
    gate1 = probs.max(dim=-1).values
    onehot1 = _one_hot(probs.argmax(dim=-1), e)
    if top_k == 2:
        probs2 = probs * (1.0 - onehot1)
        gate2 = probs2.max(dim=-1).values
        onehot2 = _one_hot(probs2.argmax(dim=-1), e)
        denom = torch.clamp_min(gate1 + gate2, 1e-9)
        gate1n, gate2n = gate1 / denom, gate2 / denom
    else:
        gate1n = gate1
    pos1 = torch.cumsum(onehot1, dim=1) * onehot1 - 1.0
    dispatch = _dispatch_mask(onehot1, pos1, capacity) * gate1n[:, :, None, None]
    if top_k == 2:
        load1 = onehot1.sum(dim=1, keepdim=True)
        pos2 = (torch.cumsum(onehot2, dim=1) + load1) * onehot2 - 1.0
        dispatch = dispatch + _dispatch_mask(onehot2, pos2, capacity) * gate2n[:, :, None, None]
    return dispatch


class SwitchMoeBlock(nn.Module):
    """Drop-in for ``transformer.MlpBlock`` with ``num_experts`` experts:
    ``x [g, s, m]`` -> ``(y [g, s, m] in cfg.dtype, aux)``. Callers add
    ``moe_aux_weight * aux`` to the objective. With an :class:`ExpertShard`
    the block holds its rank's experts only (``wi``/``wo`` of ``E / n``
    rows, :attr:`expert_range` of the whole, listed in ``expert_splits``);
    with ``tp`` its block of each expert's hidden width (``tensor_splits``)."""

    def __init__(self, cfg, num_experts: int = 8, capacity_factor: float = 1.25,
                 top_k: int = 1, experts: Optional[ExpertShard] = None,
                 tp: Optional[TensorShard] = None):
        super().__init__()
        if top_k not in (1, 2):
            raise ValueError(f"top_k must be 1 or 2, got {top_k}")
        n = experts.size if experts is not None else 1
        if num_experts % n:
            raise ValueError(f"num_experts={num_experts} does not divide over expert={n}")
        self.cfg, self.num_experts = cfg, num_experts
        self.capacity_factor, self.top_k, self.experts, self.tp = (capacity_factor, top_k,
                                                                   experts, tp)
        local = num_experts // n
        lo = (experts.index if experts is not None else 0) * local
        self.expert_range = (lo, lo + local)
        m, h = cfg.embed_dim, cfg.mlp_dim
        h_lo, h_hi = (0, h) if tp is None else tp.block(h, "mlp_dim")
        self.router = nn.Parameter(torch.empty(m, num_experts))
        self.wi = nn.Parameter(torch.empty(local, m, h_hi - h_lo))
        self.wo = nn.Parameter(torch.empty(local, h_hi - h_lo, m))
        if n > 1:
            self.expert_splits = {w: Split(0, lo, lo + local, num_experts) for w in ("wi", "wo")}
        if tp is not None:
            self.tensor_splits = {"wi": Split(2, h_lo, h_hi, h), "wo": Split(1, h_lo, h_hi, h)}

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The reference's initializers, drawn for ALL experts and sliced to
        this rank's (so every layout starts from the same parameters):
        normal(0.02) router; ``variance_scaling(1, fan_in,
        truncated_normal)`` for ``wi`` [e, m, h] and ``wo`` [e, h, m] (fan
        in = e x the contracted dim). A block of a tensor mesh is cut from
        the whole block's draws (``tensor_parallel.init_sharded``), not
        drawn here."""
        e, lo, hi = self.num_experts, *self.expert_range
        self.router.copy_(torch.empty_like(self.router).normal_(0.0, 0.02, generator=generator))
        for w in (self.wi, self.wo):
            full = torch.empty((e, *w.shape[1:]), dtype=w.dtype, device=w.device)
            std = math.sqrt(1.0 / (e * w.shape[1])) / 0.87962566103423978
            nn.init.trunc_normal_(full, 0.0, std, -2 * std, 2 * std, generator=generator)
            w.copy_(full[lo:hi])

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        seq_group = self.experts.seq_group if self.experts is not None else None
        if seq_group is None:
            return self._route_and_run(x)
        # on a sequence-sharded mesh the tokens queue over the whole
        # sequence: gather it, run the block whole on every sequence rank
        # and keep this rank's block; each rank's aux carries 1 / n of the
        # gradient, the parts of the rest sum over the sequence group
        n, blk = group_size(seq_group), x.shape[1]
        y, aux = self._route_and_run(gather_along(x, 1, seq_group))
        lo = group_rank(seq_group) * blk
        return y[:, lo:lo + blk], scale_grad(aux, 1.0 / n)

    def _route_and_run(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        dt = self.cfg.dtype
        g, s, m = x.shape
        e, k = self.num_experts, self.top_k
        c = max(int(self.capacity_factor * k * s / e), 1)
        group = self.experts.group if self.experts is not None else None
        batch_group = self.experts.batch_group if self.experts is not None else None
        lo, hi = self.expert_range

        # routing in float32, alike on every expert rank
        logits = torch.einsum("gsm,me->gse", x.float(), self.router)
        probs = torch.softmax(logits, dim=-1)
        dispatch = compute_dispatch(copy_over(probs, group), k, c)[:, :, lo:hi]

        # dispatch -> this rank's experts (its block of their hidden width
        # on a tensor mesh, the blocks' products summed) -> combine, summed
        # over the expert group
        route = (dispatch > 0).float()
        xe = torch.einsum("gsec,gsm->gecm", route, copy_over(enter(x, self.tp), group).float())
        hmid = F.gelu(torch.einsum("gecm,emh->gech", xe.to(dt), self.wi.to(dt)),
                      approximate="tanh")
        ye = sum_blocks(torch.einsum("gech,ehm->gecm", hmid, self.wo.to(dt)), self.tp)
        y = sum_over(torch.einsum("gsec,gecm->gsm", dispatch, ye.float()), group)

        # switch load-balance loss over first choices, global-batch means:
        # every data rank holds the product, and carries its rows' part of
        # the gradient with the weight the data average takes away
        onehot1 = _one_hot(probs.argmax(dim=-1), e)
        nb = group_size(batch_group)
        importance = sum_replicated(probs.mean(dim=(0, 1)), batch_group) / nb
        load = all_reduce_sum(onehot1.mean(dim=(0, 1)), batch_group) / nb
        aux = e * (importance * load).sum()
        return y.to(dt), aux
