"""The job's parallel layout over the mesh, in place of the JAX package's
``parallel/sharding.py`` rules: ``batch`` over data+fsdp, parameters
sharded over fsdp, MoE experts over ``expert``, the sequence over
``sequence``, and heads, MLP widths (the MoE's ``expert_mlp`` too) and
vocabularies over ``tensor``, and the pipelined family's stages over
``pipeline``, in any combination (``parallel/mesh.py``).

- ``data`` alone: ``DistributedDataParallel``; under gradient
  accumulation every microbatch but the last runs in ``no_sync``.
- ``fsdp`` (with or without ``data``): FSDP2 ``fully_shard`` over the
  fsdp axis, and HSDP (replicated over data, sharded over fsdp) when both
  axes are above 1. FSDP2 shards each parameter on dim 0, not by the
  reference's logical rules; the numbers do not depend on the layout.
- any model axis (mode "mesh"): one bucketed all-reduce of the gradients
  after the step's backward, by one rule. Every gradient is averaged over
  the batch axes and summed over ``sequence`` (a sequence rank holds its
  tokens' part of its rows' gradient); over ``tensor``, ``expert`` and
  ``pipeline`` a parameter is either split (each rank holds its own
  block, expert shard or stage, and its own block's gradient) or
  computed alike on every rank (layer norms, routers, a row split's
  bias, the pipelined family's head), so nothing is reduced over them.
  The rule holds stage by stage: a stage's ranks over data, fsdp and
  sequence lie within the stage, and the group reduces their gradients
  of the stage's parameters.
  With an fsdp axis beside the model axes each parameter the rank holds
  (its tensor block, its expert share) is split on dim 0 over the fsdp
  group by :class:`FsdpShards`, the port's own: the optimizer and its
  moments hold the rank's rows only; a step's first forward gathers the
  whole blocks in one all-gather, and the reduction after the backward,
  one all-reduce of the blocks' gradients over data x fsdp x sequence,
  keeps the rank's rows. Not FSDP2 here: FSDP2 over a gloo group of CUDA
  tensors ends its processes with a segmentation fault on the card's
  torch (2.11), where ranks sharing one card must use gloo, while gloo's
  all-gather and all-reduce of CUDA tensors work. For the same reason an
  fsdp or HSDP layout on the batch axes alone takes :class:`FsdpShards`
  (mode "mesh") where its ranks share a card over gloo; FSDP2 where each
  rank has a card of its own (NCCL) and on the CPU.

The gradient norm follows the same rule: each rank's squares of its
local gradients (an fsdp shard of a tensor block of an expert's share,
say) divided by the number of ranks holding the same values, summed over
every rank, so a split parameter counts each of its blocks and a
replicated one counts once.

Each rank holds a contiguous block of the global batch (``local_rows``,
by its place on the data and fsdp axes), computes its local mean loss (a
global mean for the masked token losses, whose gradient is scaled so
that the average over the batch axes is the global one), and the
gradient reduction averages over the blocks, so the update is the global
batch's. Metrics, alike over the model axes, are averaged over the batch
axes only where a caller asks (``reduce_metrics``, at log boundaries),
so steps between them read nothing back from the device.

Checkpoints hold whole parameters: an expert shard's ``wi``/``wo``, a
tensor split's blocks and an fsdp shard, and their AdamW moments, are
gathered to save (``state_dicts``: over the fsdp, then the expert and
tensor groups), and each rank takes its slice of them to restore
(``load_full_state_dicts``); the stages' layers, named
by their global index, are gathered over the pipeline group and each
rank takes its own. So any layout resumes any other.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Optional, Set, Union

import torch
import torch.distributed as dist
from torch import nn

from tfk8s_tpu_torch.parallel.collectives import all_gather
from tfk8s_tpu_torch.parallel.mesh import (
    AXIS_DATA,
    AXIS_EXPERT,
    AXIS_FSDP,
    AXIS_PIPELINE,
    AXIS_SEQUENCE,
    AXIS_TENSOR,
    BATCH_AXES,
    Mesh,
    MeshConfig,
    build_mesh,
)
from tfk8s_tpu_torch.parallel.pipeline import stage_params
from tfk8s_tpu_torch.parallel.tensor_parallel import (
    Split,
    TensorShard,
    gather_tensor,
    named_splits,
    shard_tensor,
    tensor_splits,
)


class FsdpShards(nn.Module):
    """``module`` with each parameter split on dim 0 over the fsdp
    ``group`` (block ``index`` of ``size``; rows split as evenly as they
    go): its parameters are the rank's rows, under the module's own names,
    and what the optimizer steps. A forward first gathers the whole
    parameters into leaf tensors (once a step: every microbatch of it
    reuses them) and runs ``module`` on them; :meth:`reduce` then reduces
    their gradients and hands each parameter its rows'."""

    def __init__(self, module: nn.Module, group, index: int, size: int):
        super().__init__()
        self.module, self.group, self.size = module, group, size
        self.splits: Dict[str, Split] = {}
        for name, p in list(module.named_parameters()):
            lo, hi = TensorShard(None, index, size).rows(p.shape[0])
            self.splits[name] = Split(0, lo, hi, p.shape[0])
            owner, _, leaf = name.rpartition(".")
            setattr(module.get_submodule(owner), leaf,
                    nn.Parameter(p.detach()[lo:hi].clone(), requires_grad=p.requires_grad))
        self.whole: Optional[Dict[str, torch.Tensor]] = None

    def _gather(self) -> Dict[str, torch.Tensor]:
        """Every parameter whole, in one all-gather of the ranks' rows
        (each padded to the widest rank's)."""
        params = dict(self.module.named_parameters())
        widest = {n: -(-s.full // self.size) for n, s in self.splits.items()}
        parts = []
        for n, p in params.items():
            pad = widest[n] - p.shape[0]
            parts.append(torch.cat([p.detach(), p.new_zeros((pad, *p.shape[1:]))]).reshape(-1)
                         if pad else p.detach().reshape(-1))
        flat = all_gather(torch.cat(parts)[None], 0, self.group)  # [size, rows]
        whole, offset = {}, 0
        for n, p in params.items():
            rows, tail = widest[n], p.shape[1:]
            block = flat[:, offset:offset + rows * math.prod(tail)].reshape(self.size, rows, *tail)
            offset += block[0].numel()
            sizes = [TensorShard(None, r, self.size).rows(self.splits[n].full) for r in
                     range(self.size)]
            t = torch.cat([block[r, :hi - lo] for r, (lo, hi) in enumerate(sizes)])
            whole[n] = t.requires_grad_(p.requires_grad)
        return whole

    def forward(self, *args, **kwargs):
        from torch.func import functional_call

        if self.whole is None:
            self.whole = self._gather()
        return functional_call(self.module, self.whole, args, kwargs)

    def reduce(self, group, divisor: int) -> None:
        """Sum the whole parameters' gradients over ``group`` (one
        all-reduce), divide by ``divisor`` and give each parameter its
        rows; the gathered parameters are freed until the next forward."""
        whole, self.whole = self.whole, None
        if whole is None:
            return
        grads = [whole[n].grad if whole[n].grad is not None else torch.zeros_like(whole[n])
                 for n in self.splits]
        flat = torch.cat([g.reshape(-1) for g in grads])
        if group is not None:
            dist.all_reduce(flat, group=group)
        flat /= divisor
        offset = 0
        for (n, split), g in zip(self.splits.items(), grads):
            part = flat[offset:offset + g.numel()].view_as(g)
            offset += g.numel()
            p = self.module.get_parameter(n)
            p.grad = part[split.lo:split.hi].clone()


class DataParallel:
    """The job's parallel layout, for one rank. ``mode`` is "none" (one
    process), "ddp", "fsdp", "hsdp" or "mesh" (expert, sequence, tensor or
    pipeline axes). ``layout`` is the job's ``MeshConfig`` (None: data over every
    rank) or an already built :class:`Mesh`."""

    def __init__(self, layout: Union[MeshConfig, Mesh, None], device: torch.device):
        self.device = torch.device(device)
        self.layout = layout if isinstance(layout, Mesh) else build_mesh(layout, self.device)
        self.cfg = self.layout.cfg
        self.mesh = self.layout.device_mesh
        self.world = self.layout.cfg.size()
        self.rank = self.layout.rank
        # this rank's block of the global batch, of batch_world blocks
        self.batch_rank, self.batch_world = self.layout.batch_index, self.layout.batch_size
        self.seq_index, self.seq_size = (self.layout.index(AXIS_SEQUENCE),
                                         self.layout.size(AXIS_SEQUENCE))
        # name -> Split: the expert rows each expert-sharded parameter holds,
        # and the block each tensor-split parameter holds
        self.expert_params: Dict[str, Split] = {}
        self.tensor_params: Dict[str, Split] = {}
        # the names of this rank's pipeline-stage parameters
        self.stage_params: Set[str] = set()
        self.tp = TensorShard.of(self.layout)
        data, fsdp = self.cfg.axis_size(AXIS_DATA), self.cfg.axis_size(AXIS_FSDP)
        # every parameter is split on dim 0 over the fsdp axis (FSDP2, or
        # FsdpShards beside a model axis)
        self.fsdp = fsdp
        if self.world == 1:
            self.mode = "none"
        elif self.layout.size(AXIS_EXPERT, AXIS_SEQUENCE, AXIS_TENSOR, AXIS_PIPELINE) > 1:
            self.mode = "mesh"
        elif fsdp == 1:
            self.mode = "ddp"
        elif self.device.type == "cuda" and dist.get_backend() == "gloo":
            # ranks sharing a card: FSDP2 over gloo ends them with a
            # segmentation fault there, FsdpShards holds the same numbers
            self.mode = "mesh"
        else:
            self.mode = "hsdp" if data > 1 else "fsdp"

    @property
    def sharded(self) -> bool:
        """Whether each rank checkpoints its own shards (FSDP2 on the batch
        axes alone); mode "mesh" gathers whole state to save."""
        return self.mode in ("fsdp", "hsdp")

    def local_rows(self, batch_size: int) -> int:
        if batch_size % self.batch_world:
            raise ValueError(
                f"batch_size={batch_size} does not divide over {self.batch_world} ranks"
            )
        return batch_size // self.batch_world

    def wrap(self, model: nn.Module) -> nn.Module:
        """The model as the step runs it (the optimizer must be built over
        the wrapped parameters)."""
        self.expert_params = named_splits(model, "expert_splits")
        self.tensor_params = tensor_splits(model)
        self.stage_params = stage_params(model)
        if self.tp is not None and not self.tensor_params:
            raise ValueError(
                "a tensor mesh needs a model built over it (the family's "
                "task_for_mesh); this one holds no tensor blocks"
            )
        if self.mode == "ddp":
            ids = [self.device.index] if self.device.type == "cuda" else None
            return nn.parallel.DistributedDataParallel(model, device_ids=ids)
        if self.mode == "mesh" and self.fsdp > 1:
            return FsdpShards(model, self.layout.group(AXIS_FSDP), self.layout.index(AXIS_FSDP),
                              self.fsdp)
        if self.sharded:
            from torch.distributed.fsdp import fully_shard

            mesh = self.mesh if self.mode == "hsdp" else self.mesh[AXIS_FSDP]
            return fully_shard(model, mesh=mesh)
        return model

    def reduce_gradients(self, model: nn.Module) -> None:
        """Mode "mesh": average the step's gradients over the batch axes
        and sum them over the sequence axis, in one all-reduce over the
        data x fsdp x sequence group; a no-op in the other modes, whose
        wrappers reduce."""
        if self.mode != "mesh":
            return
        group = self.layout.group(AXIS_DATA, AXIS_FSDP, AXIS_SEQUENCE)
        if isinstance(model, FsdpShards):
            model.reduce(group, self.batch_world)
            return
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        if not grads or group is None:
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        flat /= self.batch_world
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()

    @contextlib.contextmanager
    def no_sync(self, model: nn.Module, last: bool) -> Iterator[None]:
        """Skip the gradient all-reduce for a microbatch that is not the
        step's last (mode "mesh" reduces after the last one anyway)."""
        if last or self.mode in ("none", "mesh"):
            yield
        elif self.mode == "ddp":
            with model.no_sync():
                yield
        else:
            model.set_requires_gradient_sync(False)
            try:
                yield
            finally:
                model.set_requires_gradient_sync(True)

    def _replicas(self, name: str) -> int:
        """The ranks holding the same values of parameter ``name``: the
        world over the axes it is split on (fsdp for every parameter; its
        tensor block, expert shard, pipeline stage)."""
        split = self.fsdp
        for axis, names in ((AXIS_TENSOR, self.tensor_params),
                            (AXIS_EXPERT, self.expert_params),
                            (AXIS_PIPELINE, self.stage_params)):
            if name in names:
                split *= self.layout.size(axis)
        return self.world // split

    def grad_norm(self, model: nn.Module) -> torch.Tensor:
        """The global L2 norm of the (already reduced) gradients: each
        rank's squares over the ranks holding the same values, summed over
        every rank."""
        sq = [_local(p.grad).float().square().sum() / self._replicas(name)
              for name, p in _inner(model).named_parameters() if p.grad is not None]
        total = torch.stack(sq).sum() if sq else torch.zeros((), device=self.device)
        if self.world > 1:
            dist.all_reduce(total)
        return total.sqrt()

    def reduce_metrics(self, values: torch.Tensor, keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Mean over the batch axes of a stacked metrics vector (each
        rank's local means over equal row counts average to the global
        batch's; the model axes' ranks hold the same values); entries
        where ``keep`` is True are left as they are."""
        group = self.layout.group(*BATCH_AXES)
        if group is None:
            return values
        total = values.clone()
        dist.all_reduce(total, group=group)
        mean = total / self.batch_world
        return torch.where(keep, values, mean) if keep is not None else mean

    def _gathers(self, model: nn.Module) -> List[tuple]:
        """``(axis, splits)`` in the order a whole tensor is put together
        from the blocks: the fsdp rows (:class:`FsdpShards`), the expert
        shards, the tensor blocks."""
        fsdp = model.splits if isinstance(model, FsdpShards) else {}
        return [(AXIS_FSDP, fsdp), (AXIS_EXPERT, self.expert_params),
                (AXIS_TENSOR, self.tensor_params)]

    def whole_grads(self, model: nn.Module) -> Dict[str, torch.Tensor]:
        """Every parameter's whole gradient by name, on every rank (zeros
        for a parameter without one): the fsdp shards, expert shards and
        tensor blocks gathered, then every stage's over the pipeline group,
        in the whole model's order. Collective: every rank calls it."""
        out = {}
        for name, p in _inner(model).named_parameters():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            if hasattr(g, "full_tensor"):
                g = g.full_tensor()
            for axis, splits in self._gathers(model):
                group = self.layout.group(axis)
                if group is not None and name in splits:
                    g = gather_tensor(g, splits[name], group, self.layout.size(axis))
            out[name] = g.detach()
        group = self.layout.group(AXIS_PIPELINE)
        if group is None or not self.stage_params:
            return out
        # the stages in order, where this rank's stage stands among the rest
        parts: List[Optional[tuple]] = [None] * dist.get_world_size(group)
        mine = {n: g.cpu() for n, g in out.items() if n in self.stage_params}
        dist.all_gather_object(parts, (self.layout.index(AXIS_PIPELINE), mine), group=group)
        names = list(out)
        first = next(i for i, n in enumerate(names) if n in self.stage_params)
        whole = {n: out[n] for n in names[:first]}
        for _, stage in sorted(parts, key=lambda part: part[0]):
            whole.update({n: g.to(self.device) for n, g in stage.items()})
        whole.update({n: out[n] for n in names[first + len(mine):]})
        return whole


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if hasattr(t, "to_local") else t


def _inner(model: nn.Module) -> nn.Module:
    """The model DDP or :class:`FsdpShards` wraps, whose parameters are
    the wrapper's under the model's own names; else ``model``."""
    wrapped = isinstance(model, (nn.parallel.DistributedDataParallel, FsdpShards))
    return model.module if wrapped else model


def _param_tensors(sd: Dict[str, dict], names) -> List[tuple]:
    """``(container, key, name)`` of every tensor of the parameters
    ``names``: the model entry and its optimizer moments."""
    out = [(sd["model"], n, n) for n in names if n in sd["model"]]
    for n in names:
        st = sd["optimizer"]["state"].get(n, {})
        out += [(st, k, n) for k, v in st.items() if k != "step" and torch.is_tensor(v)]
    return out


def state_dicts(model: nn.Module, optimizer: torch.optim.Optimizer,
                parallel: Optional[DataParallel] = None) -> Dict[str, dict]:
    """Model and optimizer state keyed by parameter name, the same for a
    plain, DDP or FSDP2 model (DTensor shards under FSDP2). In mode "mesh"
    (``parallel``) whole tensors: :class:`FsdpShards`' rows gathered over
    the fsdp group, expert shards over the expert group into whole
    ``[num_experts, ...]`` tensors, tensor blocks over the tensor group,
    the parameters and their moments alike; with pipeline stages, every
    stage's layers over the pipeline group."""
    from torch.distributed.checkpoint.state_dict import get_state_dict

    fresh = not optimizer.state
    msd, osd = get_state_dict(_inner(model), optimizer)
    if fresh:
        # get_state_dict fills an untouched optimizer's state with a
        # zero-lr step; save what the untouched one means (count 0, zero
        # moments) and leave the live optimizer untouched
        for st in osd["state"].values():
            st["step"] = torch.zeros_like(st["step"])
        optimizer.state.clear()
    sd = {"model": msd, "optimizer": osd}
    if parallel is None or parallel.mode != "mesh":
        return sd
    # the state dicts hold the live optimizer's per-parameter dicts
    sd["optimizer"] = {**osd, "state": {k: dict(v) for k, v in osd["state"].items()}}
    for axis, splits in parallel._gathers(model):
        group = parallel.layout.group(axis)
        for box, key, name in _param_tensors(sd, splits if group is not None else {}):
            box[key] = gather_tensor(box[key], splits[name], group, parallel.layout.size(axis))
    group = parallel.layout.group(AXIS_PIPELINE)
    if group is not None and parallel.stage_params:
        _gather_stages(sd, parallel.stage_params, group, parallel.layout.index(AXIS_PIPELINE))
    return sd


def _gather_stages(sd: Dict[str, dict], mine: Set[str], group, stage: int) -> None:
    """Every stage's parameters and moments added to ``sd`` from the ranks
    of the pipeline ``group`` (host copies, in stage order), the optimizer's
    parameter list put in the whole model's order: what comes before the
    stages, the stages' in stage order (``stage``: this rank's), what comes
    after."""
    opt = sd["optimizer"]
    own = {
        "model": {n: sd["model"][n].detach().cpu() for n in mine},
        "state": {n: {k: v.detach().cpu() if torch.is_tensor(v) else v
                      for k, v in opt["state"][n].items()} for n in mine if n in opt["state"]},
        "names": [[n for n in g["params"] if n in mine] for g in opt["param_groups"]],
        "stage": stage,
    }
    parts: List[Optional[dict]] = [None] * dist.get_world_size(group)
    dist.all_gather_object(parts, own, group=group)
    by_stage = sorted(parts, key=lambda p: p["stage"])
    groups = []
    for i, g in enumerate(opt["param_groups"]):
        names = g["params"]
        first = next((j for j, n in enumerate(names) if n in mine), len(names))
        last = max((j + 1 for j, n in enumerate(names) if n in mine), default=first)
        groups.append({**g, "params": names[:first] + [n for p in by_stage
                                                      for n in p["names"][i]] + names[last:]})
    for p in parts:
        sd["model"].update(p["model"])
        opt["state"].update(p["state"])
    sd["optimizer"] = {**opt, "param_groups": groups}


def _own_stage(saved: Dict[str, dict], names: Set[str]) -> Dict[str, dict]:
    """Whole saved state cut to a stage's model: the parameters ``names``
    the model holds (every stage's share of the whole model's), their
    moments and the optimizer's list of them."""
    opt = saved["optimizer"]
    return {
        "model": {n: v for n, v in saved["model"].items() if n in names},
        "optimizer": {
            **opt,
            "state": {n: v for n, v in opt["state"].items() if n in names},
            "param_groups": [{**g, "params": [n for n in g["params"] if n in names]}
                             for g in opt["param_groups"]],
        },
    }


def load_full_state_dicts(model: nn.Module, optimizer: torch.optim.Optimizer,
                          saved: Dict[str, dict],
                          parallel: Optional[DataParallel] = None) -> None:
    """Load unsharded, name-keyed state (``state_dicts`` of any layout,
    gathered) into ``model``/``optimizer`` of this rank's layout: an
    expert shard takes its experts' rows, a tensor rank its blocks, an
    fsdp rank its rows of those."""
    from torch.distributed.checkpoint.state_dict import StateDictOptions, set_state_dict

    saved = {"model": dict(saved["model"]), "optimizer": saved["optimizer"]}
    if parallel is not None and parallel.stage_params:
        saved = _own_stage(saved, set(_inner(model).state_dict()))
    if parallel is not None and parallel.mode == "mesh":
        saved["optimizer"] = {
            **saved["optimizer"],
            "state": {k: dict(v) for k, v in saved["optimizer"]["state"].items()},
        }
        for _, splits in reversed(parallel._gathers(model)):
            for box, key, name in _param_tensors(saved, splits):
                box[key] = shard_tensor(box[key], splits[name]).contiguous()
    set_state_dict(
        _inner(model), optimizer,
        model_state_dict=saved["model"],
        optim_state_dict=saved["optimizer"],
        options=StateDictOptions(full_state_dict=True),
    )

