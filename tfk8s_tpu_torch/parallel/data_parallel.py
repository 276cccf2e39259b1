"""The job's parallel layout over the mesh, in place of the JAX package's
``parallel/sharding.py`` rules: ``batch`` over data+fsdp, parameters
sharded over fsdp, MoE experts over ``expert``, the sequence over
``sequence``, and heads, MLP widths and vocabularies over ``tensor``.

- ``data`` alone: ``DistributedDataParallel``; under gradient
  accumulation every microbatch but the last runs in ``no_sync``.
- ``fsdp``: FSDP2 ``fully_shard`` over the fsdp axis, and HSDP
  (replicated over data, sharded over fsdp) when both axes are above 1.
  FSDP2 shards each parameter on dim 0, not by the reference's logical
  rules; the numbers do not depend on the layout.
- ``expert`` and/or ``sequence`` (mode "mesh"): bucketed all-reduces of
  the gradients after the step's backward, one bucket per group. The
  ranks of a sequence group hold parts of their rows' gradient (their
  tokens'), so it is summed over the group; the ranks of an expert group
  hold the same rows and, for every parameter but their experts', the
  same whole gradient, so those count once. So replicated parameters are
  summed over every rank and divided by ``data x expert``; an expert
  shard's ``wi``/``wo`` are summed over the ranks holding that shard
  (data x sequence) and divided by ``data``.
- ``tensor`` (mode "mesh", with or without ``data``): the ranks of a
  tensor group share their rows and compute every replicated parameter's
  whole gradient alike (layer norms, row-split biases, positions), and
  each holds its own blocks' (``parallel/tensor_parallel.py``); so every
  gradient is averaged over the data group only, and the gradient norm
  sums the blocks' squares over the tensor group and counts the
  replicated ones once.
- ``pipeline`` (mode "mesh", with or without ``data``): the ranks of a
  pipeline group share their rows; each holds its own stage's layers
  (``parallel/pipeline.stage_params``) and computes the whole gradient of
  what every rank runs alike (the embedding, final norm and head of
  ``models/pipelined.py``); so every gradient is averaged over the data
  group only, the norm sums the stages' squares over the pipeline group,
  and the metrics, alike over it, are averaged over the data group. A
  family with no stage runs its whole model on every pipeline rank, as
  GSPMD replicates a step with no pipeline region over the axis.

Each rank holds a contiguous block of the global batch (``local_rows``,
by its place on the data and fsdp axes), computes its local mean loss
(the sequence group's mean, on a sequence-sharded mesh), and the gradient
reduction averages over the blocks, so the update is the global batch's.
Metrics are averaged over the ranks only where a caller asks
(``reduce_metrics``, at log boundaries), so steps between them read
nothing back from the device.

Checkpoints hold whole parameters: an expert shard's ``wi``/``wo`` and a
tensor split's blocks, and their AdamW moments, are gathered over the
expert or tensor group to save (``state_dicts``), and each rank takes its
slice of them to restore (``load_full_state_dicts``); the stages' layers,
named by their global index, are gathered over the pipeline group and
each rank takes its own. So any layout resumes any other.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional, Set, Union

import torch
import torch.distributed as dist
from torch import nn

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
from tfk8s_tpu_torch.parallel.moe import SwitchMoeBlock
from tfk8s_tpu_torch.parallel.pipeline import stage_params
from tfk8s_tpu_torch.parallel.tensor_parallel import (
    Split,
    TensorShard,
    gather_tensor,
    shard_tensor,
    tensor_splits,
)


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
        if self.world == 1:
            self.mode = "none"
        elif self.layout.size(AXIS_EXPERT, AXIS_SEQUENCE, AXIS_TENSOR, AXIS_PIPELINE) > 1:
            self.mode = "mesh"
        elif fsdp == 1:
            self.mode = "ddp"
        else:
            self.mode = "hsdp" if data > 1 else "fsdp"

    @property
    def sharded(self) -> bool:
        """Whether parameters (and their optimizer state) are split across
        ranks, so each rank checkpoints its own shards."""
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
        self.expert_params = {
            f"{name}.{p}": Split(0, *m.expert_range, m.num_experts)
            for name, m in model.named_modules()
            if isinstance(m, SwitchMoeBlock) and m.experts is not None and m.experts.size > 1
            for p in ("wi", "wo")
        }
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
        if self.sharded:
            from torch.distributed.fsdp import fully_shard

            mesh = self.mesh if self.mode == "hsdp" else self.mesh[AXIS_FSDP]
            return fully_shard(model, mesh=mesh)
        return model

    def _buckets(self, model: nn.Module):
        """``[(params, group, divisor)]``: replicated parameters over every
        rank / (data x expert); expert shards over their group / data; on a
        tensor or pipeline mesh everything over the data group / data."""
        lay = self.layout
        data = lay.size(AXIS_DATA)
        if self.tp is not None or lay.size(AXIS_PIPELINE) > 1:
            return [(list(model.parameters()), lay.group(*BATCH_AXES), data)]
        rep, exp = [], []
        for name, p in model.named_parameters():
            (exp if name in self.expert_params else rep).append(p)
        buckets = [(rep, dist.group.WORLD, data * lay.size(AXIS_EXPERT))]
        if exp:
            buckets.append((exp, lay.group(AXIS_DATA, AXIS_FSDP, AXIS_SEQUENCE), data))
        return buckets

    def reduce_gradients(self, model: nn.Module) -> None:
        """Mode "mesh": reduce the step's gradients (one all-reduce a
        bucket); a no-op in the other modes, whose wrappers reduce."""
        if self.mode != "mesh":
            return
        for params, group, divisor in self._buckets(model):
            grads = [p.grad for p in params if p.grad is not None]
            if not grads or (group is None and divisor == 1):
                continue
            flat = torch.cat([g.reshape(-1) for g in grads])
            if group is not None:
                dist.all_reduce(flat, group=group)
            flat /= divisor
            offset = 0
            for g in grads:
                g.copy_(flat[offset:offset + g.numel()].view_as(g))
                offset += g.numel()

    @contextlib.contextmanager
    def no_sync(self, model: nn.Module, last: bool) -> Iterator[None]:
        """Skip the gradient all-reduce for a microbatch that is not the
        step's last."""
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

    def grad_norm(self, grads: List[torch.Tensor], model: Optional[nn.Module] = None
                  ) -> torch.Tensor:
        """The global L2 norm of the (already averaged) gradients."""
        split = {AXIS_EXPERT: self.expert_params, AXIS_TENSOR: self.tensor_params,
                 AXIS_PIPELINE: self.stage_params}
        for axis, shards in split.items():
            if self.mode == "mesh" and model is not None and self.layout.size(axis) > 1:
                # the shards differ over the axis: sum their squares over it
                sq = [torch.zeros((), device=self.device), torch.zeros((), device=self.device)]
                for name, p in model.named_parameters():
                    if p.grad is not None:
                        sq[name in shards] += p.grad.float().square().sum()
                dist.all_reduce(sq[1], group=self.layout.group(axis))
                return (sq[0] + sq[1]).sqrt()
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(_local(g).float()) for g in grads])
        )
        if self.sharded:
            # each rank holds disjoint dim-0 shards: sum the squares over
            # the fsdp axis (the data axis holds replicas of them)
            sq = norm.square()
            dist.all_reduce(sq, group=self.mesh[AXIS_FSDP].get_group())
            norm = sq.sqrt()
        return norm

    def reduce_metrics(self, values: torch.Tensor, keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Mean over the ranks of a stacked metrics vector (each rank's
        local means over equal row counts average to the global batch's;
        on a pipeline mesh over the data group, the pipeline ranks holding
        the same values); entries where ``keep`` is True are left as they
        are."""
        pipeline = self.layout.size(AXIS_PIPELINE) > 1
        group = self.layout.group(*BATCH_AXES) if pipeline else dist.group.WORLD
        if self.world == 1 or group is None:
            return values
        total = values.clone()
        dist.all_reduce(total, group=group)
        mean = total / (self.layout.size(*BATCH_AXES) if pipeline else self.world)
        return torch.where(keep, values, mean) if keep is not None else mean


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if hasattr(t, "to_local") else t


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
    plain, DDP or FSDP2 model (DTensor shards under FSDP2). With expert
    shards (``parallel``), their parameters and moments are gathered over
    the expert group into whole ``[num_experts, ...]`` tensors; with
    tensor blocks, over the tensor group into whole tensors; with pipeline
    stages, every stage's layers over the pipeline group."""
    from torch.distributed.checkpoint.state_dict import get_state_dict

    fresh = not optimizer.state
    msd, osd = get_state_dict(model, optimizer)
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
    for axis, splits in ((AXIS_EXPERT, parallel.expert_params),
                         (AXIS_TENSOR, parallel.tensor_params)):
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
    expert shard takes its experts' rows, a tensor rank its blocks."""
    from torch.distributed.checkpoint.state_dict import StateDictOptions, set_state_dict

    saved = {"model": dict(saved["model"]), "optimizer": saved["optimizer"]}
    if parallel is not None and parallel.stage_params:
        saved = _own_stage(saved, set(model.state_dict()))
    if parallel is not None and (parallel.expert_params or parallel.tensor_params):
        saved["optimizer"] = {
            **saved["optimizer"],
            "state": {k: dict(v) for k, v in saved["optimizer"]["state"].items()},
        }
        for splits in (parallel.expert_params, parallel.tensor_params):
            for box, key, name in _param_tensors(saved, splits):
                box[key] = shard_tensor(box[key], splits[name]).contiguous()
    set_state_dict(
        model, optimizer,
        model_state_dict=saved["model"],
        optim_state_dict=saved["optimizer"],
        options=StateDictOptions(full_state_dict=True),
    )

