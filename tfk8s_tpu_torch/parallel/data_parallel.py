"""Data parallelism over the mesh's ``data`` and ``fsdp`` axes, in place
of the JAX package's ``parallel/sharding.py`` rules for those axes
(``batch`` over data+fsdp, parameters sharded over fsdp).

- ``data`` alone: ``DistributedDataParallel``; under gradient
  accumulation every microbatch but the last runs in ``no_sync``.
- ``fsdp``: FSDP2 ``fully_shard`` over the fsdp axis, and HSDP
  (replicated over data, sharded over fsdp) when both axes are above 1.
  FSDP2 shards each parameter on dim 0, not by the reference's logical
  rules; the numbers do not depend on the layout.

Each rank holds a contiguous block of the global batch (``local_rows``),
computes its local mean loss, and the gradient all-reduce averages over
the ranks, so the update is the global batch's. Metrics are averaged over
the ranks only where a caller asks (``reduce_metrics``, at log
boundaries), so steps between them read nothing back from the device.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional

import torch
import torch.distributed as dist
from torch import nn

from tfk8s_tpu_torch.parallel.mesh import AXIS_DATA, AXIS_FSDP, MeshConfig, build_device_mesh, rank, world_size


class DataParallel:
    """The job's data-parallel layout, for one rank. ``mode`` is "none"
    (one process), "ddp", "fsdp" or "hsdp"."""

    def __init__(self, cfg: Optional[MeshConfig], device: torch.device):
        self.device = torch.device(device)
        self.cfg = cfg or MeshConfig.create(data=world_size())
        self.mesh = build_device_mesh(self.cfg, self.device)
        self.world = world_size()
        self.rank = rank()
        data, fsdp = self.cfg.axis_size(AXIS_DATA), self.cfg.axis_size(AXIS_FSDP)
        if self.world == 1:
            self.mode = "none"
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
        if batch_size % self.world:
            raise ValueError(
                f"batch_size={batch_size} does not divide over {self.world} ranks"
            )
        return batch_size // self.world

    def wrap(self, model: nn.Module) -> nn.Module:
        """The model as the step runs it (the optimizer must be built over
        the wrapped parameters)."""
        if self.mode == "ddp":
            ids = [self.device.index] if self.device.type == "cuda" else None
            return nn.parallel.DistributedDataParallel(model, device_ids=ids)
        if self.sharded:
            from torch.distributed.fsdp import fully_shard

            mesh = self.mesh if self.mode == "hsdp" else self.mesh[AXIS_FSDP]
            return fully_shard(model, mesh=mesh)
        return model

    @contextlib.contextmanager
    def no_sync(self, model: nn.Module, last: bool) -> Iterator[None]:
        """Skip the gradient all-reduce for a microbatch that is not the
        step's last."""
        if last or self.mode == "none":
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

    def grad_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The global L2 norm of the (already averaged) gradients."""
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
        local means over equal row counts average to the global batch's);
        entries where ``keep`` is True are left as they are."""
        if self.world == 1:
            return values
        total = values.clone()
        dist.all_reduce(total)
        mean = total / self.world
        return torch.where(keep, values, mean) if keep is not None else mean


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if hasattr(t, "to_local") else t


def state_dicts(model: nn.Module, optimizer: torch.optim.Optimizer) -> Dict[str, dict]:
    """Model and optimizer state keyed by parameter name, the same for a
    plain, DDP or FSDP2 model (DTensor shards under FSDP2)."""
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
    return {"model": msd, "optimizer": osd}


def load_full_state_dicts(model: nn.Module, optimizer: torch.optim.Optimizer,
                          saved: Dict[str, dict]) -> None:
    """Load unsharded, name-keyed state (``state_dicts`` of any layout,
    gathered) into ``model``/``optimizer`` of this rank's layout."""
    from torch.distributed.checkpoint.state_dict import StateDictOptions, set_state_dict

    set_state_dict(
        model, optimizer,
        model_state_dict=dict(saved["model"]),
        optim_state_dict=saved["optimizer"],
        options=StateDictOptions(full_state_dict=True),
    )
