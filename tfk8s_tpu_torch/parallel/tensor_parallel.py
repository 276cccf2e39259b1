"""The ``tensor`` mesh axis: Megatron's column and row splits and the
vocab-parallel table, in place of what GSPMD makes of the JAX package's
logical rules (``parallel/sharding.py`` ``DEFAULT_RULES``: ``heads``,
``mlp`` and ``vocab`` over ``tensor``; a mesh axis already used in a
spec is dropped, so a kernel ``("mlp", "vocab")`` splits its rows only).

Each rank of the tensor group holds a contiguous block of each split
dimension, as ``nn.Linear``/``nn.Embedding`` modules of the block's size
under the one-process names, and each module lists its blocks in
``tensor_splits`` (parameter name -> :class:`Split`). The numbers are one
process's:

- a column split (:func:`enter`, then the module's own projection of its
  output block): the input enters through ``collectives.copy_over``, whose
  backward sums the blocks' input gradients;
- a row split (:func:`row_dense`): each rank's product of its input block
  and weight columns, summed over the group (``sum_over``), the bias
  added once after the sum;
- a column block gathered whole (:func:`gather_columns`) for a layer that
  every rank then runs alike;
- a vocab-parallel table: rows split unevenly where the vocabulary does
  not divide (the first ``V % t`` ranks hold one row more), so no padded
  row exists to reach a loss, an argmax or a checkpoint;
- the MoE FFN's hidden width (the reference's ``expert_mlp``): each
  expert's ``wi`` a column block, its ``wo`` a row block whose products
  are summed over the group (:func:`sum_blocks`), beside the expert
  axis's split of the experts (``parallel/moe.py``).

The sums and gathers of 16-bit activations travel as float32, so a sum
rounds once and gloo is never handed a 16-bit tensor.

Parameters are initialised whole from the one-process generator and
sliced (:func:`init_sharded`; an expert shard's rows too, where the mesh
also has an expert axis), so a gang starts where one process does;
checkpoints gather the blocks back into whole tensors
(``parallel/data_parallel.py``), so every layout restores every other.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tfk8s_tpu_torch.parallel.collectives import all_gather, copy_over, gather_whole, sum_over
from tfk8s_tpu_torch.parallel.mesh import AXIS_TENSOR, Mesh


class Split(NamedTuple):
    """This rank's block ``[lo, hi)`` of dimension ``dim`` of a parameter
    whose whole size there is ``full``."""

    dim: int
    lo: int
    hi: int
    full: int


@dataclasses.dataclass(frozen=True)
class TensorShard:
    """This rank's place on the tensor axis: block ``index`` of ``size``
    over ``group``."""

    group: object
    index: int
    size: int

    @classmethod
    def of(cls, mesh) -> Optional["TensorShard"]:
        """The place on a :class:`parallel.mesh.Mesh` with a tensor axis
        (None otherwise, or for a device)."""
        if not isinstance(mesh, Mesh) or mesh.size(AXIS_TENSOR) == 1:
            return None
        return cls(mesh.group(AXIS_TENSOR), mesh.index(AXIS_TENSOR), mesh.size(AXIS_TENSOR))

    def rows(self, n: int) -> Tuple[int, int]:
        """This rank's block of ``n`` rows split as evenly as they go: the
        first ``n % size`` blocks hold one row more."""
        base, extra = divmod(n, self.size)
        lo = self.index * base + min(self.index, extra)
        return lo, lo + base + (self.index < extra)

    def block(self, n: int, what: str) -> Tuple[int, int]:
        """This rank's equal block of ``n`` (``what`` names it in the
        error when ``n`` does not divide)."""
        if n % self.size:
            raise ValueError(f"{what}={n} does not divide over tensor={self.size}")
        step = n // self.size
        return self.index * step, (self.index + 1) * step


def group_of(tp: Optional[TensorShard]):
    return None if tp is None else tp.group


def vocab_split(mesh, n: int) -> Optional[Tuple[int, object]]:
    """``(first row, tensor group)`` of this rank's block of an ``n``-row
    vocabulary on a tensor mesh (None elsewhere): what the
    vocab-parallel losses take (``transformer.masked_token_loss``)."""
    tp = TensorShard.of(mesh)
    return None if tp is None else (tp.rows(n)[0], tp.group)


def _wire(x: torch.Tensor) -> torch.Tensor:
    """What a sum or gather of ``x`` moves: float32 for 16-bit floats."""
    return x.float() if x.dtype in (torch.bfloat16, torch.float16) else x


def enter(x: torch.Tensor, tp: Optional[TensorShard]) -> torch.Tensor:
    """``x`` entering column splits: as is, its gradient summed over the
    group."""
    if tp is None:
        return x
    return copy_over(_wire(x), tp.group).to(x.dtype)


def sum_blocks(part: torch.Tensor, tp: Optional[TensorShard],
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The sum over the group of every rank's product ``part`` of a row
    split, on the float32 wire, then ``bias`` (replicated, added once),
    cast back to ``part``'s dtype as the one-process product rounds."""
    if tp is None:
        return part if bias is None else part + bias
    total = sum_over(_wire(part), tp.group)
    if bias is not None:
        total = total + bias.to(total.dtype)
    return total.to(part.dtype)


def row_dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype,
              tp: Optional[TensorShard]) -> torch.Tensor:
    """A row-split projection in ``dtype``: ``x``'s columns times this
    rank's weight columns, summed over the group, then the (replicated)
    bias, cast to ``dtype`` as the one-process projection casts it."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    if tp is None:
        return F.linear(x.to(dtype), layer.weight.to(dtype), bias)
    return sum_blocks(F.linear(x.to(dtype), layer.weight.to(dtype)), tp, bias)


def gather_columns(y: torch.Tensor, tp: Optional[TensorShard]) -> torch.Tensor:
    """Every rank's column block of ``y`` (last dim) concatenated whole."""
    if tp is None:
        return y
    return gather_whole(_wire(y), y.dim() - 1, tp.group).to(y.dtype)


def column_splits(lo: int, hi: int, full: int, bias: bool = True) -> Dict[str, Split]:
    """The splits of an ``nn.Linear`` holding output rows ``[lo, hi)``."""
    out = {"weight": Split(0, lo, hi, full)}
    if bias:
        out["bias"] = Split(0, lo, hi, full)
    return out


def named_splits(model: nn.Module, kind: str = "tensor_splits") -> Dict[str, Split]:
    """Every split parameter of ``model`` by its name: the blocks its
    modules list under ``kind`` (``tensor_splits``, or ``expert_splits``
    for the expert axis's rows)."""
    out: Dict[str, Split] = {}
    for prefix, module in model.named_modules():
        for name, split in getattr(module, kind, {}).items():
            out[f"{prefix}.{name}" if prefix else name] = split
    return out


def tensor_splits(model: nn.Module) -> Dict[str, Split]:
    """Every tensor-split parameter of ``model`` by its name."""
    return named_splits(model, "tensor_splits")


def shard_tensor(t: torch.Tensor, split: Split) -> torch.Tensor:
    """This rank's block of a whole tensor."""
    return t.narrow(split.dim, split.lo, split.hi - split.lo)


def shard_state_dict(full: Dict[str, torch.Tensor],
                     *splits: Dict[str, Split]) -> Dict[str, torch.Tensor]:
    """A whole state dict cut to this rank's blocks of every map of
    ``splits`` (an expert shard's rows, then its tensor block)."""
    out = dict(full)
    for split in splits:
        out = {k: shard_tensor(v, split[k]) if k in split else v for k, v in out.items()}
    return out


def gather_tensor(t: torch.Tensor, split: Split, group, size: int) -> torch.Tensor:
    """The whole tensor from the blocks of the ``size`` ranks of ``group``
    (blocks of unequal rows are padded to the largest to travel, and cut
    back)."""
    part = t.detach()
    widest = -(-split.full // size)
    pad = widest - part.shape[split.dim]
    if pad:
        shape = list(part.shape)
        shape[split.dim] = pad
        part = torch.cat([part, part.new_zeros(shape)], dim=split.dim)
    blocks = all_gather(part.contiguous(), split.dim, group).split(widest, dim=split.dim)
    sizes = [TensorShard(None, r, size).rows(split.full) for r in range(size)]
    return torch.cat([b.narrow(split.dim, 0, hi - lo) for b, (lo, hi) in zip(blocks, sizes)],
                     dim=split.dim)


def init_sharded(build: Callable[[object], nn.Module],
                 init: Callable[[nn.Module, torch.Generator], nn.Module],
                 generator: torch.Generator, mesh) -> nn.Module:
    """``init(build(mesh), generator)``, the model over ``mesh``. On a
    tensor mesh the whole model is built and initialised as one process
    builds it (``build(None)``, the same draws) and each rank keeps its
    expert rows and tensor blocks, so every layout starts from the same
    parameters."""
    if TensorShard.of(mesh) is None:
        return init(build(mesh), generator)
    whole = init(build(None), generator)
    model = build(mesh)
    model.load_state_dict(shard_state_dict(whole.state_dict(),
                                           named_splits(model, "expert_splits"),
                                           tensor_splits(model)))
    return model
