"""Pipeline parallelism over the ``pipeline`` mesh axis, ported from the
JAX package's ``parallel/pipeline.py``: the GPipe schedule of microbatches
through stages laid out over the axis (the slowest-varying one, the axis
meant to cross slices, ``parallel/mesh.py``).

Each rank of a pipeline group holds its own stage (an ``nn.Module`` that
maps a microbatch to one of the same shape and dtype) and runs
:func:`pipeline_apply`:

- forward: M + S - 1 ticks; at tick t, stage s runs microbatch t - s when
  0 <= t - s < M. Stage 0 takes its microbatch from the input, the others
  the activation the previous stage sent at the tick before
  (``collectives.exchange``: a send to the next stage and a receive from
  the previous one in one ``batch_isend_irecv``, the reference's
  ``ppermute`` with ``perm = [(i, i + 1)]``). The last stage's outputs are
  then broadcast to every rank of the group, as the reference's masked
  ``psum`` replicates them;
- backward: the reverse schedule, hand-written: at reverse tick t, stage
  s takes microbatch M - 1 - (t - (S - 1 - s)), runs
  ``torch.autograd.backward`` from its output with the gradient the next
  stage sent (the last stage: its own copy of the outputs' gradient, the
  only one that feeds a stage), and sends its input's gradient to the
  previous stage. Stage 0's input gradients are broadcast to every rank,
  so a computation that every rank runs alike before the pipeline (the
  embedding) gets its whole gradient on each, from stage 0 alone (the
  reference's ``jnp.where(stage == 0, first_in, incoming)``).

Both ends of every send post it in the same tick, so the schedule cannot
deadlock. Beside the other axes a pipeline group holds the ranks that
share every other coordinate (``Mesh.rank_at``): the ranks of a stage's
tensor group hold the same stage index and run the same ticks, so the
stage's own sums inside a tick (its row splits', forward and back) pair
up on all of them, and no tick runs the stage on one tensor rank and
skips it on another. On the card under gloo the sends go through host memory in the
activations' own dtype (``collectives._staged``); NCCL sends on the card.

The reference's ``stack_stage_params`` stacks every stage's parameters
along a leading stage dimension sharded over ``pipeline``; here each rank
builds only its own stage's modules, so there is nothing to stack.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Set

import torch
from torch import nn

from tfk8s_tpu_torch.parallel.collectives import broadcast_from, exchange
from tfk8s_tpu_torch.parallel.mesh import AXIS_PIPELINE, Mesh


def split_microbatches(x: torch.Tensor, num_micro: int) -> torch.Tensor:
    """``[batch, ...] -> [num_micro, batch / num_micro, ...]``."""
    if x.shape[0] % num_micro:
        raise AssertionError(
            f"batch {x.shape[0]} not divisible into {num_micro} microbatches")
    return x.reshape((num_micro, x.shape[0] // num_micro) + tuple(x.shape[1:]))


def stage_params(model: nn.Module) -> Set[str]:
    """The names of the parameters of ``model``'s pipeline stage (the
    modules marked ``pipeline_stage``): each rank of a pipeline group holds
    its own."""
    return {f"{name}.{p}" if name else p
            for name, m in model.named_modules() if getattr(m, "pipeline_stage", False)
            for p, _ in m.named_parameters()}


class _Schedule:
    """One rank's place in the GPipe schedule over the pipeline group."""

    def __init__(self, stage: Callable[[torch.Tensor], torch.Tensor], mesh):
        self.stage = stage
        if isinstance(mesh, Mesh):
            self.size, self.index = mesh.size(AXIS_PIPELINE), mesh.index(AXIS_PIPELINE)
            self.group = mesh.group(AXIS_PIPELINE)
            self.peer = [mesh.rank_at(AXIS_PIPELINE, i) for i in range(self.size)]
        else:  # a device: one stage
            self.size, self.index, self.group, self.peer = 1, 0, None, [0]
        # each microbatch's (input leaf, output) between forward and backward
        self.saved: List = []

    def _run(self, x: torch.Tensor) -> torch.Tensor:
        y = self.stage(x)
        if y.shape != x.shape or y.dtype != x.dtype:
            raise ValueError(
                f"a pipeline stage must keep its input's shape and dtype: "
                f"{tuple(x.shape)} {x.dtype} -> {tuple(y.shape)} {y.dtype}")
        return y

    def _record(self, outputs: torch.Tensor, mu: int, y: torch.Tensor) -> None:
        """The last stage keeps microbatch ``mu``'s output."""
        outputs[mu] = y

    def forward(self, micro: torch.Tensor, keep: bool) -> torch.Tensor:
        """The outputs ``[M, ...]`` of the last stage, on every rank;
        ``keep`` holds each microbatch's input (a leaf) and output for the
        backward."""
        s, n, m = self.index, self.size, micro.shape[0]
        last = s == n - 1
        outputs = torch.empty_like(micro)
        self.saved = [None] * m
        incoming = None
        for t in range(m + n - 1):
            mu, y = t - s, None
            if 0 <= mu < m:
                x = micro[mu] if s == 0 else incoming
                if keep:
                    x = x.detach().requires_grad_()
                    with torch.enable_grad():
                        y = self._run(x)
                    self.saved[mu] = (x, y)
                else:
                    y = self._run(x)
                if last:
                    self._record(outputs, mu, y.detach())
            # hand y to the next stage; take what the previous stage ran
            # this tick (it runs microbatch t - s + 1) for the next tick
            incoming = exchange(
                y.detach() if y is not None and not last else None, self._next(),
                micro[0] if s > 0 and 0 <= mu + 1 < m else None, self._prev(), self.group)
        return broadcast_from(outputs, self.peer[-1], self.group)

    def backward(self, grad: torch.Tensor, want_dx: bool) -> Optional[torch.Tensor]:
        """Run the reverse schedule from the outputs' gradient ``grad``
        (the last stage's copy feeds its stage; the other ranks' copies are
        not read); the stage parameters' gradients accumulate in place.
        Returns the gradient of the microbatches, stage 0's, on every
        rank (None unless ``want_dx``)."""
        s, n, m = self.index, self.size, grad.shape[0]
        dx = torch.zeros_like(grad)
        incoming = None
        for t in range(m + n - 1):
            k, gx = t - (n - 1 - s), None
            if 0 <= k < m:
                mu = m - 1 - k
                x, y = self.saved[mu]
                self.saved[mu] = None
                torch.autograd.backward(y, grad[mu] if s == n - 1 else incoming)
                gx = x.grad if x.grad is not None else torch.zeros_like(x)
                if s == 0:
                    dx[mu] = gx
            # the input gradient to the previous stage; the next stage's
            # (it runs k + 1 next) for the next tick
            incoming = exchange(
                gx if gx is not None and s > 0 else None, self._prev(),
                grad[0] if s < n - 1 and 0 <= k + 1 < m else None, self._next(), self.group)
        self.saved = []
        return broadcast_from(dx, self.peer[0], self.group) if want_dx else None

    def _next(self) -> Optional[int]:
        return self.peer[self.index + 1] if self.index < self.size - 1 else None

    def _prev(self) -> Optional[int]:
        return self.peer[self.index - 1] if self.index > 0 else None


class _Pipeline(torch.autograd.Function):
    """The schedule as one autograd node: its inputs are the microbatches
    and the stage's parameters (so that a graph is recorded whenever any of
    them needs a gradient); the parameters' gradients accumulate inside
    the reverse schedule, so the node returns none for them."""

    @staticmethod
    def forward(ctx, micro, schedule, *params):
        ctx.schedule = schedule
        return schedule.forward(micro, keep=True)

    @staticmethod
    def backward(ctx, grad):
        dx = ctx.schedule.backward(grad.contiguous(), ctx.needs_input_grad[0])
        return (dx, None) + (None,) * (len(ctx.needs_input_grad) - 2)


def pipeline_apply(stage: nn.Module, microbatches: torch.Tensor, mesh) -> torch.Tensor:
    """Run ``y_i = stage_S-1(...stage_1(stage_0(x_i)))`` for every
    microbatch ``x_i`` of ``microbatches`` ``[M, mb, ...]`` with the
    stages in pipeline over ``mesh``'s pipeline group, this rank running
    ``stage`` (its place on the axis); returns ``[M, mb, ...]``, the same on
    every rank of the group. ``stage`` must keep the shape and dtype of
    its input (the inter-stage contract: the embedding and the head live
    outside the pipeline region, ``models/pipelined.py``).

    ``mesh`` is a ``parallel.mesh.Mesh`` or, for one process, its device
    (one stage). The reference's ``data_axis`` (each microbatch's rows
    split over ``data``) needs no argument here: each rank passes its own
    rows and gets its own back, and its pipeline group (the ranks of its
    data block) pipelines them."""
    schedule = _Schedule(stage, mesh)
    params = [p for p in stage.parameters() if p.requires_grad] \
        if isinstance(stage, nn.Module) else []
    if torch.is_grad_enabled() and (microbatches.requires_grad or params):
        return _Pipeline.apply(microbatches, schedule, *params)
    return schedule.forward(microbatches, keep=False)
