"""DLRM CTR model (``BASELINE.json`` configs[4]), ported from the JAX
package's ``models/dlrm.py``: one embedding table per categorical
feature, a bottom MLP over the dense features, the pairwise-dot
interaction over the upper triangle, and a top MLP to one click logit,
trained through the ``dlrm:train`` TPUJob entrypoint
(``tfk8s_tpu_torch.models.dlrm:train``).

Numerics kept from the reference so the same bridged parameters give the
same numbers: float32 parameters and bfloat16 compute (``DTYPE``, which
the reference fixes: every dense layer casts its input, kernel and bias,
each looked-up row is cast, the interaction is a bfloat16 product), and
a float32 logit. A dense layer's bfloat16 operands are multiplied and
summed in float32 and the sum rounded once (:func:`_dot`), as a TPU's
dot accumulates: a cuBLAS bfloat16 GEMM may round a split-K's partial
sums in bfloat16 for some shapes only, and so gave a gang whose ranks
hold half the rows (fsdp) other numbers than one process (each table's
gradient 0.10 relative L2 from one process's on an H100, against 5.5e-3
with float32 sums).

The tables are the reference's parameter servers translated onto the
mesh: their rows split over the ``tensor`` axis (``("vocab", "embed")``),
each rank looking up the ids it holds and the group summing
(``collectives.vocab_parallel_lookup``); a vocabulary that does not
divide splits unevenly. The dense layers' hidden widths split over
``tensor`` too (``(None, "mlp")``; the one-wide logit layer is whole):
each is a column split whose blocks are gathered whole before the next
layer, which every rank then runs alike. That is what GSPMD makes of the
reference's specs, and it keeps each output element one rank's whole
dot product, so a gang's forward is one process's; a column/row pair
would instead sum bfloat16 partial products, a second rounding. The
batches are the reference's byte for byte (``make_batch_fn``, from the
same ``np.random.Generator``).
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tfk8s_tpu_torch.parallel.collectives import scale_grad, vocab_parallel_lookup
from tfk8s_tpu_torch.parallel.mesh import AXIS_SEQUENCE, Mesh
from tfk8s_tpu_torch.parallel.tensor_parallel import (
    Split,
    TensorShard,
    column_splits,
    enter,
    gather_columns,
    group_of,
    init_sharded,
)
from tfk8s_tpu_torch.runtime import pod_ranks
from tfk8s_tpu_torch.runtime.train import TrainTask, join_mesh, keep_sequence, run_task

# the compute dtype the reference fixes (``dlrm.py:43``, ``:95``, ``:97``,
# ``:106``); parameters are float32
DTYPE = torch.bfloat16
DEFAULT_VOCAB_SIZES = (100_000,) * 8
# flax's truncated-normal variance scaling divides by the standard
# deviation of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def _dot(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``layer`` at DTYPE: input, kernel and bias cast to DTYPE, the
    products summed in float32 with the bias, the sum rounded to DTYPE
    once."""
    w, b = (t.to(DTYPE).float() for t in (layer.weight, layer.bias))
    return F.linear(x.to(DTYPE).float(), w, b).to(DTYPE)


class Mlp(nn.Module):
    """Dense layers ``fc{i}`` of the given widths, ReLU between them. On a
    tensor mesh (``tp``) a width above 1 is a column split gathered whole
    after the layer; a one-wide layer is whole on every rank."""

    def __init__(self, in_features: int, layers: Sequence[int],
                 tp: Optional[TensorShard] = None):
        super().__init__()
        self.widths, self.tp = tuple(layers), tp
        self.tensor_splits: Dict[str, Split] = {}
        for i, width in enumerate(self.widths):
            lo, hi = tp.block(width, f"fc{i} width") if self._split(width) else (0, width)
            self.add_module(f"fc{i}", nn.Linear(in_features, hi - lo))
            if self._split(width):
                self.tensor_splits.update({f"fc{i}.{p}": s for p, s in
                                           column_splits(lo, hi, width).items()})
            in_features = width

    def _split(self, width: int) -> bool:
        return self.tp is not None and width > 1

    def layers(self) -> List[nn.Linear]:
        return [getattr(self, f"fc{i}") for i in range(len(self.widths))]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, (width, layer) in enumerate(zip(self.widths, self.layers())):
            if self._split(width):
                x = gather_columns(_dot(layer, enter(x, self.tp)), self.tp)
            else:
                x = _dot(layer, x)
            if i < len(self.widths) - 1:
                x = F.relu(x)
        return x


class DLRM(nn.Module):
    """``num_tables`` categorical features, one table each (``table{t}``),
    and the bottom and top MLPs: ``(dense [b, dense_features] float32,
    sparse [b, num_tables] int)`` -> float32 logits ``[b]``. ``mesh``
    places it on its tensor blocks."""

    def __init__(self, vocab_sizes: Sequence[int], embed_dim: int = 64,
                 dense_features: int = 13, bottom_layers: Optional[Sequence[int]] = None,
                 top_layers: Sequence[int] = (512, 256, 1), mesh=None):
        super().__init__()
        self.vocab_sizes, self.tp = tuple(vocab_sizes), TensorShard.of(mesh)
        # the bottom MLP ends at embed_dim, so its output stacks with the rows
        bottom = tuple(bottom_layers) if bottom_layers is not None else (512, 256, embed_dim)
        if bottom[-1] != embed_dim:
            raise ValueError(f"the bottom MLP ends at {bottom[-1]}, not embed_dim={embed_dim}")
        self.table_lo: List[int] = []
        self.tensor_splits: Dict[str, Split] = {}
        for t, vocab in enumerate(self.vocab_sizes):
            lo, hi = (0, vocab) if self.tp is None else self.tp.rows(vocab)
            self.add_module(f"table{t}", nn.Embedding(hi - lo, embed_dim))
            self.table_lo.append(lo)
            if self.tp is not None:
                self.tensor_splits[f"table{t}.weight"] = Split(0, lo, hi, vocab)
        self.bottom = Mlp(dense_features, bottom, self.tp)
        n = 1 + len(self.vocab_sizes)
        self.top = Mlp(embed_dim + n * (n - 1) // 2, top_layers, self.tp)

    def tables(self) -> List[nn.Embedding]:
        return [getattr(self, f"table{t}") for t in range(len(self.vocab_sizes))]

    def forward(self, dense: torch.Tensor, sparse: torch.Tensor) -> torch.Tensor:
        group = group_of(self.tp)
        embs = [vocab_parallel_lookup(table.weight, sparse[:, t], lo, group).to(DTYPE)
                for t, (table, lo) in enumerate(zip(self.tables(), self.table_lo))]
        bottom = self.bottom(dense.to(DTYPE))
        feats = torch.stack([bottom] + embs, dim=1)  # [b, 1 + T, embed]
        # pairwise dot interaction, upper triangle, row-major as jnp.triu_indices
        inter = torch.einsum("bne,bme->bnm", feats, feats)
        n = feats.shape[1]
        iu, ju = torch.triu_indices(n, n, offset=1, device=feats.device)
        top_in = torch.cat([bottom, inter[:, iu, ju].to(DTYPE)], dim=-1)
        return self.top(top_in)[:, 0].float()


def init_params(model: DLRM, generator: torch.Generator) -> DLRM:
    """The reference's initializers, drawn from ``generator``: normal(0.01)
    tables; flax's ``lecun_normal`` dense kernels (a normal of variance
    ``1 / fan_in`` truncated at two standard deviations) and zero biases."""
    with torch.no_grad():
        for table in model.tables():
            table.weight.normal_(0.0, 0.01, generator=generator)
        for layer in model.bottom.layers() + model.top.layers():
            std = math.sqrt(1.0 / layer.in_features) / _TRUNC_STD
            nn.init.trunc_normal_(layer.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            layer.bias.zero_()
    return model


# -- synthetic learnable CTR data (a copy of the reference's numpy code) -----

_GT_SEED = 777


@functools.lru_cache(maxsize=None)
def _ground_truth(vocab_sizes: Tuple[int, ...], dense_features: int, rank: int = 4):
    rng = np.random.default_rng(_GT_SEED)
    table_vecs = [
        rng.standard_normal((v, rank)).astype(np.float32) for v in vocab_sizes
    ]
    dense_w = rng.standard_normal((dense_features, rank)).astype(np.float32)
    return table_vecs, dense_w


def make_batch_fn(vocab_sizes: Tuple[int, ...], dense_features: int):
    table_vecs, dense_w = _ground_truth(vocab_sizes, dense_features)

    def make_batch(rng: np.random.Generator, batch_size: int) -> Dict[str, np.ndarray]:
        dense = rng.standard_normal((batch_size, dense_features)).astype(np.float32)
        sparse = np.stack(
            [rng.integers(0, v, size=batch_size) for v in vocab_sizes], axis=1
        )
        # click probability from latent-factor affinities
        latent = dense @ dense_w
        for t, vecs in enumerate(table_vecs):
            latent = latent + vecs[sparse[:, t]]
        score = np.sum(latent, axis=-1) / np.sqrt(latent.shape[-1])
        p = 1.0 / (1.0 + np.exp(-1.5 * score))
        click = (rng.random(batch_size) < p).astype(np.float32)
        return {
            "dense": dense,
            "sparse": sparse.astype(np.int32),
            "click": click,
        }

    return make_batch


def loss_and_metrics(logit: torch.Tensor, click: torch.Tensor
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean sigmoid cross-entropy (optax's ``sigmoid_binary_cross_entropy``)
    and click accuracy."""
    loss = F.binary_cross_entropy_with_logits(logit, click.float())
    acc = ((logit > 0) == (click > 0.5)).float().mean()
    return loss, {"click_accuracy": acc}


def make_task(
    vocab_sizes: Sequence[int] = DEFAULT_VOCAB_SIZES,
    embed_dim: int = 64,
    dense_features: int = 13,
    batch_size: int = 4096,
    targets: Optional[Dict[str, float]] = None,
    mesh=None,
) -> TrainTask:
    vocab_sizes = tuple(vocab_sizes)

    def build(m) -> DLRM:
        return DLRM(vocab_sizes, embed_dim=embed_dim, dense_features=dense_features, mesh=m)

    def init(generator: torch.Generator) -> DLRM:
        return init_sharded(build, init_params, generator, mesh)

    # a sequence rank holds its rows whole (DLRM has no sequence): its
    # gradient is the whole one, so it carries 1 / n of it into the
    # reduction's sum over the sequence group
    share = 1 / mesh.size(AXIS_SEQUENCE) if isinstance(mesh, Mesh) else 1

    def loss_fn(model, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        loss, metrics = loss_and_metrics(model(batch["dense"], batch["sparse"]), batch["click"])
        return scale_grad(loss, share), metrics

    return TrainTask(
        name="dlrm",
        init=init,
        loss_fn=loss_fn,
        make_batch=make_batch_fn(vocab_sizes, dense_features),
        batch_size=batch_size,
        targets=targets or {},
        split_sequence=keep_sequence,
    )


def task_for_mesh(mesh, **task_kw) -> TrainTask:
    """The task over ``mesh`` (a ``parallel.mesh.Mesh``, or the device of a
    one-process run): its tables and hidden widths split over the tensor
    axis, each block's rows over fsdp (``data_parallel.FsdpShards``), and
    replicated over expert, sequence and pipeline, as the reference's
    specs leave it."""
    return make_task(mesh=mesh, **task_kw)


@pod_ranks.entrypoint
def train(env: Dict[str, str], stop: Optional[Any] = None) -> List[Dict[str, float]]:
    """TPUJob entrypoint: ``tfk8s_tpu_torch.models.dlrm:train``, with the
    reference's env contract (``TFK8S_BATCH_SIZE`` 4096, 100 steps at lr
    1e-3 unless set; ``TFK8S_VOCAB_SIZES`` comma-separated, default eight
    tables of 100,000 rows; ``TFK8S_EMBED_DIM`` 64), on the card unless
    ``TFK8S_DEVICE=cpu``, over any mesh (the tensor axis is the
    embedding-shard axis, :func:`task_for_mesh`). Returns the logged
    metrics history."""
    env = dict(env)
    env.setdefault("TFK8S_TRAIN_STEPS", "100")
    env.setdefault("TFK8S_LEARNING_RATE", "1e-3")
    vocab_raw = env.get("TFK8S_VOCAB_SIZES", "")
    vocab = tuple(int(v) for v in vocab_raw.split(",")) if vocab_raw else DEFAULT_VOCAB_SIZES
    _ctx, device, mesh = join_mesh(env)
    task = task_for_mesh(
        mesh,
        vocab_sizes=vocab,
        embed_dim=int(env.get("TFK8S_EMBED_DIM", "64")),
        batch_size=int(env.get("TFK8S_BATCH_SIZE", "4096")),
    )
    return run_task(task, env, stop, device=device, mesh=mesh)
