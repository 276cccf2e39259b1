"""MNIST-scale MLP classifier, ported from the JAX package's
``models/mlp.py`` (``BASELINE.json`` configs[0]): a 2-layer MLP trained on
synthetic-but-learnable data, a fixed random teacher matrix labelling
Gaussian images, through the ``mlp:train`` TPUJob entrypoint
(``tfk8s_tpu_torch.models.mlp:train``).

The batches are the reference's: the same numpy draws give the same
images and labels. Parameters follow flax's ``Dense`` layout under the
names ``fc1``/``fc2`` (``bridge.mlp_params_to_state_dict`` maps them),
initialized as flax's ``lecun_normal`` (a normal of variance ``1 /
fan_in`` truncated at two standard deviations) with zero biases.

On a mesh with a ``tensor`` axis each rank holds a block of the hidden
width, as the reference's rules split it (``fc1`` ``("embed", "mlp")``, a
column split; ``fc2`` ``("mlp", "vocab")``, whose ``vocab`` falls away
because ``tensor`` is taken, a row split): the logits are whole on every
rank after the row split's sum, so the loss and accuracy are the
one-process ones.

``evaluate`` is the Evaluator replica's entrypoint
(``tfk8s_tpu_torch.models.mlp:evaluate``): ``run_eval`` scores each
checkpoint the workers write.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tfk8s_tpu_torch.parallel.tensor_parallel import (
    Split,
    TensorShard,
    column_splits,
    enter,
    init_sharded,
    row_dense,
)
from tfk8s_tpu_torch.runtime import pod_ranks
from tfk8s_tpu_torch.runtime.train import TrainTask, join_mesh, run_eval, run_task

IMAGE_DIM = 784
NUM_CLASSES = 10
_TEACHER_SEED = 1234
# the standard deviation of a unit normal truncated to [-2, 2]: flax's
# truncated-normal variance scaling divides by it
_TRUNC_STD = 0.87962566103423978


class MLP(nn.Module):
    """2-layer MLP: ``fc1`` (ReLU) then ``fc2``, float32 (reference
    ``mlp.py:25``); ``mesh`` with a tensor axis: this rank's block of the
    hidden width."""

    def __init__(self, hidden: int = 256, classes: int = NUM_CLASSES, mesh=None):
        super().__init__()
        self.tp = TensorShard.of(mesh)
        lo, hi = (0, hidden) if self.tp is None else self.tp.block(hidden, "hidden")
        self.fc1 = nn.Linear(IMAGE_DIM, hi - lo)
        self.fc2 = nn.Linear(hi - lo, classes)
        if self.tp is not None:
            self.tensor_splits = {f"fc1.{p}": split for p, split in
                                  column_splits(lo, hi, hidden).items()}
            self.tensor_splits["fc2.weight"] = Split(1, lo, hi, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.fc1(enter(x, self.tp)))
        return row_dense(self.fc2, h, torch.float32, self.tp)


def init_params(model: MLP, generator: torch.Generator) -> MLP:
    """flax's ``lecun_normal`` kernels and zero biases, drawn from
    ``generator``."""
    with torch.no_grad():
        for layer in (model.fc1, model.fc2):
            std = math.sqrt(1.0 / layer.in_features) / _TRUNC_STD
            nn.init.trunc_normal_(layer.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            layer.bias.zero_()
    return model


def _teacher() -> np.ndarray:
    return np.random.default_rng(_TEACHER_SEED).standard_normal(
        (IMAGE_DIM, NUM_CLASSES)
    ).astype(np.float32)


_TEACHER = _teacher()


def make_batch(rng: np.random.Generator, batch_size: int) -> Dict[str, np.ndarray]:
    """Margin-filtered teacher labels (a copy of the reference's numpy
    function: same rng draws, same batch): samples whose top-2 logit gap
    is small are resampled, so the task stays cleanly separable."""
    xs, ys, need = [], [], batch_size
    while need > 0:
        x = rng.standard_normal((2 * need, IMAGE_DIM)).astype(np.float32)
        logits = x @ _TEACHER
        part = np.partition(logits, -2, axis=-1)
        margin = part[:, -1] - part[:, -2]
        keep = margin > 12.0
        x, y = x[keep][:need], np.argmax(logits[keep], axis=-1)[:need]
        xs.append(x)
        ys.append(y.astype(np.int32))
        need -= len(x)
    return {"image": np.concatenate(xs), "label": np.concatenate(ys)}


def loss_and_metrics(logits: torch.Tensor,
                     labels: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean softmax cross-entropy and accuracy."""
    loss = F.cross_entropy(logits.float(), labels.long())
    acc = (logits.argmax(-1) == labels.long()).float().mean()
    return loss, {"accuracy": acc}


def make_task(batch_size: int = 128, hidden: int = 256, mesh=None) -> TrainTask:
    """The classifier's task; ``mesh`` (a ``parallel.mesh.Mesh``) places the
    model on its tensor block."""

    def init(generator: torch.Generator) -> MLP:
        return init_sharded(lambda m: MLP(hidden=hidden, mesh=m), init_params, generator, mesh)

    def loss_fn(model, batch):
        return loss_and_metrics(model(batch["image"]), batch["label"])

    return TrainTask(
        name="mnist-mlp",
        init=init,
        loss_fn=loss_fn,
        make_batch=make_batch,
        batch_size=batch_size,
        targets={"accuracy": 0.9},
    )


@pod_ranks.entrypoint
def train(env: Dict[str, str], stop: Optional[Any] = None) -> List[Dict[str, float]]:
    """TPUJob entrypoint: ``tfk8s_tpu_torch.models.mlp:train``, with the
    reference's defaults (300 steps at learning rate 3e-3), over the
    mesh's data and tensor axes. Returns the logged metrics history."""
    env = dict(env)
    env.setdefault("TFK8S_TRAIN_STEPS", "300")
    env.setdefault("TFK8S_LEARNING_RATE", "3e-3")
    _ctx, device, mesh = join_mesh(env)
    return run_task(make_task(mesh=mesh), env, stop, device=device, mesh=mesh)


def evaluate(env: Dict[str, str], stop: Optional[Any] = None) -> Dict[str, float]:
    """TPUJob entrypoint of the Evaluator replica,
    ``tfk8s_tpu_torch.models.mlp:evaluate``: scores each new checkpoint
    the workers write (``runtime.train.run_eval``) and returns the final
    step's metrics."""
    env = dict(env)
    # train()'s default: the evaluator exits after scoring this step
    env.setdefault("TFK8S_TRAIN_STEPS", "300")
    return run_eval(make_task(), env, stop)
