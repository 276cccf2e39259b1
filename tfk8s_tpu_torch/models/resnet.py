"""ResNet (18/34/50/101/152) with GroupNorm, ported from the JAX package's
``models/resnet.py``: the same blocks, widths, inits, dtypes and hermetic
synthetic data, and the ``resnet:train`` TPUJob entrypoint
(``tfk8s_tpu_torch.models.resnet:train``).

Layout and numerics kept from the reference:
- activations are NHWC at every module boundary (the reference's layout).
  A convolution views its NHWC input as a channels-last NCHW tensor (a
  permute, no copy), so cuDNN runs channels-last and hands back a tensor
  whose NHWC view is contiguous again;
- bfloat16 compute with float32 parameters: the image and each conv
  kernel are cast to bfloat16 for the convolution; the norms' outputs are
  bfloat16; the global pool averages in float32, rounds to bfloat16 and
  casts to float32 (``jnp.mean`` over bfloat16); the classifier is float32;
- SAME padding as JAX pads it: asymmetric where the total is odd (the
  7x7/2 stem on 224 pads (2, 3); a 3x3/2 conv or the 3x3/2 max pool on an
  even size pads (0, 1), the pool with -inf). PyTorch's ``padding=`` is
  symmetric, so an odd total is padded explicitly with ``F.pad``;
- inits: conv kernels normal(0, sqrt(2 / fan_out)) (flax's
  ``variance_scaling(2.0, "fan_out", "normal")``), GroupNorm scale 1 and
  bias 0, the last norm of each residual branch with scale 0, and a zero
  classifier.

Every norm goes through the port's ``fused_group_norm`` (the CUDA kernels
on the card), with the ReLU that directly follows it fused in
(``stem_norm``, ``norm1``, ``norm2`` of a bottleneck, ``norm1`` of a basic
block). The reference model calls ``flax.linen.GroupNorm`` (eps 1e-6,
float32 statistics) rather than its Pallas kernel, because inside XLA the
kernel is a fusion boundary; eager PyTorch fuses nothing, so here the
fused kernel is the natural counterpart. Both compute the same function.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tfk8s_tpu_torch.ops.group_norm import fused_group_norm
from tfk8s_tpu_torch.runtime.launcher import select_device
from tfk8s_tpu_torch.runtime.train import TrainTask, run_task

# stage depths for the standard variants
DEPTHS = {
    18: (2, 2, 2, 2),
    34: (3, 4, 6, 3),
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}
BOTTLENECK = {50, 101, 152}
GN_EPS = 1e-6  # flax GroupNorm's epsilon (torch.nn.GroupNorm defaults to 1e-5)


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of one spatial dim under JAX's "SAME": the
    output has ceil(size / stride) positions and an odd total goes high."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, kernel: int, stride: int, value: float = 0.0):
    """x NCHW -> (x padded where SAME is asymmetric, symmetric (ph, pw)
    left for the op's own ``padding=``)."""
    (hl, hh), (wl, wh) = (same_padding(n, kernel, stride) for n in x.shape[2:])
    if hl == hh and wl == wh:
        return x, (hl, wl)
    return F.pad(x, (wl, wh, hl, hh), value=value), (0, 0)


class Conv(nn.Module):
    """SAME-padded bias-free convolution over NHWC tensors; the float32
    kernel is stored OIHW and cast to ``dtype`` (with the input) for the
    product, as flax's ``nn.Conv(dtype=bfloat16, param_dtype=float32)``."""

    def __init__(self, in_features: int, features: int, kernel: int, strides: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features, kernel, kernel))
        self.kernel, self.strides, self.dtype = kernel, strides, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NHWC -> channels-last NCHW view
        x, padding = _pad_same(x, self.kernel, self.strides)
        w = self.weight.to(dtype=self.dtype, memory_format=torch.channels_last)
        y = F.conv2d(x, w, stride=self.strides, padding=padding)
        return y.permute(0, 2, 3, 1)


def _conv(in_features: int, features: int, kernel: int, strides: int = 1,
          dtype: torch.dtype = torch.bfloat16) -> Conv:
    return Conv(in_features, features, kernel, strides, dtype)


def max_pool(x: torch.Tensor, window: int = 3, strides: int = 2) -> torch.Tensor:
    """``flax.linen.max_pool(x, (w, w), (s, s), padding="SAME")`` over NHWC:
    SAME padding with -inf."""
    xc = x.permute(0, 3, 1, 2)
    xc, padding = _pad_same(xc, window, strides, value=-math.inf)
    return F.max_pool2d(xc, window, strides, padding=padding).permute(0, 2, 3, 1)


def _groups(channels: int) -> int:
    # 32 groups is the GN paper default; shrink until it divides (small
    # test widths).
    g = min(32, channels)
    while channels % g:
        g //= 2
    return max(g, 1)


class GroupNorm(nn.Module):
    """``flax.linen.GroupNorm(num_groups=_groups(C), epsilon=1e-6)`` with
    its output in the input's dtype, through ``fused_group_norm``; ``relu``
    fuses the ReLU that follows the norm."""

    def __init__(self, channels: int, relu: bool = False, zero_scale: bool = False):
        super().__init__()
        self.groups, self.relu = _groups(channels), relu
        self.weight = nn.Parameter(torch.full((channels,), 0.0 if zero_scale else 1.0))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # a contiguous NHWC view already (see Conv); .contiguous() copies
        # only if an op upstream handed back another memory format
        return fused_group_norm(x.contiguous(), self.weight, self.bias, self.groups,
                                GN_EPS, self.relu)


# Measurement-probe switch (tools/roofline.py): True = normal GroupNorm,
# False = every norm is identity (and a fused ReLU stays a ReLU), isolating
# the norm chain's cost. Never a training config.
_NORM_ENABLED = True


@contextlib.contextmanager
def ablate_norm():
    """Scope in which every ResNet norm built is identity. Model
    construction must happen inside the scope."""
    global _NORM_ENABLED
    _NORM_ENABLED = False
    try:
        yield
    finally:
        _NORM_ENABLED = True


def _norm(channels: int, relu: bool = False, zero_scale: bool = False) -> nn.Module:
    if not _NORM_ENABLED:
        return nn.ReLU() if relu else nn.Identity()
    return GroupNorm(channels, relu=relu, zero_scale=zero_scale)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 with 4x expansion; zero-init final norm scale so
    each residual branch starts as identity."""

    def __init__(self, in_features: int, features: int, strides: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.conv1 = _conv(in_features, features, 1, dtype=dtype)
        self.norm1 = _norm(features, relu=True)
        self.conv2 = _conv(features, features, 3, strides, dtype=dtype)
        self.norm2 = _norm(features, relu=True)
        self.conv3 = _conv(features, features * 4, 1, dtype=dtype)
        self.norm3 = _norm(features * 4, zero_scale=True)
        if in_features != features * 4 or strides != 1:
            self.proj = _conv(in_features, features * 4, 1, strides, dtype=dtype)
            self.proj_norm = _norm(features * 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm1(self.conv1(x))
        y = self.norm2(self.conv2(y))
        y = self.norm3(self.conv3(y))
        residual = self.proj_norm(self.proj(x)) if hasattr(self, "proj") else x
        return torch.relu(y + residual.to(y.dtype))


class BasicBlock(nn.Module):
    """3x3 -> 3x3, for ResNet-18/34 (small/test variants)."""

    def __init__(self, in_features: int, features: int, strides: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.conv1 = _conv(in_features, features, 3, strides, dtype=dtype)
        self.norm1 = _norm(features, relu=True)
        self.conv2 = _conv(features, features, 3, dtype=dtype)
        self.norm2 = _norm(features, zero_scale=True)
        if in_features != features or strides != 1:
            self.proj = _conv(in_features, features, 1, strides, dtype=dtype)
            self.proj_norm = _norm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm1(self.conv1(x))
        y = self.norm2(self.conv2(y))
        residual = self.proj_norm(self.proj(x)) if hasattr(self, "proj") else x
        return torch.relu(y + residual.to(y.dtype))


class ResNet(nn.Module):
    """NHWC float32 images [B, H, W, 3] -> float32 logits [B, classes].
    Submodule names are the reference's (``stem``, ``stem_norm``,
    ``stage{s}_block{i}``, ``classifier``), so the bridge maps them one to
    one. ``dtype`` is the compute type (the reference's bfloat16); float32
    serves checks of the arithmetic."""

    def __init__(self, depth: int = 50, num_classes: int = 1000, width: int = 64,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.depth, self.num_classes, self.width = depth, num_classes, width
        self.dtype = dtype
        self.stem = _conv(3, width, 7, 2, dtype=dtype)
        self.stem_norm = _norm(width, relu=True)
        block = BottleneckBlock if depth in BOTTLENECK else BasicBlock
        expansion = 4 if depth in BOTTLENECK else 1
        in_features = width
        self.block_names: List[str] = []
        for stage, n in enumerate(DEPTHS[depth]):
            features = width * 2 ** stage
            for i in range(n):
                name = f"stage{stage + 1}_block{i + 1}"
                strides = 2 if stage > 0 and i == 0 else 1
                self.add_module(name, block(in_features, features, strides, dtype))
                self.block_names.append(name)
                in_features = features * expansion
        self.classifier = nn.Linear(in_features, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem_norm(self.stem(x.to(self.dtype)))
        x = max_pool(x, 3, 2)
        for name in self.block_names:
            x = getattr(self, name)(x)
        # global average pool: jnp.mean over bfloat16 (float32 sum, bfloat16
        # result), then .astype(float32)
        x = x.mean(dim=(1, 2), dtype=torch.float32).to(self.dtype).float()
        return self.classifier(x)


def init_params(model: ResNet, generator: torch.Generator) -> ResNet:
    """The reference's initializers, drawn from ``generator``: conv kernels
    normal with variance 2 / fan_out (fan_out = out * kh * kw), norms as
    constructed (scale 1, or 0 at the end of a residual branch; bias 0),
    zero classifier."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Conv):
                o, _, kh, kw = m.weight.shape
                m.weight.normal_(0.0, math.sqrt(2.0 / (o * kh * kw)), generator=generator)
        model.classifier.weight.zero_()
        model.classifier.bias.zero_()
    return model


# -- synthetic learnable data -------------------------------------------------

_TEMPLATE_SEED = 4321


@functools.lru_cache(maxsize=None)
def _template(cls: int, image_size: int) -> np.ndarray:
    """ONE class's template, generated lazily from a per-class seed (the
    reference's, value for value)."""
    rng = np.random.default_rng(
        np.random.SeedSequence([_TEMPLATE_SEED, cls, image_size])
    )
    return rng.standard_normal((image_size, image_size, 3)).astype(np.float32)


def make_batch_fn(num_classes: int, image_size: int):
    """Class-conditional templates plus noise: the reference's batches,
    byte for byte, from the same ``np.random.Generator``."""

    def make_batch(rng: np.random.Generator, batch_size: int) -> Dict[str, np.ndarray]:
        y = rng.integers(0, num_classes, size=(batch_size,), dtype=np.int64)
        noise = rng.standard_normal((batch_size, image_size, image_size, 3))
        temps = np.stack([_template(int(c), image_size) for c in y])
        x = (0.6 * temps + noise).astype(np.float32)
        return {"image": x, "label": y.astype(np.int32)}

    return make_batch


def loss_and_metrics(logits: torch.Tensor, labels: torch.Tensor):
    """Mean softmax cross-entropy with integer labels, and accuracy."""
    labels = labels.long()
    loss = F.cross_entropy(logits, labels)
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, {"accuracy": acc}


def make_task(
    depth: int = 50,
    num_classes: int = 1000,
    image_size: int = 224,
    batch_size: int = 256,
    width: int = 64,
    targets: Optional[Dict[str, float]] = None,
) -> TrainTask:
    """Built inside ``ablate_norm()``, the task's model has identity norms."""
    norm_enabled = _NORM_ENABLED

    def init(generator: torch.Generator) -> ResNet:
        scope = contextlib.nullcontext() if norm_enabled else ablate_norm()
        with scope:
            return init_params(ResNet(depth, num_classes, width), generator)

    def loss_fn(model, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        return loss_and_metrics(model(batch["image"]), batch["label"])

    return TrainTask(
        name=f"resnet{depth}",
        init=init,
        loss_fn=loss_fn,
        make_batch=make_batch_fn(num_classes, image_size),
        batch_size=batch_size,
        targets=targets or {},
    )


def train(env: Dict[str, str], stop: Optional[Any] = None) -> List[Dict[str, float]]:
    """TPUJob entrypoint: ``tfk8s_tpu_torch.models.resnet:train``, with the
    reference's env contract (``TFK8S_RESNET_DEPTH``, ``TFK8S_BATCH_SIZE``,
    ``TFK8S_IMAGE_SIZE``, ``TFK8S_NUM_CLASSES``, ``TFK8S_RESNET_WIDTH``,
    ``TFK8S_TARGET_ACCURACY``) on one device: the card unless
    ``TFK8S_DEVICE=cpu``. Image-file input (``TFK8S_INPUT_FILES``) is
    ROADMAP item 1.5 and raises. Returns the logged metrics history."""
    env = dict(env)
    env.setdefault("TFK8S_TRAIN_STEPS", "100")
    env.setdefault("TFK8S_LEARNING_RATE", "1e-3")
    target = env.get("TFK8S_TARGET_ACCURACY")
    task = make_task(
        depth=int(env.get("TFK8S_RESNET_DEPTH", "50")),
        batch_size=int(env.get("TFK8S_BATCH_SIZE", "256")),
        image_size=int(env.get("TFK8S_IMAGE_SIZE", "224")),
        num_classes=int(env.get("TFK8S_NUM_CLASSES", "1000")),
        width=int(env.get("TFK8S_RESNET_WIDTH", "64")),
        targets={"accuracy": float(target)} if target else None,
    )
    return run_task(task, env, stop, device=select_device(env))
