"""ViT image classifier, ported from the JAX package's ``models/vit.py``:
patches -> linear embed (+ learned positions) -> the shared encoder stack
(``transformer.EncoderLayer``, the same as BERT's and GPT's) -> mean-pool
-> linear head, and the ``vit:train`` TPUJob entrypoint
(``tfk8s_tpu_torch.models.vit:train``).

Numerics kept from the reference so the same bridged parameters give the
same numbers:
- NHWC images are cut into patches in the order (grid row, grid col,
  patch row, patch col, channel);
- ``patch_embed`` runs in ``cfg.dtype`` and the float32 ``pos`` parameter
  is added before the cast to ``cfg.dtype``;
- the mean-pool over tokens reduces ``cfg.dtype`` values in float32 and
  rounds the mean back to ``cfg.dtype`` (``jnp.mean`` over bfloat16);
- the ``head`` is a float32 dense layer.

Batches are the class-conditional templates ResNet trains on
(``models/resnet.make_batch_fn``, the reference's byte for byte). The
image size fixes the number of patches, and so the shape of ``pos``: the
module takes it at construction, where the reference infers it at init.
ViT-B/16 at 224 has 196 patches, a sequence that is not a multiple of the
flash kernels' tiles; the kernels mask the ragged edge.

``TFK8S_NUM_EXPERTS`` > 0 interleaves ``SwitchMoeBlock``s as the text
families do. On a sequence-sharded mesh each rank embeds its block of the
patch sequence; the mean-pool sums the blocks over the sequence group, and
the head and loss after it, computed alike on every rank, carry ``1 / n``
of the gradient each (``collectives.sum_replicated``, ``scale_grad``). On
a tensor mesh the encoder layers hold their rank's heads and MLP block;
``patch_embed``, ``pos`` and the float32 head stay whole on every rank, as
the reference's rules leave them.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from tfk8s_tpu_torch.models import resnet
from tfk8s_tpu_torch.models.transformer import (
    TransformerConfig,
    _dense,
    _ln,
    add_moe_aux,
    apply_with_aux,
    call_layer,
    init_params,
    make_layers,
    select_attn_fn,
    seq_group,
    seq_index,
)
from tfk8s_tpu_torch.parallel.collectives import group_size, scale_grad, sum_replicated
from tfk8s_tpu_torch.parallel.tensor_parallel import init_sharded
from tfk8s_tpu_torch.runtime import pod_ranks
from tfk8s_tpu_torch.runtime.train import TrainTask, join_mesh, run_task


CHANNELS = 3  # RGB: what every image batch of the repo holds


class ViT(nn.Module):
    """NHWC float32 images ``[b, image_size, image_size, 3]`` ->
    float32 logits ``[b, num_classes]``. Mean-pool instead of a CLS token,
    as the reference."""

    def __init__(self, cfg: TransformerConfig, num_classes: int, patch_size: int,
                 image_size: int, attn_fn: Optional[Callable] = None, mesh=None):
        super().__init__()
        if image_size % patch_size:
            raise ValueError(f"image {image_size}x{image_size} not divisible by patch {patch_size}")
        self.cfg, self.patch_size = cfg, patch_size
        self.grid = image_size // patch_size
        self.patch_embed = nn.Linear(patch_size * patch_size * CHANNELS, cfg.embed_dim)
        self.pos = nn.Parameter(torch.empty(self.grid * self.grid, cfg.embed_dim))
        self.layers = make_layers(cfg, attn_fn=attn_fn, mesh=mesh)
        self.ln_final = nn.LayerNorm(cfg.embed_dim, eps=cfg.ln_eps)
        self.head = nn.Linear(cfg.embed_dim, num_classes)
        self.seq_index, self.seq_group = seq_index(mesh), seq_group(mesh)

    def forward(self, images: torch.Tensor, aux_sink: Optional[list] = None) -> torch.Tensor:
        cfg, p = self.cfg, self.patch_size
        b, h, w, c = images.shape
        if h % p or w % p:
            raise ValueError(f"image {h}x{w} not divisible by patch {p}")
        gh, gw = h // p, w // p
        if gh * gw != self.pos.shape[0]:
            raise ValueError(f"{gh * gw} patches, but the positions were built for "
                             f"{self.pos.shape[0]}")
        x = images.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
        x, pos = x.reshape(b, gh * gw, p * p * c), self.pos
        sp = group_size(self.seq_group)
        if sp > 1:
            # this rank's block of the patch sequence
            if (gh * gw) % sp:
                raise ValueError(f"{gh * gw} patches do not divide over sequence={sp}")
            blk = gh * gw // sp
            rows = slice(self.seq_index * blk, (self.seq_index + 1) * blk)
            x, pos = x[:, rows], pos[rows]
        x = (_dense(self.patch_embed, x, cfg.dtype) + pos[None]).to(cfg.dtype)
        for layer in self.layers:
            x = call_layer(cfg, layer, x, None, aux_sink=aux_sink)
        x = _ln(self.ln_final, x, cfg.dtype)
        if sp == 1:
            return _dense(self.head, mean_pool(x), torch.float32)
        pooled = sum_replicated(x.sum(dim=1, dtype=torch.float32), self.seq_group)
        logits = _dense(self.head, (pooled / (gh * gw)).to(x.dtype), torch.float32)
        return scale_grad(logits, 1.0 / sp)


def mean_pool(x: torch.Tensor) -> torch.Tensor:
    """The mean over tokens ``[b, l, e] -> [b, e]`` as ``jnp.mean`` takes
    it: summed in float32, the mean rounded back to ``x``'s dtype."""
    return x.mean(dim=1, dtype=torch.float32).to(x.dtype)


def init_vit(model: ViT, generator: torch.Generator) -> ViT:
    """The reference's initializers: xavier-uniform dense kernels and zero
    biases (``transformer.init_params``), normal(0.02) positions."""
    init_params(model, generator)
    with torch.no_grad():
        model.pos.normal_(0.0, 0.02, generator=generator)
    return model


def base_config(**overrides) -> TransformerConfig:
    """ViT-Base scale: 12 layers / 768 / 12 heads / 3072 (vocab unused:
    images enter through the patch projection)."""
    kw = dict(
        vocab_size=1, embed_dim=768, num_heads=12, head_dim=64,
        mlp_dim=3072, num_layers=12, max_len=1024,
    )
    kw.update(overrides)
    return TransformerConfig(**kw)


def tiny_config(**overrides) -> TransformerConfig:
    kw = dict(
        vocab_size=1, embed_dim=32, num_heads=4, head_dim=8,
        mlp_dim=64, num_layers=2, max_len=256,
    )
    kw.update(overrides)
    return TransformerConfig(**kw)


def make_task(
    cfg: Optional[TransformerConfig] = None,
    num_classes: int = 8,
    image_size: int = 32,
    patch_size: int = 4,
    batch_size: int = 64,
    targets: Optional[Dict[str, float]] = None,
    attn_fn: Optional[Callable] = None,
    mesh=None,
) -> TrainTask:
    cfg = cfg or tiny_config()

    def init(generator: torch.Generator) -> ViT:
        return init_sharded(lambda m: ViT(cfg, num_classes, patch_size, image_size,
                                          attn_fn=attn_fn, mesh=m), init_vit, generator, mesh)

    def loss_fn(model, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        logits, aux = apply_with_aux(model, cfg, batch["image"])
        loss, metrics = resnet.loss_and_metrics(logits, batch["label"])
        return add_moe_aux(cfg, loss, metrics, aux), metrics

    return TrainTask(
        name="vit",
        init=init,
        loss_fn=loss_fn,
        make_batch=resnet.make_batch_fn(num_classes, image_size),
        batch_size=batch_size,
        targets=targets or {},
        # whole images: the model takes its block of the patch sequence
        split_sequence=lambda batch, index, n: batch,
    )


def task_for_mesh(mesh, cfg: Optional[TransformerConfig] = None, **task_kw) -> TrainTask:
    """The shared attention policy (``transformer.select_attn_fn``) at the
    patch sequence's length; ``mesh`` is a ``parallel.mesh.Mesh`` or the
    device of a one-process run."""
    cfg = cfg or tiny_config()
    seq_len = (task_kw.get("image_size", 32) // task_kw.get("patch_size", 4)) ** 2
    return make_task(cfg=cfg, attn_fn=select_attn_fn(cfg, seq_len, mesh), mesh=mesh, **task_kw)


@pod_ranks.entrypoint
def train(env: Dict[str, str], stop: Optional[Any] = None) -> List[Dict[str, float]]:
    """TPUJob entrypoint: ``tfk8s_tpu_torch.models.vit:train``, with the
    reference's env contract (``TFK8S_NUM_CLASSES`` 8, ``TFK8S_IMAGE_SIZE``
    32, ``TFK8S_PATCH_SIZE`` 4, ``TFK8S_BATCH_SIZE`` 64, 150 steps at lr
    1e-3 unless set; ``TFK8S_MODEL_PRESET=tiny``; ``TFK8S_ATTENTION_IMPL``;
    ``TFK8S_TARGET_ACCURACY``), on the card unless ``TFK8S_DEVICE=cpu``.
    Image shards train it with ``TFK8S_INPUT_FILES`` and
    ``TFK8S_INPUT_FORMAT=image`` (packed by ``python -m
    tfk8s_tpu_torch.data.images.pack``): JPEG/PNG records decoded and
    augmented on a worker pool into the batch schema the synthetic
    generator makes, at ``TFK8S_IMAGE_SIZE``. Returns the logged metrics
    history."""
    env = dict(env)
    env.setdefault("TFK8S_TRAIN_STEPS", "150")
    env.setdefault("TFK8S_LEARNING_RATE", "1e-3")
    preset = tiny_config if env.get("TFK8S_MODEL_PRESET") == "tiny" else base_config
    cfg = preset(
        attention_impl=env.get("TFK8S_ATTENTION_IMPL", "auto"),
        num_experts=int(env.get("TFK8S_NUM_EXPERTS", "0")),
        moe_top_k=int(env.get("TFK8S_MOE_TOP_K", "1")),
    )
    _ctx, device, mesh = join_mesh(env)
    target = env.get("TFK8S_TARGET_ACCURACY")
    task = task_for_mesh(
        mesh,
        cfg=cfg,
        num_classes=int(env.get("TFK8S_NUM_CLASSES", "8")),
        image_size=int(env.get("TFK8S_IMAGE_SIZE", "32")),
        patch_size=int(env.get("TFK8S_PATCH_SIZE", "4")),
        batch_size=int(env.get("TFK8S_BATCH_SIZE", "64")),
        targets={"accuracy": float(target)} if target else None,
    )
    return run_task(task, env, stop, device=device, mesh=mesh)
