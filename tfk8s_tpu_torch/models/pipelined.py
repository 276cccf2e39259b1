"""Pipeline-parallel BERT-MLM, ported from the JAX package's
``models/pipelined.py``: the encoder layers stream through the GPipe
schedule of ``parallel/pipeline.py``, ``num_layers / S`` layers a stage
over the mesh's ``pipeline`` axis; the embedding, the final norm (float32,
cast to ``cfg.dtype``) and the tied head have other shapes, so they stay
outside the pipeline region and every rank of a pipeline group runs them
alike on the outputs the last stage hands to all.

Each rank builds only its own stage (:class:`PipelineStage`), its layers
named by their global index (``layers.{s * L / S + j}``), so a rank's
parameter names, and a checkpoint's, are those of the whole model
(``bert.BertWithHead``'s) whatever the stage count, and every layer draws
its initial parameters from a generator of its own global index: every
stage count starts from the same model. With no ``pipeline`` axis one
process is one stage holding every layer.

A ``data`` axis composes with it, the reference's ``pipeline_apply(
data_axis=...)``: each data rank pipelines the microbatches of its own
rows. The loss is the reference's masked mean over the global batch (the
masked positions summed over the data group); its gradient is scaled by
the data size, so the data group's gradient average is the global one.
The stages run plain attention, as the reference's do: ``make_task``
takes ``attention_impl`` auto or full only, and no MoE.

``train`` is the ``pipelined:train`` TPUJob entrypoint
(``tfk8s_tpu_torch.models.pipelined:train``) with the reference's env
contract, on the card unless ``TFK8S_DEVICE=cpu``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from tfk8s_tpu_torch.models import bert
from tfk8s_tpu_torch.models.transformer import (
    Embedder,
    EncoderLayer,
    TransformerConfig,
    _ln,
    call_layer,
    init_params,
)
from tfk8s_tpu_torch.parallel.mesh import AXIS_DATA, AXIS_PIPELINE, BATCH_AXES, Mesh
from tfk8s_tpu_torch.parallel.pipeline import pipeline_apply, split_microbatches
from tfk8s_tpu_torch.runtime.train import TrainTask, join_mesh, run_task


class PipelineStage(nn.ModuleDict):
    """One pipeline stage: a run of encoder layers under their global
    indices (a uniform activation shape in and out, the inter-stage
    contract); each is recomputed in the backward under ``cfg.remat``."""

    pipeline_stage = True

    def __init__(self, cfg: TransformerConfig, layers_per_stage: int, stage: int = 0):
        first = stage * layers_per_stage
        super().__init__({str(first + j): EncoderLayer(cfg) for j in range(layers_per_stage)})
        self.cfg = cfg

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.values():
            x = call_layer(self.cfg, layer, x)
        return x


class PipelinedBert(nn.Module):
    """The embedding, this rank's stage and the final norm; the forward
    gives the tied head's float32 logits of its rows, the stage run in
    pipeline over ``mesh`` (a ``parallel.mesh.Mesh`` or, for one process,
    its device) with ``num_micro`` microbatches."""

    def __init__(self, cfg: TransformerConfig, mesh, num_micro: int):
        super().__init__()
        self.cfg, self.mesh, self.num_micro = cfg, mesh, num_micro
        stages = mesh.size(AXIS_PIPELINE) if isinstance(mesh, Mesh) else 1
        stage = mesh.index(AXIS_PIPELINE) if isinstance(mesh, Mesh) else 0
        self.embed = Embedder(cfg)
        self.layers = PipelineStage(cfg, cfg.num_layers // stages, stage)
        self.ln_final = nn.LayerNorm(cfg.embed_dim, eps=cfg.ln_eps)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        x = self.embed(ids)
        y = pipeline_apply(self.layers, split_microbatches(x, self.num_micro), self.mesh)
        y = _ln(self.ln_final, y.reshape(x.shape), self.cfg.dtype)
        return self.embed.logits(y)


def init_model(model: PipelinedBert, generator: torch.Generator) -> PipelinedBert:
    """The reference's initializers: one seed a layer drawn first, then the
    embedding from ``generator``, and each layer from a generator seeded
    by its global index's seed, so a stage holds the layers every stage
    count gives it."""
    seeds = torch.randint(2 ** 62, (model.cfg.num_layers,), generator=generator)
    init_params(model.embed, generator)
    init_params(model.ln_final, generator)
    for index, layer in model.layers.items():
        init_params(layer, torch.Generator().manual_seed(int(seeds[int(index)])))
    return model


def make_task(
    mesh,
    cfg: Optional[TransformerConfig] = None,
    seq_len: int = 64,
    batch_size: int = 32,
    num_micro: Optional[int] = None,
    targets: Optional[Dict[str, float]] = None,
) -> TrainTask:
    """The pipelined MLM task over ``mesh`` (a ``parallel.mesh.Mesh`` whose
    ``pipeline`` axis holds the stages and whose ``data`` axis, if any,
    splits the rows; or a device: one stage), with the reference's checks,
    each an ``AssertionError``: no MoE, attention auto or full, layers
    dividing into stages, the batch into microbatches and a microbatch's
    rows over data."""
    cfg = cfg or bert.tiny_config()
    if cfg.num_experts != 0:
        raise AssertionError(
            "pipelined family does not support MoE stages yet; use the "
            "BERT/T5 MoE path (TransformerConfig.num_experts) on a non-"
            "pipeline mesh")
    if cfg.attention_impl not in ("auto", "full"):
        raise AssertionError(
            f"pipelined family supports only full attention inside stages, "
            f"got {cfg.attention_impl!r}")
    is_mesh = isinstance(mesh, Mesh)
    num_stages = mesh.size(AXIS_PIPELINE) if is_mesh else 1
    if cfg.num_layers % num_stages:
        raise AssertionError(
            f"num_layers {cfg.num_layers} must divide evenly into {num_stages} stages")
    num_micro = num_micro or max(2 * num_stages, 4)
    if batch_size % num_micro:
        raise AssertionError(f"batch {batch_size} must divide into {num_micro} microbatches")
    micro_bs = batch_size // num_micro
    data = mesh.size(AXIS_DATA) if is_mesh else 1
    if is_mesh and AXIS_DATA in mesh.axis_names and micro_bs % data:
        raise AssertionError(
            f"microbatch size {micro_bs} (batch {batch_size} / "
            f"{num_micro} microbatches) must divide over the data axis "
            f"({data} shards)")
    seq_len = min(seq_len, cfg.max_len)
    group = mesh.group(*BATCH_AXES) if is_mesh else None

    def init(generator: torch.Generator) -> PipelinedBert:
        return init_model(PipelinedBert(cfg, mesh, num_micro), generator)

    def loss_fn(model, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        return bert.mlm_loss_and_metrics(model(batch["input"]), batch, group,
                                         batch_blocks=data)

    return TrainTask(
        name="bert-mlm-pipelined",
        init=init,
        loss_fn=loss_fn,
        make_batch=bert.make_batch_fn(cfg.vocab_size, seq_len),
        batch_size=batch_size,
        targets=targets or {},
    )


def train(env: Dict[str, str], stop: Optional[Any] = None) -> List[Dict[str, float]]:
    """TPUJob entrypoint: ``tfk8s_tpu_torch.models.pipelined:train``, with
    the reference's env contract: ``TFK8S_MESH`` with a ``pipeline`` axis
    (and ``data``; none: one stage), 100 steps at lr 1e-3 unless set,
    BERT-base with ``TFK8S_NUM_LAYERS`` layers (default 12),
    ``TFK8S_SEQ_LEN`` 128, ``TFK8S_BATCH_SIZE`` 64 and ``TFK8S_NUM_MICRO``
    microbatches (default ``max(2 * stages, 4)``); and the port's
    ``TFK8S_MODEL_PRESET=tiny``. Returns the logged metrics history."""
    env = dict(env)
    env.setdefault("TFK8S_TRAIN_STEPS", "100")
    env.setdefault("TFK8S_LEARNING_RATE", "1e-3")
    preset = bert.tiny_config if env.get("TFK8S_MODEL_PRESET") == "tiny" else bert.base_config
    layers = env.get("TFK8S_NUM_LAYERS")
    cfg = preset(**({"num_layers": int(layers)} if layers else {}))
    _ctx, device, mesh = join_mesh(env)
    task = make_task(
        mesh,
        cfg=cfg,
        seq_len=int(env.get("TFK8S_SEQ_LEN", "128")),
        batch_size=int(env.get("TFK8S_BATCH_SIZE", "64")),
        num_micro=int(env["TFK8S_NUM_MICRO"]) if env.get("TFK8S_NUM_MICRO") else None,
    )
    return run_task(task, env, stop, device=device, mesh=mesh)
