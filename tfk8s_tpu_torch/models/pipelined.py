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
masked positions summed over the batch and sequence groups,
``transformer.token_group``); its gradient is scaled by the batch axes'
size, so the gradient average every layout takes is the global one. The
stages run plain attention, as the reference's do: ``make_task`` takes
``attention_impl`` auto or full only, and no MoE.

Beside the other axes the stages keep the reference's layout (its
pipeline region is a manual ``shard_map`` over pipeline and data, its
stage parameters built with ``partition_params=False``): a microbatch is
split over ``data`` alone, every stage sees whole sequences, and the
numbers are one process's:

- ``tensor``: the stages' layers hold their column and row blocks
  (``EncoderLayer(tp=...)``) and run their tensor sums inside each tick,
  every tensor rank of a stage alike; the embedding is the vocab-parallel
  table and tied head, and the loss the vocab-parallel cross-entropy;
- ``fsdp``: a rank holds its rows of the batch, as in every family, and
  pipelines its data block's rows (the fsdp group's ids gathered), so a
  microbatch is the reference's; it then keeps its own rows for the
  final norm, the head and the loss; the parameters are
  ``data_parallel.FsdpShards``';
- ``sequence``: every sequence rank takes its rows' whole sequences (the
  task's ``split_sequence`` keeps them whole) through the stages; the
  head and the loss take its block of the positions only
  (:func:`sequence_share`), so its gradient is its tokens' part, and the
  reduction's sum over the sequence group counts every token once;
- ``expert``: the family has no MoE layer, so an expert rank holds the
  rows and parameters of its expert peers: a replica.

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
    token_group,
)
from tfk8s_tpu_torch.parallel.collectives import all_gather, group_rank
from tfk8s_tpu_torch.parallel.mesh import (
    AXIS_DATA,
    AXIS_FSDP,
    AXIS_PIPELINE,
    AXIS_SEQUENCE,
    BATCH_AXES,
    Mesh,
)
from tfk8s_tpu_torch.parallel.pipeline import pipeline_apply, split_microbatches
from tfk8s_tpu_torch.parallel.tensor_parallel import TensorShard, init_sharded, vocab_split
from tfk8s_tpu_torch.runtime import pod_ranks
from tfk8s_tpu_torch.runtime.train import TrainTask, join_mesh, keep_sequence, run_task


class PipelineStage(nn.ModuleDict):
    """One pipeline stage: a run of encoder layers under their global
    indices (a uniform activation shape in and out, the inter-stage
    contract), holding ``tp``'s blocks on a tensor mesh; each is
    recomputed in the backward under ``cfg.remat``."""

    pipeline_stage = True

    def __init__(self, cfg: TransformerConfig, layers_per_stage: int, stage: int = 0,
                 tp: Optional[TensorShard] = None):
        first = stage * layers_per_stage
        super().__init__({str(first + j): EncoderLayer(cfg, tp=tp)
                          for j in range(layers_per_stage)})
        self.cfg = cfg

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.values():
            x = call_layer(self.cfg, layer, x)
        return x


def sequence_share(mesh) -> Tuple[object, int, int]:
    """``(group, block, blocks)``: the group the loss's masked mean sums
    over (the batch and sequence axes) and this rank's block of the
    ``blocks`` equal blocks of the positions, the ones it takes the head
    and the loss over."""
    if not isinstance(mesh, Mesh):
        return None, 0, 1
    return token_group(mesh)[0], mesh.index(AXIS_SEQUENCE), mesh.size(AXIS_SEQUENCE)


def _positions(t: torch.Tensor, block: int, blocks: int) -> torch.Tensor:
    """Block ``block`` of ``blocks`` of ``t``'s axis 1 (the positions)."""
    if t.shape[1] % blocks:
        raise ValueError(f"length {t.shape[1]} does not divide over sequence={blocks}")
    n = t.shape[1] // blocks
    return t[:, block * n:(block + 1) * n]


class PipelinedBert(nn.Module):
    """The embedding, this rank's stage and the final norm; the forward
    gives the tied head's float32 logits of its rows, the stage run in
    pipeline over ``mesh`` (a ``parallel.mesh.Mesh`` or, for one process,
    its device) with ``num_micro`` microbatches; with ``tp`` the stage's
    layers and the embedding hold that rank's tensor blocks."""

    def __init__(self, cfg: TransformerConfig, mesh, num_micro: int,
                 tp: Optional[TensorShard] = None):
        super().__init__()
        self.cfg, self.mesh, self.num_micro = cfg, mesh, num_micro
        is_mesh = isinstance(mesh, Mesh)
        stages = mesh.size(AXIS_PIPELINE) if is_mesh else 1
        stage = mesh.index(AXIS_PIPELINE) if is_mesh else 0
        # the ranks whose rows make up this rank's data block
        self.rows_group = mesh.group(AXIS_FSDP) if is_mesh else None
        self.embed = Embedder(cfg, 0, tp)
        self.layers = PipelineStage(cfg, cfg.num_layers // stages, stage, tp)
        self.ln_final = nn.LayerNorm(cfg.embed_dim, eps=cfg.ln_eps)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        """``ids``: this rank's rows, whole sequences. The logits are its
        rows' at its block of the positions (its vocab columns on a tensor
        mesh)."""
        x = self.embed(all_gather(ids, 0, self.rows_group))
        y = pipeline_apply(self.layers, split_microbatches(x, self.num_micro), self.mesh)
        first = group_rank(self.rows_group) * ids.shape[0]
        _, block, blocks = sequence_share(self.mesh)
        y = _positions(y.reshape(x.shape)[first:first + ids.shape[0]], block, blocks)
        return self.embed.logits(_ln(self.ln_final, y, self.cfg.dtype))


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
    ``pipeline`` axis holds the stages, or a device: one stage), with the
    reference's checks, each an ``AssertionError``: no MoE, attention auto
    or full, layers dividing into stages, the batch into microbatches and
    a microbatch's rows over data. The other axes take the reference's
    layout (the module docstring)."""
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
    vocab = vocab_split(mesh, cfg.vocab_size)
    blocks = mesh.size(*BATCH_AXES) if is_mesh else 1

    def init(generator: torch.Generator) -> PipelinedBert:
        # on a tensor mesh: the stage whole (``build(None)``), then its blocks
        return init_sharded(lambda m: PipelinedBert(cfg, mesh, num_micro, TensorShard.of(m)),
                            init_model, generator, mesh)

    def loss_fn(model, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        group, block, n = sequence_share(mesh)
        own = {k: _positions(batch[k], block, n) for k in ("target", "mlm_mask")}
        return bert.mlm_loss_and_metrics(model(batch["input"]), own, group, vocab, blocks)

    return TrainTask(
        name="bert-mlm-pipelined",
        init=init,
        loss_fn=loss_fn,
        make_batch=bert.make_batch_fn(cfg.vocab_size, seq_len),
        batch_size=batch_size,
        targets=targets or {},
        split_sequence=keep_sequence,
    )


@pod_ranks.entrypoint
def train(env: Dict[str, str], stop: Optional[Any] = None) -> List[Dict[str, float]]:
    """TPUJob entrypoint: ``tfk8s_tpu_torch.models.pipelined:train``, with
    the reference's env contract: ``TFK8S_MESH`` with a ``pipeline`` axis
    (beside any other; none: one stage), 100 steps at lr 1e-3 unless set,
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
