"""BERT-base MLM pretraining (``BASELINE.json`` configs[2]) and the shared
encoder stack with a tied head, ported from the JAX package's
``models/bert.py``.

``BertWithHead`` is the stack: ``causal=False`` is BERT, ``causal=True``
the GPT stack; ``decode=True`` its incremental KV-cache mode and
``sow_kv=True`` the full forward that also returns every layer's K/V, as
the reference's flags at ``bert.py:43-100``. The MLM task keeps the
reference's hermetic chain-token stream, its 15% masking with
``MASK_ID`` (``make_batch_fn``, byte for byte from the same
``np.random.Generator``), and its float32 cross-entropy and accuracy over
the masked positions only (``mlm_loss_and_metrics``). ``train`` is the
``bert:train`` TPUJob entrypoint (``tfk8s_tpu_torch.models.bert:train``)
with the reference's env contract, on the card unless
``TFK8S_DEVICE=cpu``; with ``TFK8S_ATTENTION_IMPL=flash`` (or "auto" on
the card from ``FLASH_SEQ_THRESHOLD``) attention runs the non-causal
flash kernels, forward and backward. ``TFK8S_NUM_EXPERTS`` > 0 swaps every
other MLP for a ``SwitchMoeBlock`` (its aux loss in the objective and in
the metrics as ``moe_aux``); on a mesh with a sequence axis each rank
trains on its block of the sequence through ring or Ulysses attention; on
one with a tensor axis each rank holds its block of the heads, the MLP
and the vocabulary, and the loss is the vocab-parallel cross-entropy."""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from tfk8s_tpu_torch.models.transformer import (
    DecodeCache,
    Embedder,
    TransformerConfig,
    _ln,
    add_moe_aux,
    apply_with_aux,
    call_layer,
    init_params,
    make_layers,
    masked_token_loss,
    page_plan,
    select_attn_fn,
    seq_index,
    token_group,
)
from tfk8s_tpu_torch.parallel.tensor_parallel import TensorShard, init_sharded, vocab_split
from tfk8s_tpu_torch.runtime import pod_ranks
from tfk8s_tpu_torch.runtime.train import TrainTask, join_mesh, run_task

MASK_ID = 0  # reserved mask token; chain tokens live in [1, vocab)
_CHAIN_A, _CHAIN_B = 31, 17
_RESTART_P = 0.05
MASK_RATE = 0.15


class BertWithHead(nn.Module):
    """Encoder + tied-embedding head. ``attn_fn`` swaps the inner
    attention; ``causal=True`` makes every layer autoregressive, so the
    same stack serves the BERT and GPT families.

    The two mode flags change what a call takes and returns, as the
    reference's module flags do:
    - ``decode=True``: each call takes one token a row and the explicit
      ``cache`` (a :class:`DecodeCache`), and returns ``(logits, cache)``
      with the cache written in place and its position advanced;
    - ``sow_kv=True``: a full forward that returns ``(logits, kv)``, ``kv``
      being every layer's raw ``(k, v)`` projections in layer order
      (batched prefill seeds a decode cache from them).
    ``models/gpt.mode_view`` gives a module in another mode over the same
    parameters. ``mesh`` (a ``parallel.mesh.Mesh``) places the module on
    its rank's block of the sequence, share of the experts and tensor
    blocks (then the logits are its vocab columns)."""

    def __init__(self, cfg: TransformerConfig, attn_fn: Optional[Callable] = None,
                 causal: bool = False, decode: bool = False, sow_kv: bool = False,
                 mesh=None):
        super().__init__()
        if decode and sow_kv:
            raise ValueError("decode and sow_kv are separate modes")
        self.cfg = cfg
        self.decode, self.sow_kv = decode, sow_kv
        self.embed = Embedder(cfg, seq_index(mesh), TensorShard.of(mesh))
        self.layers = make_layers(cfg, attn_fn=attn_fn, causal=causal, mesh=mesh)
        self.ln_final = nn.LayerNorm(cfg.embed_dim, eps=cfg.ln_eps)

    def forward(self, ids: torch.Tensor, mask: Optional[torch.Tensor] = None,
                pos_offset: Union[int, torch.Tensor, None] = None,
                page_tables: Optional[torch.Tensor] = None,
                pages: Optional[Sequence[Tuple[torch.Tensor, torch.Tensor]]] = None,
                cache: Optional[DecodeCache] = None,
                attn_fn: Optional[Callable] = None,
                aux_sink: Optional[list] = None,
                ):
        """``pages`` (one ``(k, v)`` pool per layer) with ``page_tables``
        runs the block-paged path; ``pos_offset`` is then the per-row
        position vector and feeds both the positional gather and the
        page math (one :func:`page_plan` for every layer), as in the
        reference's ``paged=True`` stack. ``cache`` is the decode mode's
        cache (``pos_offset`` then the tokens' position, as in the
        reference a separate argument). ``attn_fn`` overrides the layers'
        attention for this call; ``aux_sink`` collects the MoE layers' aux
        losses."""
        if self.decode and cache is None:
            raise ValueError("decode mode needs the decode cache")
        if cache is not None and not self.decode:
            raise ValueError("a decode cache needs a decode-mode module")
        x = self.embed(ids, pos_offset=pos_offset)
        sown = [] if self.sow_kv else None
        attn_kw = dict(kv_sink=sown, attn_fn=attn_fn, aux_sink=aux_sink)
        if cache is not None:
            attn_kw["cache_index"] = cache.index
        plan = None
        if pages is not None:
            cfg = self.cfg
            if page_tables is None or not isinstance(pos_offset, torch.Tensor):
                raise ValueError("paged mode needs page_tables and a position vector")
            if not cfg.kv_page_size or not cfg.kv_max_pages:
                raise ValueError("paged mode needs cfg.kv_page_size and cfg.kv_max_pages")
            plan = page_plan(page_tables, pos_offset, ids.shape[-1], cfg.kv_page_size)
        for i, layer in enumerate(self.layers):
            if cache is not None:
                attn_kw["cache"] = (cache.keys[i], cache.values[i])
            if pages is not None:
                x = layer(x, mask, pool=pages[i], plan=plan, **attn_kw)
            else:
                x = call_layer(self.cfg, layer, x, mask, **attn_kw)
        x = _ln(self.ln_final, x, self.cfg.dtype)
        logits = self.embed.logits(x)  # [b, l, vocab], float32
        if cache is not None:
            return logits, cache.advanced(ids.shape[-1])
        if sown is not None:
            return logits, sown
        return logits


def make_chain_tokens(
    rng: np.random.Generator, batch_size: int, seq_len: int, vocab: int
) -> np.ndarray:
    """The hermetic token stream of the BERT and GPT families:
    ``t[i+1] = (a*t[i] + b) mod V`` with random restarts (a copy of the
    reference's numpy function: same rng draws, same tokens)."""
    toks = np.empty((batch_size, seq_len), np.int64)
    toks[:, 0] = rng.integers(1, vocab, size=batch_size)
    restarts = rng.random((batch_size, seq_len)) < _RESTART_P
    fresh = rng.integers(1, vocab, size=(batch_size, seq_len))
    for i in range(1, seq_len):
        nxt = (_CHAIN_A * toks[:, i - 1] + _CHAIN_B) % (vocab - 1) + 1
        toks[:, i] = np.where(restarts[:, i], fresh[:, i], nxt)
    return toks


def base_config(**overrides) -> TransformerConfig:
    """BERT-base: 12 layers / 768 hidden / 12 heads / 3072 mlp."""
    kw = dict(
        vocab_size=30522, embed_dim=768, num_heads=12, head_dim=64,
        mlp_dim=3072, num_layers=12, max_len=512,
    )
    kw.update(overrides)
    return TransformerConfig(**kw)


def tiny_config(**overrides) -> TransformerConfig:
    """Test-scale config (runs in seconds on the CPU)."""
    kw = dict(
        vocab_size=64, embed_dim=32, num_heads=4, head_dim=8,
        mlp_dim=64, num_layers=2, max_len=64,
    )
    kw.update(overrides)
    return TransformerConfig(**kw)


def make_batch_fn(vocab: int, seq_len: int):
    def make_batch(rng: np.random.Generator, batch_size: int) -> Dict[str, np.ndarray]:
        toks = make_chain_tokens(rng, batch_size, seq_len, vocab)
        mlm_mask = rng.random((batch_size, seq_len)) < MASK_RATE
        inputs = np.where(mlm_mask, MASK_ID, toks)
        return {
            "input": inputs.astype(np.int32),
            "target": toks.astype(np.int32),
            "mlm_mask": mlm_mask,
        }

    return make_batch


def mlm_loss_and_metrics(
    logits: torch.Tensor, batch: Dict[str, torch.Tensor], group=None, vocab=None,
    batch_blocks: int = 1,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Masked-LM objective: cross-entropy and accuracy over the mlm-masked
    positions only, of the global batch (over ``group``'s rows and tokens
    too, ``transformer.masked_token_loss``; ``vocab``: the logits are a
    vocab split's columns)."""
    loss, acc = masked_token_loss(logits, batch["target"], batch["mlm_mask"], group, vocab,
                                  batch_blocks)
    return loss, {"mlm_accuracy": acc}


def make_task(
    cfg: Optional[TransformerConfig] = None,
    seq_len: int = 128,
    batch_size: int = 64,
    targets: Optional[Dict[str, float]] = None,
    attn_fn: Optional[Callable] = None,
    mesh=None,
) -> TrainTask:
    cfg = cfg or base_config()
    seq_len = min(seq_len, cfg.max_len)
    (group, blocks), vocab = token_group(mesh), vocab_split(mesh, cfg.vocab_size)

    def init(generator: torch.Generator) -> BertWithHead:
        return init_sharded(lambda m: BertWithHead(cfg, attn_fn=attn_fn, mesh=m), init_params,
                            generator, mesh)

    def loss_fn(model, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        logits, aux = apply_with_aux(model, cfg, batch["input"])
        loss, metrics = mlm_loss_and_metrics(logits, batch, group, vocab, blocks)
        return add_moe_aux(cfg, loss, metrics, aux), metrics

    return TrainTask(
        name="bert-mlm",
        init=init,
        loss_fn=loss_fn,
        make_batch=make_batch_fn(cfg.vocab_size, seq_len),
        batch_size=batch_size,
        targets=targets or {},
    )


def task_for_mesh(
    mesh,
    cfg: Optional[TransformerConfig] = None,
    **task_kw,
) -> TrainTask:
    """Build the task with the attention impl the mesh calls for
    (``transformer.select_attn_fn``), at the EFFECTIVE length
    (``make_task`` clamps to ``cfg.max_len``). ``mesh`` is a
    ``parallel.mesh.Mesh``, or the device of a one-process run."""
    cfg = cfg or base_config()
    seq_len = min(task_kw.get("seq_len", 128), cfg.max_len)
    return make_task(cfg=cfg, attn_fn=select_attn_fn(cfg, seq_len, mesh), mesh=mesh, **task_kw)


@pod_ranks.entrypoint
def train(env: Dict[str, str], stop: Optional[Any] = None) -> List[Dict[str, float]]:
    """TPUJob entrypoint: ``tfk8s_tpu_torch.models.bert:train``, with the
    reference's env contract (``TFK8S_SEQ_LEN`` 128, ``TFK8S_BATCH_SIZE``
    64, 100 steps at lr 1e-4 unless set; ``TFK8S_MODEL_PRESET=tiny``;
    ``TFK8S_ATTENTION_IMPL``; ``TFK8S_NUM_EXPERTS``, ``TFK8S_MOE_TOP_K``),
    the runtime's input modes and the mesh's data, expert, sequence and
    tensor axes. Returns the logged metrics history."""
    env = dict(env)
    env.setdefault("TFK8S_TRAIN_STEPS", "100")
    env.setdefault("TFK8S_LEARNING_RATE", "1e-4")
    seq = int(env.get("TFK8S_SEQ_LEN", "128"))
    batch = int(env.get("TFK8S_BATCH_SIZE", "64"))
    preset = tiny_config if env.get("TFK8S_MODEL_PRESET") == "tiny" else base_config
    cfg = preset(
        num_experts=int(env.get("TFK8S_NUM_EXPERTS", "0")),
        moe_top_k=int(env.get("TFK8S_MOE_TOP_K", "1")),
        attention_impl=env.get("TFK8S_ATTENTION_IMPL", "auto"),
    )
    _ctx, device, mesh = join_mesh(env)
    task = task_for_mesh(mesh, cfg=cfg, seq_len=seq, batch_size=batch)
    return run_task(task, env, stop, device=device, mesh=mesh)
