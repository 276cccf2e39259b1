"""T5-base encoder-decoder (``BASELINE.json`` configs[3]), ported from the
JAX package's ``models/t5.py``: the shared pre-LN blocks with learned
positions and one tied embedding table (not T5's relative-position biases
or RMSNorm, as in the reference), the hermetic reversal task, KV-cache
generation (greedy, sampled, beam) and the ``t5:train`` TPUJob entrypoint
(``tfk8s_tpu_torch.models.t5:train``).

The encoder's key mask is ``src != PAD_ID``; it masks the encoder's
self-attention and the decoder's cross-attention, so on the card with
flash chosen the encoder and the cross-attention run the masked flash
kernels and the decoder's self-attention the causal ones. Parameter names
are the reference's (``embed``, ``enc{i}``, ``dec{i}``, ``enc_ln``,
``dec_ln``); ``bridge.t5_params_to_state_dict`` maps them.

With ``cfg.num_experts`` > 0 the ENCODER layers interleave
``SwitchMoeBlock``s (the decoder stays dense, as the reference's), their
aux loss in the objective; on a sequence-sharded mesh each rank holds its
block of the source and of the target, and the cross-attention runs ring
or Ulysses attention over the encoder's blocks. On a tensor mesh every
attention (the decoder's cross-attention too) and MLP holds its rank's
block of the heads and hidden width, the shared table its block of rows,
and the loss is the vocab-parallel cross-entropy (``BASELINE.json``
configs[3]: ``{"data": 2, "tensor": 2}``).

Generation takes the module, not a parameter tree, and runs the encoder
once through the module's attention (the masked flash forward on the card
when flash is chosen; the reference encodes with plain attention, the
deviation ``gpt.prefill_cache`` also makes), then one decoder step a
token: the self-attention over a :class:`transformer.DecodeCache`, the
cross-attention a plain attention of one query over the encoder output,
its K/V recomputed every step, as the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from tfk8s_tpu_torch.models import gpt
from tfk8s_tpu_torch.models.transformer import (
    DecodeCache,
    DecoderLayer,
    Embedder,
    EncoderLayer,
    TransformerConfig,
    _ln,
    add_moe_aux,
    apply_with_aux,
    cache_heads,
    call_layer,
    clean_cache,
    dot_product_attention,
    init_params,
    masked_token_loss,
    select_attn_fn,
    seq_index,
    token_group,
)
from tfk8s_tpu_torch.ops import jax_random
from tfk8s_tpu_torch.parallel.moe import ExpertShard
from tfk8s_tpu_torch.parallel.tensor_parallel import TensorShard, init_sharded, vocab_split
from tfk8s_tpu_torch.runtime import pod_ranks
from tfk8s_tpu_torch.runtime.train import TrainTask, join_mesh, run_task

PAD_ID = 0
BOS_ID = 1
# real tokens live in [2, vocab)


class T5(nn.Module):
    """Encoder-decoder with a shared embedding table and tied head.
    ``attn_fn`` swaps the inner attention of every layer (the flash
    kernels plug in here; they take the ``[b, lk]`` key mask). ``mesh`` places it on its
    rank's sequence blocks, share of the encoder's experts and tensor
    blocks (then the logits are its vocab columns)."""

    def __init__(self, cfg: TransformerConfig, attn_fn: Optional[Callable] = None, mesh=None):
        super().__init__()
        self.cfg = cfg
        tp = TensorShard.of(mesh)
        self.embed = Embedder(cfg, seq_index(mesh), tp)
        experts = ExpertShard.of(mesh)
        for i in range(cfg.num_layers):
            self.add_module(f"enc{i}", EncoderLayer(cfg, attn_fn=attn_fn,
                                                    use_moe=cfg.layer_uses_moe(i),
                                                    experts=experts, tp=tp))
        for i in range(cfg.num_layers):
            self.add_module(f"dec{i}", DecoderLayer(cfg, attn_fn=attn_fn, tp=tp))
        self.enc_ln = nn.LayerNorm(cfg.embed_dim, eps=cfg.ln_eps)
        self.dec_ln = nn.LayerNorm(cfg.embed_dim, eps=cfg.ln_eps)

    def encoder_layers(self) -> List[EncoderLayer]:
        return [getattr(self, f"enc{i}") for i in range(self.cfg.num_layers)]

    def decoder_layers(self) -> List[DecoderLayer]:
        return [getattr(self, f"dec{i}") for i in range(self.cfg.num_layers)]

    def encode(self, src: torch.Tensor, aux_sink: Optional[list] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``src [b, ls]`` -> (encoder output ``[b, ls, embed]`` in
        ``cfg.dtype``, key mask ``src != PAD_ID``); the MoE layers' aux
        losses go to ``aux_sink``."""
        mask = src != PAD_ID
        x = self.embed(src)
        for layer in self.encoder_layers():
            x = call_layer(self.cfg, layer, x, mask, aux_sink=aux_sink)
        return _ln(self.enc_ln, x, self.cfg.dtype), mask

    def decode(self, tgt_in: torch.Tensor, enc: torch.Tensor, enc_mask: torch.Tensor,
               pos_offset: Any = None, cache: Optional[DecodeCache] = None,
               attn_fn: Optional[Callable] = None):
        """Teacher-forced decoder over ``tgt_in [b, lt]`` -> float32 logits
        ``[b, lt, vocab]``. With a decode ``cache`` it takes one token a row
        at position ``pos_offset`` (default the cache's) and returns
        ``(logits, cache)``, the cache written in place and advanced.
        ``attn_fn`` overrides the layers' attention for this call."""
        if cache is not None and pos_offset is None:
            pos_offset = cache.index
        x = self.embed(tgt_in, pos_offset=pos_offset)
        for i, layer in enumerate(self.decoder_layers()):
            kw = {} if cache is None else dict(cache=(cache.keys[i], cache.values[i]),
                                               cache_index=cache.index)
            x = call_layer(self.cfg, layer, x, enc, enc_mask, attn_fn=attn_fn, **kw)
        logits = self.embed.logits(_ln(self.dec_ln, x, self.cfg.dtype))
        if cache is not None:
            return logits, cache.advanced(tgt_in.shape[-1])
        return logits

    def forward(self, src: torch.Tensor, tgt_in: torch.Tensor,
                aux_sink: Optional[list] = None) -> torch.Tensor:
        enc, mask = self.encode(src, aux_sink)
        return self.decode(tgt_in, enc, mask)


def base_config(**overrides) -> TransformerConfig:
    """T5-base scale: 12 + 12 layers / 768 / 12 heads / 3072."""
    kw = dict(
        vocab_size=32128, embed_dim=768, num_heads=12, head_dim=64,
        mlp_dim=3072, num_layers=12, max_len=512,
    )
    kw.update(overrides)
    return TransformerConfig(**kw)


def tiny_config(**overrides) -> TransformerConfig:
    kw = dict(
        vocab_size=64, embed_dim=32, num_heads=4, head_dim=8,
        mlp_dim=64, num_layers=2, max_len=64,
    )
    kw.update(overrides)
    return TransformerConfig(**kw)


def make_batch_fn(vocab: int, seq_len: int):
    """The reversal task: target = reversed(source), decoder input BOS +
    the target shifted right (the reference's batches, byte for byte)."""

    def make_batch(rng: np.random.Generator, batch_size: int) -> Dict[str, np.ndarray]:
        src = rng.integers(2, vocab, size=(batch_size, seq_len))
        tgt = src[:, ::-1]
        tgt_in = np.concatenate(
            [np.full((batch_size, 1), BOS_ID, np.int64), tgt[:, :-1]], axis=1
        )
        return {
            "src": src.astype(np.int32),
            "tgt_in": tgt_in.astype(np.int32),
            "tgt_out": tgt.astype(np.int32),
        }

    return make_batch


def loss_and_metrics(logits: torch.Tensor, tgt_out: torch.Tensor, group=None, vocab=None,
                     batch_blocks: int = 1) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Cross-entropy and accuracy over the target positions that are not
    ``PAD_ID``, of the global batch (over ``group``'s rows and tokens too,
    ``transformer.masked_token_loss``; ``vocab``: the logits are a vocab
    split's columns)."""
    loss, acc = masked_token_loss(logits, tgt_out, tgt_out != PAD_ID, group, vocab,
                                  batch_blocks)
    return loss, {"token_accuracy": acc}


def make_task(
    cfg: Optional[TransformerConfig] = None,
    seq_len: int = 128,
    batch_size: int = 32,
    targets: Optional[Dict[str, float]] = None,
    attn_fn: Optional[Callable] = None,
    mesh=None,
) -> TrainTask:
    cfg = cfg or base_config()
    seq_len = min(seq_len, cfg.max_len)
    (group, blocks), vocab = token_group(mesh), vocab_split(mesh, cfg.vocab_size)

    def init(generator: torch.Generator) -> T5:
        return init_sharded(lambda m: T5(cfg, attn_fn=attn_fn, mesh=m), init_params,
                            generator, mesh)

    def loss_fn(model, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        logits, aux = apply_with_aux(model, cfg, batch["src"], batch["tgt_in"])
        loss, metrics = loss_and_metrics(logits, batch["tgt_out"], group, vocab, blocks)
        return add_moe_aux(cfg, loss, metrics, aux), metrics

    return TrainTask(
        name="t5-seq2seq",
        init=init,
        loss_fn=loss_fn,
        make_batch=make_batch_fn(cfg.vocab_size, seq_len),
        batch_size=batch_size,
        targets=targets or {},
    )


def task_for_mesh(mesh, cfg: Optional[TransformerConfig] = None, **task_kw) -> TrainTask:
    """The shared attention policy (``transformer.select_attn_fn``) at the
    effective length; ``mesh`` is a ``parallel.mesh.Mesh`` or the device of
    a one-process run."""
    cfg = cfg or base_config()
    seq_len = min(task_kw.get("seq_len", 128), cfg.max_len)
    return make_task(cfg=cfg, attn_fn=select_attn_fn(cfg, seq_len, mesh), mesh=mesh, **task_kw)


# ---------------------------------------------------------------------------
# KV-cache generation
# ---------------------------------------------------------------------------


def init_decode_cache(cfg: TransformerConfig, batch_size: int,
                      device: Any = None, heads: Optional[int] = None) -> DecodeCache:
    """A clean decoder self-attention cache of ``cfg.decode_cache_len or
    cfg.max_len`` positions (``heads``: a layer's, default all)."""
    return clean_cache(cfg, batch_size, device, heads)


def _validate_decode_cfg(cfg: TransformerConfig, num_tokens: int, verb: str) -> TransformerConfig:
    if num_tokens < 1:
        raise ValueError(f"{verb} needs num_tokens >= 1")
    if num_tokens > cfg.max_len:
        raise ValueError(f"num_tokens {num_tokens} exceeds max_len={cfg.max_len}")
    if cfg.decode_cache_len is not None and cfg.decode_cache_len < num_tokens:
        raise ValueError(f"decode_cache_len={cfg.decode_cache_len} < {num_tokens}")
    if cfg.decode_cache_len is None:
        cfg = dataclasses.replace(cfg, decode_cache_len=num_tokens)
    return cfg


def _step(model: T5, tok: torch.Tensor, enc: torch.Tensor, enc_mask: torch.Tensor,
          cache: DecodeCache, position: int) -> Tuple[torch.Tensor, DecodeCache]:
    """One decoder step at ``position``: float32 logits ``[b, vocab]``. The
    cross-attention is plain attention, as the reference's decode model
    (built without ``attn_fn``) runs it."""
    logits, cache = model.decode(tok[:, None], enc, enc_mask, pos_offset=position,
                                 cache=cache, attn_fn=dot_product_attention)
    return logits[:, 0].float(), cache


@torch.no_grad()
def generate(
    cfg: TransformerConfig,
    model: T5,
    src: torch.Tensor,  # [b, src_len] int
    num_tokens: int,
    rng: Any = None,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
    eos_id: Optional[int] = None,
    pad_id: int = PAD_ID,
) -> torch.Tensor:
    """Seq2seq decoding, greedy or sampled (reference ``t5.py:223``): one
    encoder pass, then ``num_tokens`` single-token decoder steps from BOS
    (step i at position i), cache buffers right-sized to the request.
    Returns the ``[b, num_tokens]`` target in ``src``'s dtype.

    ``rng=None`` (or ``temperature=0``) is greedy argmax; otherwise step i
    draws ``categorical(fold_in(rng, i), gpt.filter_logits(logits /
    temperature, top_k, top_p))`` with one key over the whole ``[b,
    vocab]``, as the reference draws it, so the same key gives the
    reference's tokens. ``rng`` is an int seed or a key's two uint32
    words. ``eos_id``: after a row emits EOS its later positions are
    ``pad_id`` (no early exit, as the reference's scan). A model over a
    tensor mesh decodes at its rank's heads; the greedy pick is the
    vocab-parallel argmax, a draw filters the logits gathered whole."""
    b = src.shape[0]
    cfg = _validate_decode_cfg(cfg, num_tokens, "generate")
    enc, enc_mask = model.encode(src)
    cache = init_decode_cache(cfg, b, src.device, cache_heads(model))
    greedy = rng is None or temperature == 0.0
    key = None if greedy else gpt._key(rng, src.device)
    tok = torch.full((b,), BOS_ID, dtype=src.dtype, device=src.device)
    done = torch.zeros((b,), dtype=torch.bool, device=src.device)
    pad = torch.full_like(tok, pad_id)
    outs = []
    for i in range(num_tokens):
        logits, cache = _step(model, tok, enc, enc_mask, cache, i)
        if greedy:
            nxt = model.embed.argmax(logits)
        else:
            filtered = gpt.filter_logits(model.embed.whole(logits) / max(temperature, 1e-6),
                                         top_k=top_k, top_p=top_p)
            nxt = jax_random.categorical_shared(jax_random.fold_in(key, i), filtered)
        nxt = nxt.to(src.dtype)
        if eos_id is not None:
            nxt = torch.where(done, pad, nxt)
            done = done | (nxt == eos_id)
        outs.append(nxt)
        tok = nxt
    return torch.stack(outs, dim=1)


def greedy_generate(cfg: TransformerConfig, model: T5, src: torch.Tensor,
                    num_tokens: int) -> torch.Tensor:
    """Greedy decoding: :func:`generate` with no key."""
    return generate(cfg, model, src, num_tokens)


@torch.no_grad()
def beam_generate(
    cfg: TransformerConfig,
    model: T5,
    src: torch.Tensor,  # [b, src_len] int
    num_tokens: int,
    num_beams: int = 4,
    return_all: bool = False,
):
    """Beam search with the KV cache (reference ``t5.py:300``): the encoder
    runs once at batch ``b``; the first step from BOS seeds the beams with
    its top ``num_beams`` tokens; encoder output, mask and cache are tiled
    to ``b * num_beams`` rows; each step keeps the ``num_beams`` highest
    total log-prob continuations per source and re-gathers the cache by
    parent beam. Fixed-length sequences (no EOS exit); ``num_beams=1`` is
    greedy. Returns the best continuation ``[b, num_tokens]``, or with
    ``return_all`` ``(sequences [b, k, num_tokens], scores [b, k])`` best
    first."""
    b = src.shape[0]
    k, vocab = num_beams, cfg.vocab_size
    if not 1 <= k <= vocab:
        raise ValueError(f"num_beams must be in [1, vocab_size={vocab}], got {num_beams}")
    cfg = _validate_decode_cfg(cfg, num_tokens, "beam search")
    dev = src.device
    enc, enc_mask = model.encode(src)
    bos = torch.full((b,), BOS_ID, dtype=src.dtype, device=dev)
    logits0, cache = _step(model, bos, enc, enc_mask,
                           init_decode_cache(cfg, b, dev, cache_heads(model)), 0)
    scores, tok0 = gpt._top_k(torch.log_softmax(model.embed.whole(logits0), dim=-1), k)
    tile = torch.arange(b, device=dev).repeat_interleave(k)
    cache = cache.select_rows(tile)
    enc_t, mask_t = enc.index_select(0, tile), enc_mask.index_select(0, tile)
    seqs = torch.zeros((b * k, num_tokens), dtype=src.dtype, device=dev)
    seqs[:, 0] = tok0.reshape(-1).to(src.dtype)
    row_base = torch.arange(b, device=dev)[:, None] * k
    for i in range(num_tokens - 1):
        logits, cache = _step(model, seqs[:, i], enc_t, mask_t, cache, i + 1)
        logp = torch.log_softmax(model.embed.whole(logits), dim=-1)  # [b*k, V]
        cand = (scores.reshape(b * k)[:, None] + logp).reshape(b, k * vocab)
        scores, flat = gpt._top_k(cand, k)
        parent = (row_base + flat // vocab).reshape(-1)
        cache = cache.select_rows(parent)
        seqs = seqs.index_select(0, parent)
        seqs[:, i + 1] = (flat % vocab).reshape(-1).to(src.dtype)
    seqs = seqs.reshape(b, k, num_tokens)
    if return_all:
        return seqs, scores
    return seqs[:, 0]


@pod_ranks.entrypoint
def train(env: Dict[str, str], stop: Optional[Any] = None) -> List[Dict[str, float]]:
    """TPUJob entrypoint: ``tfk8s_tpu_torch.models.t5:train``, with the
    reference's env contract (``TFK8S_SEQ_LEN`` 128, ``TFK8S_BATCH_SIZE``
    32, 100 steps at lr 1e-4 unless set; ``TFK8S_MODEL_PRESET=tiny``;
    ``TFK8S_ATTENTION_IMPL``; ``TFK8S_NUM_EXPERTS`` > 0 puts MoE layers in
    the encoder), on the card unless ``TFK8S_DEVICE=cpu``, over the mesh's
    data, expert, sequence and tensor axes. Returns the logged metrics
    history."""
    env = dict(env)
    env.setdefault("TFK8S_TRAIN_STEPS", "100")
    env.setdefault("TFK8S_LEARNING_RATE", "1e-4")
    seq = int(env.get("TFK8S_SEQ_LEN", "128"))
    batch = int(env.get("TFK8S_BATCH_SIZE", "32"))
    preset = tiny_config if env.get("TFK8S_MODEL_PRESET") == "tiny" else base_config
    cfg = preset(
        num_experts=int(env.get("TFK8S_NUM_EXPERTS", "0")),
        moe_top_k=int(env.get("TFK8S_MOE_TOP_K", "1")),
        attention_impl=env.get("TFK8S_ATTENTION_IMPL", "auto"),
    )
    _ctx, device, mesh = join_mesh(env)
    task = task_for_mesh(mesh, cfg=cfg, seq_len=seq, batch_size=batch)
    return run_task(task, env, stop, device=device, mesh=mesh)
