"""GPT-style decoder-only causal LM, ported from the JAX package's
``models/gpt.py``: the shared stack with ``causal=True`` and a tied head,
next-token cross-entropy over shifted targets, the same hermetic chain
data, and the ``gpt:train`` TPUJob entrypoint
(``tfk8s_tpu_torch.models.gpt:train``).

``train`` keeps the reference's env contract and runs on one device: the
card unless ``TFK8S_DEVICE=cpu``. With ``TFK8S_ATTENTION_IMPL=flash`` (or
"auto" on the card at ``TFK8S_SEQ_LEN`` >= 1024) attention goes through
the port's CUDA flash kernels, forward and backward.

The device half of paged continuous-batching decode is here too:
``clean_pages``, ``_paged_apply``, the packed ``decode``/``prefill``/
``verify`` steps over the reference's int32 state and batch layouts, the
top-k/top-p filters and the per-row pick (``sample_tokens``), which draws
with ``ops/jax_random`` so sampled streams equal the reference's. The
slot-per-batch ``generate``/``beam_generate`` family is ROADMAP item 1.6.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from tfk8s_tpu_torch.models.bert import BertWithHead, make_chain_tokens
from tfk8s_tpu_torch.ops import jax_random
from tfk8s_tpu_torch.models.transformer import (
    TransformerConfig,
    init_params,
    select_attn_fn,
)
from tfk8s_tpu_torch.runtime.launcher import select_device
from tfk8s_tpu_torch.runtime.train import TrainTask, run_task


def GPTLM(cfg: TransformerConfig, attn_fn: Optional[Callable] = None) -> BertWithHead:
    """Decoder-only causal LM: the shared ``BertWithHead`` stack with
    ``causal=True``."""
    return BertWithHead(cfg, attn_fn=attn_fn, causal=True)


def base_config(**overrides) -> TransformerConfig:
    """GPT-2-small shape: 12 layers / 768 hidden / 12 heads / 3072 mlp."""
    kw = dict(
        vocab_size=32000, embed_dim=768, num_heads=12, head_dim=64,
        mlp_dim=3072, num_layers=12, max_len=1024,
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


def mid_config(**overrides) -> TransformerConfig:
    """Serving-bench scale (the reference's ``mid_config``)."""
    kw = dict(
        vocab_size=256, embed_dim=128, num_heads=4, head_dim=32,
        mlp_dim=512, num_layers=4, max_len=256,
    )
    kw.update(overrides)
    return TransformerConfig(**kw)


def make_batch_fn(vocab: int, seq_len: int):
    def make_batch(rng: np.random.Generator, batch_size: int) -> Dict[str, np.ndarray]:
        toks = make_chain_tokens(rng, batch_size, seq_len, vocab)
        return {"input": toks.astype(np.int32)}

    return make_batch


def lm_loss_and_metrics(
    logits: torch.Tensor, ids: torch.Tensor
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token objective: position i predicts token i+1 (the final
    position has no target and is dropped)."""
    shift_logits = logits[:, :-1]
    shift_targets = ids[:, 1:].long()
    loss = F.cross_entropy(
        shift_logits.reshape(-1, shift_logits.shape[-1]), shift_targets.reshape(-1)
    )
    acc = (shift_logits.argmax(-1) == shift_targets).float().mean()
    return loss, {"next_token_accuracy": acc}


def make_task(
    cfg: Optional[TransformerConfig] = None,
    seq_len: int = 128,
    batch_size: int = 64,
    targets: Optional[Dict[str, float]] = None,
    attn_fn: Optional[Callable] = None,
) -> TrainTask:
    cfg = cfg or base_config()
    seq_len = min(seq_len, cfg.max_len)

    def init(generator: torch.Generator):
        return init_params(GPTLM(cfg, attn_fn=attn_fn), generator)

    def loss_fn(model, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        return lm_loss_and_metrics(model(batch["input"]), batch["input"])

    return TrainTask(
        name="gpt-lm",
        init=init,
        loss_fn=loss_fn,
        make_batch=make_batch_fn(cfg.vocab_size, seq_len),
        batch_size=batch_size,
        targets=targets or {},
    )


def task_for_mesh(
    device: torch.device,
    cfg: Optional[TransformerConfig] = None,
    **task_kw,
) -> TrainTask:
    """Build the task with the attention impl its device calls for. The
    port runs on one device, so the reference's mesh is just the device
    here (``transformer.select_attn_fn``)."""
    cfg = cfg or base_config()
    seq_len = min(task_kw.get("seq_len", 128), cfg.max_len)
    attn_fn = select_attn_fn(cfg, seq_len, device)
    return make_task(cfg=cfg, attn_fn=attn_fn, **task_kw)


# ---------------------------------------------------------------------------
# Block-paged decode: the device half of continuous batching
# ---------------------------------------------------------------------------

Pages = List[Tuple[torch.Tensor, torch.Tensor]]


def clean_pages(cfg: TransformerConfig, device: Union[str, torch.device, None] = None) -> Pages:
    """Zeroed per-layer ``(k, v)`` page pools, each ``[kv_max_pages *
    kv_page_size, num_heads, head_dim]`` in ``cfg.dtype`` (the reference's
    ``pages`` collection, one flat buffer per leaf)."""
    cfg.pages_per_slot()  # raises on a config without a page size
    if not cfg.kv_max_pages:
        raise ValueError("kv_max_pages is unset; not a paged config")
    shape = (cfg.kv_max_pages * cfg.kv_page_size, cfg.num_heads, cfg.head_dim)
    return [
        (torch.zeros(shape, dtype=cfg.dtype, device=device),
         torch.zeros(shape, dtype=cfg.dtype, device=device))
        for _ in range(cfg.num_layers)
    ]


def leaf_layers(num_layers: int) -> List[int]:
    """Layer index of each ``(k, v)`` leaf pair in the reference's leaf
    order: flax flattens the ``pages`` tree with its keys sorted as
    strings, so ``layer10`` comes before ``layer2``."""
    return sorted(range(num_layers), key=lambda i: f"layer{i}")


def page_leaves(pages: Pages) -> List[torch.Tensor]:
    """The pools as a flat leaf list in the reference's tree order
    (``layer0/k, layer0/v, layer1/k, layer1/v, layer10/k, ...``): the
    order the KV handoff wire carries them in."""
    out: List[torch.Tensor] = []
    for i in leaf_layers(len(pages)):
        out.extend(pages[i])
    return out


def _paged_apply(cfg: TransformerConfig, model: BertWithHead, pages: Pages,
                 tokens: torch.Tensor, page_tables: torch.Tensor,
                 positions: torch.Tensor) -> Tuple[torch.Tensor, Pages]:
    """One paged forward: ``tokens [b, T]`` at per-row base ``positions``
    write their K/V into ``pages`` in place; returns ``(float32 logits
    [b, T, vocab], pages)``."""
    logits = model(tokens, pos_offset=positions, page_tables=page_tables, pages=pages)
    return logits.float(), pages


@torch.no_grad()
def decode_step_packed(
    cfg: TransformerConfig,
    model: BertWithHead,
    pages: Pages,
    state: torch.Tensor,  # [slots, 2 + pages_per_slot] int32
    sampling: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Pages]:
    """One token for every slot against the paged KV cache, over the
    reference's packed int32 state (column 0 the last token, column 1 its
    position, columns 2+ the page table; inactive rows all zero). Returns
    ``(emitted [slots] int32, new_state, pages)`` with the token and
    position columns advanced. ``sampling = (samp_f [slots, 2] f32
    (temperature, top_p), samp_i [slots, 2] i32 (top_k, seed))`` samples
    the rows with temperature > 0, folded at the row's position."""
    tokens, positions, tables = state[:, 0], state[:, 1], state[:, 2:]
    logits, pages = _paged_apply(cfg, model, pages, tokens[:, None], tables, positions)
    if sampling is None:
        nxt = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
    else:
        samp_f, samp_i = sampling
        nxt = sample_tokens(logits[:, 0], samp_f[:, 0], samp_i[:, 0], samp_f[:, 1],
                            samp_i[:, 1], positions)
    new_state = state.clone()
    new_state[:, 0] = nxt
    new_state[:, 1] += 1
    return nxt, new_state, pages


@torch.no_grad()
def prefill_step_packed(
    cfg: TransformerConfig,
    model: BertWithHead,
    pages: Pages,
    batch: torch.Tensor,  # [slots, C + 1 + pages_per_slot] int32
    sampling: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Pages]:
    """Batched chunked prefill: row r packs ``C`` chunk tokens, the
    chunk's base position, then its page table (idle rows all zero).
    Returns ``(per-position picks [slots, C] int32, pages)``; column j of
    a sampled row folds at ``positions[r] + j``."""
    mpp = cfg.pages_per_slot()
    c = batch.shape[1] - 1 - mpp
    chunk, positions, tables = batch[:, :c], batch[:, c], batch[:, c + 1:]
    logits, pages = _paged_apply(cfg, model, pages, chunk, tables, positions)
    if sampling is None:
        return torch.argmax(logits, dim=-1).to(torch.int32), pages
    return _sample_packed(logits, positions, sampling), pages


@torch.no_grad()
def verify_step_packed(
    cfg: TransformerConfig,
    model: BertWithHead,
    pages: Pages,
    state: torch.Tensor,  # [slots, 2 + pages_per_slot] int32
    drafts: torch.Tensor,  # [slots, k] int32 draft-proposed tokens
    sampling: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Pages]:
    """Speculative-decode verification: one chunk forward over each row's
    last token and its ``k`` drafts at positions ``P .. P+k``; returns the
    model's own pick at every one of them (``[slots, k + 1]``), each
    computed as a plain step at that position would."""
    tokens, positions, tables = state[:, 0], state[:, 1], state[:, 2:]
    chunk = torch.cat([tokens[:, None], drafts.to(torch.int32)], dim=1)
    logits, pages = _paged_apply(cfg, model, pages, chunk, tables, positions)
    if sampling is None:
        picks = torch.argmax(logits, dim=-1).to(torch.int32)
    else:
        picks = _sample_packed(logits, positions, sampling)
    return picks, pages


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` in float32: exp of the max-shifted row over its sum."""
    e = torch.exp(x - x.max(dim=-1, keepdim=True).values)
    return e / e.sum(dim=-1, keepdim=True)


def filter_logits(logits: torch.Tensor, top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """Top-k / nucleus filtering of ``[b, vocab]`` logits with the
    reference's semantics: disallowed tokens go to -inf; ``top_k > 0``
    keeps every token at or above the k-th highest logit (ties at the
    threshold all survive); ``top_p < 1`` keeps the smallest prefix of the
    descending order whose exclusive cumulative mass is below p (the
    argmax always survives); both compose."""
    neg = float("-inf")
    sorted_desc = (
        torch.sort(logits, dim=-1, descending=True).values
        if (top_k and top_k > 0) or top_p < 1.0 else None
    )
    if top_k and top_k > 0:
        kth = sorted_desc[:, min(top_k, logits.shape[-1]) - 1][:, None]
        logits = logits.masked_fill(logits < kth, neg)
        if top_p < 1.0:
            sorted_desc = sorted_desc.masked_fill(sorted_desc < kth, neg)
    if top_p < 1.0:
        probs = _softmax(sorted_desc.float())
        cum = torch.cumsum(probs, dim=-1)
        keep_sorted = (cum - probs) < top_p
        thresh = sorted_desc.masked_fill(~keep_sorted, float("inf")).min(dim=-1, keepdim=True).values
        logits = logits.masked_fill(logits < thresh, neg)
    return logits


def filter_logits_rows(logits: torch.Tensor, top_k: torch.Tensor,
                       top_p: torch.Tensor) -> torch.Tensor:
    """Per-row :func:`filter_logits`: row r has its own ``top_k[r]`` (0
    disables) and ``top_p[r]`` (1.0 disables), one sort for all rows."""
    neg = float("-inf")
    vocab = logits.shape[-1]
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    k_active = (top_k > 0)[:, None]
    kth = torch.gather(sorted_desc, 1, (top_k.clamp(1, vocab) - 1).long()[:, None])
    logits = logits.masked_fill(k_active & (logits < kth), neg)
    sorted_desc = sorted_desc.masked_fill(k_active & (sorted_desc < kth), neg)
    p_active = (top_p < 1.0)[:, None]
    probs = _softmax(sorted_desc.float())
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < top_p[:, None].float()
    thresh = sorted_desc.masked_fill(~keep_sorted, float("inf")).min(dim=-1, keepdim=True).values
    return logits.masked_fill(p_active & (logits < thresh), neg)


def sample_tokens(
    logits: torch.Tensor,  # [n, vocab] float32 raw logits
    temperature: torch.Tensor,  # [n] f32; <= 0 pins the row to greedy argmax
    top_k: torch.Tensor,  # [n] i32
    top_p: torch.Tensor,  # [n] f32
    seeds: torch.Tensor,  # [n] i32 per-request seed
    folds: torch.Tensor,  # [n] i32 absolute position fold index
) -> torch.Tensor:
    """The packed per-row pick: greedy rows take the argmax of the RAW
    logits; sampled rows draw ``categorical(fold_in(PRNGKey(seed), fold),
    filter_logits_rows(logits / temperature, top_k, top_p))``, one
    ``[1, vocab]`` draw per row, with jax.random's bits (``ops/jax_random``)."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    sampled = temperature > 0.0
    t_safe = torch.where(sampled, temperature, torch.ones_like(temperature))
    filtered = filter_logits_rows(logits / t_safe[:, None].to(logits.dtype), top_k, top_p)
    keys = jax_random.fold_in(jax_random.prng_key(seeds), folds)
    drawn = jax_random.categorical(keys, filtered).to(torch.int32)
    return torch.where(sampled, drawn, greedy)


def _sample_packed(logits: torch.Tensor, positions: torch.Tensor,
                   sampling: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """The pick of the packed entry points over ``[slots, C, vocab]``
    logits: column c of row r folds at ``positions[r] + c``."""
    samp_f, samp_i = sampling
    slots, c, vocab = logits.shape
    folds = positions[:, None].long() + torch.arange(c, device=logits.device)

    def rep(v: torch.Tensor) -> torch.Tensor:
        return torch.repeat_interleave(v, c)

    picks = sample_tokens(
        logits.reshape(slots * c, vocab), rep(samp_f[:, 0]), rep(samp_i[:, 0]),
        rep(samp_f[:, 1]), rep(samp_i[:, 1]), folds.reshape(-1),
    )
    return picks.reshape(slots, c)


def train(env: Dict[str, str], stop: Optional[Any] = None) -> List[Dict[str, float]]:
    """TPUJob entrypoint: ``tfk8s_tpu_torch.models.gpt:train``.
    ``TFK8S_MODEL_PRESET=tiny`` selects the test-scale config;
    ``TFK8S_ATTENTION_IMPL`` pins an attention impl. Returns the logged
    metrics history (the last entry is the final metrics)."""
    env = dict(env)
    env.setdefault("TFK8S_TRAIN_STEPS", "100")
    env.setdefault("TFK8S_LEARNING_RATE", "1e-4")
    seq = int(env.get("TFK8S_SEQ_LEN", "128"))
    batch = int(env.get("TFK8S_BATCH_SIZE", "64"))
    preset = tiny_config if env.get("TFK8S_MODEL_PRESET") == "tiny" else base_config
    cfg_kw = dict(
        num_experts=int(env.get("TFK8S_NUM_EXPERTS", "0")),
        moe_top_k=int(env.get("TFK8S_MOE_TOP_K", "1")),
        attention_impl=env.get("TFK8S_ATTENTION_IMPL", "auto"),
    )
    if env.get("TFK8S_VOCAB_SIZE"):
        cfg_kw["vocab_size"] = int(env["TFK8S_VOCAB_SIZE"])
    cfg = preset(**cfg_kw)
    device = select_device(env)
    task = task_for_mesh(device, cfg=cfg, seq_len=seq, batch_size=batch)
    return run_task(task, env, stop, device=device)
