"""GPT-style decoder-only causal LM, ported from the JAX package's
``models/gpt.py``: the shared stack with ``causal=True`` and a tied head,
next-token cross-entropy over shifted targets, the same hermetic chain
data, and the ``gpt:train`` TPUJob entrypoint
(``tfk8s_tpu_torch.models.gpt:train``).

``train`` keeps the reference's env contract and runs on the card unless
``TFK8S_DEVICE=cpu``. With ``TFK8S_ATTENTION_IMPL=flash`` (or "auto" on
the card at ``TFK8S_SEQ_LEN`` >= 1024) attention goes through the port's
CUDA flash kernels, forward and backward. ``TFK8S_NUM_EXPERTS`` > 0 swaps
every other MLP for a ``SwitchMoeBlock`` (top-``TFK8S_MOE_TOP_K``), its
aux loss in the objective; a mesh with an ``expert`` axis shards the
experts, one with a ``sequence`` axis the sequence (:func:`split_sequence`
gives each rank its tokens and their next-token targets), one with a
``tensor`` axis the heads, the MLP and the vocabulary (the loss and the
accuracy over the vocab split).

The device half of paged continuous-batching decode is here too:
``clean_pages``, ``_paged_apply``, the packed ``decode``/``prefill``/
``verify`` steps over the reference's int32 state and batch layouts, the
top-k/top-p filters and the per-row pick (``sample_tokens``), which draws
with ``ops/jax_random`` so sampled streams equal the reference's.

So is slot-per-batch KV-cache generation (reference ``gpt.py:142-791``):
``init_cache``, ``prefill_cache`` (one causal forward over the prompt
through ``select_attn_fn``, so the flash kernel on the card when flash is
chosen, seeding a :class:`DecodeCache` from every layer's K/V),
``generate`` (greedy or sampled with the reference's key folds, batched or
token-at-a-time prefill, early exit once every row has emitted
``eos_id``), ``greedy_generate`` and ``beam_generate``; and Hugging Face
GPT-2 import and export (``load_hf_gpt2``, ``save_hf_gpt2``) as direct
``state_dict`` maps.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from tfk8s_tpu_torch.models.bert import BertWithHead, make_chain_tokens
from tfk8s_tpu_torch.ops import jax_random
from tfk8s_tpu_torch.models.transformer import (
    DecodeCache,
    TransformerConfig,
    add_moe_aux,
    apply_with_aux,
    cache_heads,
    clean_cache,
    dot_product_attention,
    init_params,
    masked_token_loss,
    select_attn_fn,
    token_group,
    token_loss,
)
from tfk8s_tpu_torch.parallel.tensor_parallel import init_sharded, vocab_split
from tfk8s_tpu_torch.runtime import pod_ranks
from tfk8s_tpu_torch.runtime.train import TrainTask, join_mesh, run_task


def GPTLM(cfg: TransformerConfig, attn_fn: Optional[Callable] = None, mesh=None) -> BertWithHead:
    """Decoder-only causal LM: the shared ``BertWithHead`` stack with
    ``causal=True``."""
    return BertWithHead(cfg, attn_fn=attn_fn, causal=True, mesh=mesh)


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
    logits: torch.Tensor, ids: torch.Tensor, vocab=None
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token objective: position i predicts token i+1 (the final
    position has no target and is dropped). ``vocab``: the logits are a
    vocab split's columns (``tensor_parallel.vocab_split``)."""
    per_tok, hit = token_loss(logits[:, :-1], ids[:, 1:], vocab)
    return per_tok.mean(), {"next_token_accuracy": hit.mean()}


def split_sequence(batch: Dict[str, np.ndarray], index: int, n: int) -> Dict[str, np.ndarray]:
    """Rank ``index``'s block of a sequence split ``n`` ways: its tokens,
    the token after each (the next block's first for its last; none after
    the sequence's end, weight 0 there), so the shifted objective needs no
    exchange between ranks."""
    ids = batch["input"]
    length = ids.shape[1]
    if length % n:
        raise ValueError(f"seq_len={length} does not divide over sequence={n}")
    lo, hi = index * length // n, (index + 1) * length // n
    nxt = np.concatenate([ids[:, 1:], np.zeros_like(ids[:, :1])], axis=1)
    weight = np.broadcast_to(np.arange(length) < length - 1, ids.shape)
    return {"input": ids[:, lo:hi], "target": nxt[:, lo:hi],
            "weight": np.ascontiguousarray(weight[:, lo:hi])}


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

    def init(generator: torch.Generator):
        return init_sharded(lambda m: GPTLM(cfg, attn_fn=attn_fn, mesh=m), init_params,
                            generator, mesh)

    def loss_fn(model, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        logits, aux = apply_with_aux(model, cfg, batch["input"])
        if "target" in batch:
            # a sequence block: the next tokens come with it
            loss, acc = masked_token_loss(logits, batch["target"], batch["weight"], group,
                                          vocab, blocks)
            metrics = {"next_token_accuracy": acc}
        else:
            loss, metrics = lm_loss_and_metrics(logits, batch["input"], vocab)
        return add_moe_aux(cfg, loss, metrics, aux), metrics

    return TrainTask(
        name="gpt-lm",
        init=init,
        loss_fn=loss_fn,
        make_batch=make_batch_fn(cfg.vocab_size, seq_len),
        batch_size=batch_size,
        targets=targets or {},
        split_sequence=split_sequence,
    )


def task_for_mesh(
    mesh,
    cfg: Optional[TransformerConfig] = None,
    **task_kw,
) -> TrainTask:
    """Build the task with the attention impl the mesh calls for
    (``transformer.select_attn_fn``); ``mesh`` is a ``parallel.mesh.Mesh``
    or the device of a one-process run."""
    cfg = cfg or base_config()
    seq_len = min(task_kw.get("seq_len", 128), cfg.max_len)
    attn_fn = select_attn_fn(cfg, seq_len, mesh)
    return make_task(cfg=cfg, attn_fn=attn_fn, mesh=mesh, **task_kw)


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


# the reference's name of the paged forward a prefill chunk runs
# (reference ``gpt.py:272``)
prefill_into_slots = _paged_apply


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


# ---------------------------------------------------------------------------
# Slot-per-batch KV-cache generation
# ---------------------------------------------------------------------------


def mode_view(model: BertWithHead, decode: bool = False, sow_kv: bool = False) -> BertWithHead:
    """``model`` in another mode (``BertWithHead``'s ``decode``/``sow_kv``
    flags) over the same parameters: a shallow copy shares every
    submodule, and only the flags differ."""
    view = copy.copy(model)
    view.decode, view.sow_kv = decode, sow_kv
    return view


def init_cache(cfg: TransformerConfig, batch_size: int,
               device: Union[str, torch.device, None] = None,
               heads: Optional[int] = None) -> DecodeCache:
    """A clean decode cache of ``cfg.decode_cache_len or cfg.max_len``
    positions (reference ``gpt.py:142``): right-size it to the request,
    since a decode step's cache traffic scales with the buffer. ``heads``:
    a layer's (a tensor rank's block; default all)."""
    return clean_cache(cfg, batch_size, device, heads)


@torch.no_grad()
def prefill_cache(cfg: TransformerConfig, model: BertWithHead,
                  prompt: torch.Tensor) -> Tuple[torch.Tensor, DecodeCache]:
    """Batched prefill (reference ``gpt.py:467``): one causal forward over
    the prompt ``[b, plen]``, through the attention ``select_attn_fn``
    picks for ``plen`` on the prompt's device (the flash kernel on the
    card when flash is chosen), whose layers also return their raw K/V;
    a decode cache seeded with them sits at position ``plen``. Returns
    ``(prompt logits [b, plen, vocab], cache)``. The K/V are the
    projections a token-at-a-time prefill writes, whichever attention
    ran. A tensor-split model's attention, logits and cache are its
    rank's heads and vocab columns."""
    b, plen = prompt.shape
    cache_len = cfg.decode_cache_len or cfg.max_len
    if plen > cache_len:
        raise ValueError(f"prompt_len {plen} exceeds cache_len {cache_len}")
    attn_fn = select_attn_fn(cfg, plen, prompt.device) or dot_product_attention
    logits, sown = mode_view(model, sow_kv=True)(prompt, attn_fn=attn_fn)
    cache = init_cache(cfg, b, prompt.device, cache_heads(model))
    for k_buf, v_buf, (k, v) in zip(cache.keys, cache.values, sown):
        k_buf[:, :plen] = k
        v_buf[:, :plen] = v
    cache.index.fill_(plen)
    return logits, cache


def _key(rng: Any, device: torch.device) -> torch.Tensor:
    """A jax.random key as ``[2]`` int64 words: an int seed
    (``PRNGKey(seed)``) or the key's two uint32 words (``key_data``)."""
    if isinstance(rng, int):
        return jax_random.prng_key(torch.tensor(rng)).to(device)
    words = torch.as_tensor(np.asarray(rng, dtype=np.int64).reshape(2))
    return words.to(device)


@torch.no_grad()
def generate(
    cfg: TransformerConfig,
    model: BertWithHead,
    prompt: torch.Tensor,  # [b, prompt_len] int
    num_tokens: int,
    rng: Any = None,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
    batched_prefill: bool = True,
    eos_id: Optional[int] = None,
    pad_id: int = 0,
    batch_rows: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """KV-cache decoding, greedy or sampled (reference ``gpt.py:518``);
    returns the ``[b, num_tokens]`` continuation in the prompt's dtype.

    ``batched_prefill=True`` seeds the cache with one full forward
    (:func:`prefill_cache`), then decodes ``num_tokens - 1`` single-token
    steps; ``False`` runs ``prompt_len + num_tokens`` single-token steps
    from a clean cache. Both give the same tokens. ``rng=None`` (or
    ``temperature=0``) is greedy argmax; otherwise the token after
    position ``p`` is ``categorical(fold_in(rng, p), filter_logits(logits
    / temperature, top_k, top_p))`` with one key over the whole batch, as
    the reference draws it (``gpt.py:588-599``), so the same key gives the
    reference's tokens. ``rng`` is an int seed or a key's two uint32 words.

    ``eos_id`` (batched prefill only): a row's EOS is emitted, every later
    position is ``pad_id``, and the loop stops once every row has finished;
    the reference's on-device while-loop exit is a host read of
    ``done.all()`` once a step here.

    A model over a tensor mesh (every rank of its tensor group calls this
    with the same prompt) holds its rank's heads and vocab columns: the
    greedy pick is the vocab-parallel argmax, a sampled draw filters the
    logits gathered whole, so the tokens are one process's. A rank of a
    data axis that decodes its block of a global batch gives
    ``batch_rows = (first row, global rows)``: its draws take those rows
    of the global batch's noise, so its tokens are the global batch's.

    The cache holds ``prompt_len + num_tokens`` positions unless
    ``cfg.decode_cache_len`` pins a size that fits."""
    b, prompt_len = prompt.shape
    total = prompt_len + num_tokens
    if num_tokens < 1:
        return prompt.new_zeros((b, 0))
    if total > cfg.max_len:
        raise ValueError(f"prompt_len + num_tokens = {total} exceeds max_len={cfg.max_len}")
    if cfg.decode_cache_len is not None and cfg.decode_cache_len < total:
        raise ValueError(
            f"decode_cache_len={cfg.decode_cache_len} is smaller than "
            f"prompt_len + num_tokens = {total}"
        )
    if cfg.decode_cache_len is None:
        cfg = dataclasses.replace(cfg, decode_cache_len=total)
    if eos_id is not None and not batched_prefill:
        raise ValueError("eos_id requires batched_prefill=True")
    decoder = mode_view(model, decode=True)
    sampled = rng is not None and temperature > 0.0
    key = _key(rng, prompt.device) if sampled else None

    def pick(step_logits: torch.Tensor, fold: int) -> torch.Tensor:
        """The next token from float32 logits, the key folded by the
        absolute position, so both prefill paths draw the same stream."""
        if sampled:
            filtered = filter_logits(model.embed.whole(step_logits) / temperature, top_k=top_k,
                                     top_p=top_p)
            drawn = jax_random.categorical_shared(jax_random.fold_in(key, fold), filtered,
                                                  batch_rows)
            return drawn.to(prompt.dtype)
        return model.embed.argmax(step_logits).to(prompt.dtype)

    def step(cache: DecodeCache, tok: torch.Tensor) -> Tuple[torch.Tensor, DecodeCache]:
        logits, cache = decoder(tok[:, None], cache=cache, pos_offset=cache.index)
        return logits[:, 0].float(), cache

    if not batched_prefill:
        cache = init_cache(cfg, b, prompt.device, cache_heads(model))
        tok, outs = prompt[:, 0], []
        for i in range(total):
            logits, cache = step(cache, tok)
            nxt = pick(logits, i)
            outs.append(nxt)
            # inside the prompt feed its next token, then the model's own
            tok = prompt[:, i + 1] if i + 1 < prompt_len else nxt
        # outs[i] predicts position i + 1: the continuation starts at
        # prompt_len, predicted at step prompt_len - 1
        return torch.stack(outs, dim=1)[:, prompt_len - 1:total - 1]

    prompt_logits, cache = prefill_cache(cfg, model, prompt)
    tok = pick(prompt_logits[:, -1].float(), prompt_len - 1)
    if eos_id is None:
        outs = [tok]
        for j in range(num_tokens - 1):
            logits, cache = step(cache, tok)
            tok = pick(logits, prompt_len + j)
            outs.append(tok)
        return torch.stack(outs, dim=1)
    out = torch.full((b, num_tokens), pad_id, dtype=prompt.dtype, device=prompt.device)
    out[:, 0] = tok
    done = tok == eos_id
    pad = torch.full_like(tok, pad_id)
    for j in range(num_tokens - 1):
        if bool(done.all()):
            break
        # finished rows keep feeding pad; their cache rows are dead
        logits, cache = step(cache, torch.where(done, pad, tok))
        tok = torch.where(done, pad, pick(logits, prompt_len + j))
        out[:, j + 1] = tok
        done = done | (tok == eos_id)
    return out


def greedy_generate(cfg: TransformerConfig, model: BertWithHead, prompt: torch.Tensor,
                    num_tokens: int) -> torch.Tensor:
    """Greedy argmax decoding: :func:`generate` without a key (reference
    ``gpt.py:690``)."""
    return generate(cfg, model, prompt, num_tokens)


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the ``k`` largest values,
    descending, ties toward the lower index. ``torch.topk`` promises no
    order among ties, so a stable descending sort is sliced instead."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


@torch.no_grad()
def beam_generate(
    cfg: TransformerConfig,
    model: BertWithHead,
    prompt: torch.Tensor,  # [b, prompt_len] int
    num_tokens: int,
    num_beams: int = 4,
    return_all: bool = False,
):
    """Beam search with the KV cache (reference ``gpt.py:700``): one
    batched prefill at batch ``b``, the cache tiled to ``b * num_beams``
    rows, then each step keeps the ``num_beams`` highest total log-prob
    continuations per batch row and re-gathers the cache by parent beam.
    Fixed-length sequences. Returns the best continuation ``[b,
    num_tokens]``, or with ``return_all`` ``(sequences [b, k, num_tokens],
    scores [b, k])`` best first. ``num_beams=1`` is greedy decoding. A
    tensor-split model scores over its logits gathered whole."""
    b, prompt_len = prompt.shape
    k, vocab = num_beams, cfg.vocab_size
    total = prompt_len + num_tokens
    if num_tokens < 1:
        raise ValueError("beam search needs num_tokens >= 1")
    if total > cfg.max_len:
        raise ValueError(f"prompt_len + num_tokens = {total} exceeds max_len={cfg.max_len}")
    if cfg.decode_cache_len is not None and cfg.decode_cache_len < total:
        raise ValueError(f"decode_cache_len={cfg.decode_cache_len} < {total}")
    if cfg.decode_cache_len is None:
        cfg = dataclasses.replace(cfg, decode_cache_len=total)
    decoder = mode_view(model, decode=True)
    prompt_logits, cache = prefill_cache(cfg, model, prompt)
    logp0 = torch.log_softmax(model.embed.whole(prompt_logits[:, -1].float()), dim=-1)
    scores, tok0 = _top_k(logp0, k)  # [b, k] each: beams from one source
    dev = prompt.device
    cache = cache.select_rows(torch.arange(b, device=dev).repeat_interleave(k))
    seqs = torch.zeros((b * k, num_tokens), dtype=prompt.dtype, device=dev)
    seqs[:, 0] = tok0.reshape(-1).to(prompt.dtype)
    row_base = torch.arange(b, device=dev)[:, None] * k
    for i in range(num_tokens - 1):
        logits, cache = decoder(seqs[:, i][:, None], cache=cache, pos_offset=cache.index)
        logp = torch.log_softmax(model.embed.whole(logits[:, 0].float()), dim=-1)  # [b*k, V]
        cand = (scores.reshape(b * k)[:, None] + logp).reshape(b, k * vocab)
        scores, flat = _top_k(cand, k)
        parent = (row_base + flat // vocab).reshape(-1)
        cache = cache.select_rows(parent)
        seqs = seqs.index_select(0, parent)
        seqs[:, i + 1] = (flat % vocab).reshape(-1).to(prompt.dtype)
    seqs = seqs.reshape(b, k, num_tokens)
    if return_all:
        return seqs, scores
    return seqs[:, 0]


# ---------------------------------------------------------------------------
# Hugging Face GPT-2 interop
# ---------------------------------------------------------------------------


def load_hf_gpt2(hf_model) -> Tuple[TransformerConfig, BertWithHead]:
    """Import a Hugging Face ``GPT2LMHeadModel`` as ``(cfg, model)``, a
    float32 GPT of this package (reference ``gpt.py:793``). The stacks are
    the same pre-LN blocks with learned positions, a final LN and a tied
    head, so the map is a relabel of ``state_dict`` entries: HF's
    ``Conv1D`` weights are ``[in, out]`` and become ``nn.Linear``'s
    ``[out, in]``, the fused ``c_attn`` splits into q, k and v, and
    ``ln_eps`` is the checkpoint's ``layer_norm_epsilon``. Configs whose
    forward differs from this stack are refused."""
    hc = hf_model.config
    if hc.n_embd % hc.n_head:
        raise ValueError(f"n_embd {hc.n_embd} not divisible by n_head {hc.n_head}")
    act = getattr(hc, "activation_function", "gelu_new")
    if act not in ("gelu_new", "gelu_pytorch_tanh"):
        raise ValueError(
            f"activation_function={act!r} unsupported: this stack runs the "
            "tanh-approximate gelu (gelu_new)"
        )
    if not getattr(hc, "scale_attn_weights", True):
        raise ValueError("scale_attn_weights=False is unsupported")
    if getattr(hc, "scale_attn_by_inverse_layer_idx", False):
        raise ValueError("scale_attn_by_inverse_layer_idx is unsupported")
    if getattr(hc, "reorder_and_upcast_attn", False):
        raise ValueError("reorder_and_upcast_attn is unsupported")
    cfg = TransformerConfig(
        vocab_size=hc.vocab_size, embed_dim=hc.n_embd, num_heads=hc.n_head,
        head_dim=hc.n_embd // hc.n_head,
        mlp_dim=getattr(hc, "n_inner", None) or 4 * hc.n_embd,
        num_layers=hc.n_layer, max_len=hc.n_positions,
        ln_eps=float(hc.layer_norm_epsilon), dtype=torch.float32,
    )
    src = {k: v.detach().to("cpu", torch.float32) for k, v in hf_model.state_dict().items()}
    sd = {
        "embed.tok.weight": src["transformer.wte.weight"],
        "embed.pos": src["transformer.wpe.weight"],
        "ln_final.weight": src["transformer.ln_f.weight"],
        "ln_final.bias": src["transformer.ln_f.bias"],
    }
    for i in range(cfg.num_layers):
        p, o = f"transformer.h.{i}", f"layers.{i}"
        wq, wk, wv = src[f"{p}.attn.c_attn.weight"].chunk(3, dim=1)
        bq, bk, bv = src[f"{p}.attn.c_attn.bias"].chunk(3)
        for name, w, bias in (("q", wq, bq), ("k", wk, bk), ("v", wv, bv)):
            sd[f"{o}.attn.{name}.weight"] = w.t()
            sd[f"{o}.attn.{name}.bias"] = bias
        for ours, theirs in (("attn.out", "attn.c_proj"), ("mlp.wi", "mlp.c_fc"),
                             ("mlp.wo", "mlp.c_proj")):
            sd[f"{o}.{ours}.weight"] = src[f"{p}.{theirs}.weight"].t()
            sd[f"{o}.{ours}.bias"] = src[f"{p}.{theirs}.bias"]
        for ours, theirs in (("ln_attn", "ln_1"), ("ln_mlp", "ln_2")):
            sd[f"{o}.{ours}.weight"] = src[f"{p}.{theirs}.weight"]
            sd[f"{o}.{ours}.bias"] = src[f"{p}.{theirs}.bias"]
    model = GPTLM(cfg)
    model.load_state_dict({k: v.contiguous() for k, v in sd.items()})
    return cfg, model.eval()


def save_hf_gpt2(cfg: TransformerConfig, model: Union[BertWithHead, Dict[str, torch.Tensor]]):
    """Export a GPT of this package (a module or its ``state_dict``) as a
    Hugging Face ``GPT2LMHeadModel``: :func:`load_hf_gpt2`'s map run
    backwards (reference ``gpt.py:892``). ``transformers`` is imported
    here only."""
    from transformers import GPT2Config, GPT2LMHeadModel

    e, h, d = cfg.embed_dim, cfg.num_heads, cfg.head_dim
    if e != h * d:
        raise ValueError(f"HF GPT-2 requires embed_dim == num_heads*head_dim; got {e} != {h}*{d}")
    if cfg.num_experts > 0:
        raise ValueError(
            "MoE models have no GPT-2 equivalent — dense-distill or "
            "export per-expert weights yourself"
        )
    src = model.state_dict() if isinstance(model, torch.nn.Module) else model
    src = {k: v.detach().to("cpu", torch.float32) for k, v in src.items()}
    hf = GPT2LMHeadModel(GPT2Config(
        vocab_size=cfg.vocab_size, n_positions=cfg.max_len, n_embd=e, n_layer=cfg.num_layers,
        n_head=h, n_inner=cfg.mlp_dim, layer_norm_epsilon=cfg.ln_eps,
        activation_function="gelu_new", resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0,
    ))
    sd = {
        "transformer.wte.weight": src["embed.tok.weight"],
        "transformer.wpe.weight": src["embed.pos"],
        "transformer.ln_f.weight": src["ln_final.weight"],
        "transformer.ln_f.bias": src["ln_final.bias"],
        "lm_head.weight": src["embed.tok.weight"],  # tied
    }
    for i in range(cfg.num_layers):
        p, o = f"transformer.h.{i}", f"layers.{i}"
        sd[f"{p}.attn.c_attn.weight"] = torch.cat(
            [src[f"{o}.attn.{n}.weight"].t() for n in ("q", "k", "v")], dim=1)
        sd[f"{p}.attn.c_attn.bias"] = torch.cat([src[f"{o}.attn.{n}.bias"] for n in ("q", "k", "v")])
        for ours, theirs in (("attn.out", "attn.c_proj"), ("mlp.wi", "mlp.c_fc"),
                             ("mlp.wo", "mlp.c_proj")):
            sd[f"{p}.{theirs}.weight"] = src[f"{o}.{ours}.weight"].t()
            sd[f"{p}.{theirs}.bias"] = src[f"{o}.{ours}.bias"]
        for ours, theirs in (("ln_attn", "ln_1"), ("ln_mlp", "ln_2")):
            sd[f"{p}.{theirs}.weight"] = src[f"{o}.{ours}.weight"]
            sd[f"{p}.{theirs}.bias"] = src[f"{o}.{ours}.bias"]
    missing, unexpected = hf.load_state_dict(
        {k: v.contiguous() for k, v in sd.items()}, strict=False)
    # attn.bias / attn.masked_bias are causal-mask buffers HF derives itself
    real_missing = [m for m in missing if not m.endswith((".attn.bias", ".attn.masked_bias"))]
    if real_missing or unexpected:
        raise ValueError(f"state_dict mismatch: missing={real_missing} unexpected={list(unexpected)}")
    return hf.eval()


@pod_ranks.entrypoint
def train(env: Dict[str, str], stop: Optional[Any] = None) -> List[Dict[str, float]]:
    """TPUJob entrypoint: ``tfk8s_tpu_torch.models.gpt:train``.
    ``TFK8S_MODEL_PRESET=tiny`` selects the test-scale config;
    ``TFK8S_ATTENTION_IMPL`` pins an attention impl; ``TFK8S_NUM_EXPERTS``
    > 0 enables MoE layers over the ``expert`` mesh axis. Takes the
    runtime's input modes (``TFK8S_INPUT_FILES``, ``TFK8S_INPUT_MODE``) and
    the mesh's data, expert, sequence and tensor axes. Returns the logged
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
    _ctx, device, mesh = join_mesh(env)
    task = task_for_mesh(mesh, cfg=cfg, seq_len=seq, batch_size=batch)
    return run_task(task, env, stop, device=device, mesh=mesh)
