"""Shared transformer building blocks, ported from the JAX package's
``models/transformer.py``: the full-sequence path and the block-paged
KV-cache path of continuous-batching decode.

Conventions kept from the reference so the same bridged parameters give
the same numbers:
- float32 parameters; activations in ``cfg.dtype`` (bfloat16 by default);
- every projection casts its input, weight and bias to ``cfg.dtype``
  (flax ``DenseGeneral(dtype=...)``);
- layer norms run in float32 with ``cfg.ln_eps`` and cast back;
- the MLP's gelu is the tanh approximation (flax ``nn.gelu``);
- q is divided by ``sqrt(head_dim)`` in ``cfg.dtype`` after projection;
- plain attention fills masked scores with -1e9, takes the softmax in
  float32 and casts the probabilities to q's dtype before the PV product;
- the output head is a float32 product with the tied token embedding.

Parameter layout is PyTorch's (``nn.Linear`` weights are ``[out, in]``);
``tfk8s_tpu_torch.bridge`` maps it to and from the reference's flax tree.

The paged path (:func:`paged_attention`) keeps each layer's K/V in a flat
``[kv_max_pages * kv_page_size, heads, head_dim]`` pool per layer, in
``cfg.dtype``, written in place.

The encoder-decoder blocks (:class:`DecoderLayer`: causal self-attention,
cross-attention under the encoder's key mask, MLP) and :class:`Encoder`
serve the T5 family; :class:`EncoderLayer` serves BERT, GPT and ViT.

The slot-per-batch decode path (:func:`decode_attention`, the reference's
``decode=True`` branch, ``transformer.py:253-300``) keeps each layer's K/V
in ``[batch, cache_len, heads, head_dim]`` buffers of a
:class:`DecodeCache`, an explicit structure the caller passes in and gets
back (no hidden module state), with the write position as a 0-d tensor on
the device. A full forward can hand each layer's raw K/V projections to a
caller's list (the reference's ``sow_kv``, ``:147-177``), whichever
attention implementation runs.

MoE: with ``cfg.num_experts > 0`` every ``moe_every``-th layer swaps its
MLP for a ``parallel.moe.SwitchMoeBlock`` (``layer_uses_moe``); a stack
called with ``aux_sink`` (a list) collects each MoE layer's load-balance
loss, and :func:`apply_with_aux` sums them (the reference's sown
``losses``). ``cfg.remat`` recomputes each layer in the backward
(:func:`call_layer`, ``torch.utils.checkpoint`` without reentry).
:func:`select_attn_fn` is the reference's policy over a
``parallel.mesh.Mesh``: ring or Ulysses attention on a sequence-sharded
mesh, the flash kernels or plain attention otherwise.

On a mesh with a ``tensor`` axis (``parallel/tensor_parallel.py``) each
rank holds a contiguous block of the heads (q/k/v column splits, ``out`` a
row split whose bias is added once after the sum), of the MLP's hidden
width (``wi`` column, ``wo`` row) and of the token table's rows (a
vocab-parallel lookup; the tied head gives this rank's float32 logit
columns), the reference's ``heads``/``mlp``/``vocab`` rules; layer norms,
positions and row-split biases are whole on every rank. The attention
function sees ``[b, l, h/t, d]``, and so does a decode cache
(:func:`clean_cache` at :func:`cache_heads`); an MoE layer splits each
expert's hidden width (``expert_mlp``, ``parallel/moe.py``).
:func:`masked_token_loss` then takes the cross-entropy and argmax over
the vocab split (``vocab``). Paged serving of a tensor-split model
raises: the reference serves a replica on one device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tfk8s_tpu_torch.ops.flash_attention import HEAD_DIMS, auto_flash_attn_fn, flash_attention
from tfk8s_tpu_torch.parallel.collectives import (
    all_reduce_sum,
    scale_grad,
    sum_over,
    vocab_parallel_argmax,
    vocab_parallel_cross_entropy,
    vocab_parallel_lookup,
)
from tfk8s_tpu_torch.parallel.mesh import (
    AXIS_DATA,
    AXIS_FSDP,
    AXIS_SEQUENCE,
    AXIS_TENSOR,
    BATCH_AXES,
    Mesh,
)
from tfk8s_tpu_torch.parallel.moe import ExpertShard, SwitchMoeBlock
from tfk8s_tpu_torch.parallel.tensor_parallel import (
    Split,
    TensorShard,
    column_splits,
    enter,
    gather_tensor,
    group_of,
    row_dense,
)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    embed_dim: int = 768
    num_heads: int = 12
    head_dim: int = 64
    mlp_dim: int = 3072
    num_layers: int = 12
    max_len: int = 512
    dtype: torch.dtype = torch.bfloat16
    remat: bool = False
    # 'auto' | 'full' | 'flash' | 'ring' | 'ulysses' (select_attn_fn)
    attention_impl: str = "auto"
    # MoE: 0 = dense MLP everywhere; >0 swaps the MLP of every
    # moe_every-th layer for a SwitchMoeBlock with this many experts, whose
    # aux loss enters the objective with weight moe_aux_weight
    num_experts: int = 0
    moe_every: int = 2
    moe_top_k: int = 1
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 1e-2
    ln_eps: float = 1e-6
    # block-paged KV cache (continuous-batching decode): each layer's K/V
    # live in a pool of kv_max_pages pages of kv_page_size tokens; page 0
    # is the trash page inactive rows write into (runtime/paging)
    kv_page_size: Optional[int] = None
    kv_max_pages: Optional[int] = None
    # KV-cache buffer length of slot-per-batch decode (None = max_len):
    # right-sized to the request (prompt + generation), since a decode
    # step's cache traffic scales with the buffer, not the filled part
    decode_cache_len: Optional[int] = None

    def pages_per_slot(self) -> int:
        """Page-table width: pages needed to cover ``max_len`` tokens."""
        if not self.kv_page_size:
            raise ValueError("kv_page_size is unset; not a paged config")
        return -(-self.max_len // self.kv_page_size)

    def layer_uses_moe(self, layer_idx: int) -> bool:
        """MoE layers interleave dense ones: every ``moe_every``-th layer,
        counting from the top of each group (the Switch/GShard layout)."""
        return self.num_experts > 0 and layer_idx % self.moe_every == self.moe_every - 1


def _dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A projection in ``dtype``: input, weight and bias all cast first."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def _ln(norm: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Layer norm in float32, cast back to ``dtype``."""
    return norm(x.float()).to(dtype)


def dot_product_attention(
    q: torch.Tensor,  # [b, lq, h, d] (pre-scaled)
    k: torch.Tensor,  # [b, lk, h, d]
    v: torch.Tensor,  # [b, lk, h, d]
    mask: Optional[torch.Tensor] = None,  # [b, lk] key validity or [b, lq, lk]
    causal: bool = False,
) -> torch.Tensor:
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
    if mask is not None:
        m = mask[:, None, None, :] if mask.dim() == 2 else mask[:, None, :, :]
        scores = scores.masked_fill(~m.to(torch.bool), -1e9)
    if causal:
        lq, lk = scores.shape[-2], scores.shape[-1]
        cm = torch.ones(lq, lk, dtype=torch.bool, device=q.device).tril(lk - lq)
        scores = scores.masked_fill(~cm, -1e9)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


@dataclasses.dataclass(frozen=True)
class PagePlan:
    """Where one paged forward writes and reads, the same for every layer
    (so it is computed once a forward): row r's token t sits at absolute
    position ``p = positions[r] + t``."""

    flat: torch.Tensor  # [b*T] pool row each token's K/V is written to
    rows: torch.Tensor  # [b, mpp*ps] pool rows each row gathers back
    visible: torch.Tensor  # [b, T, mpp*ps] gathered position j <= p
    inside: torch.Tensor  # [b, T] p lies within the page table


def page_plan(page_tables: torch.Tensor, positions: torch.Tensor, step_len: int,
              page_size: int) -> PagePlan:
    """The reference's paged index math (``MultiHeadAttention`` with
    ``paged=True``). Token t of row r writes page ``page_tables[r, p //
    ps]`` at offset ``p % ps``; a position past the table writes the trash
    page 0, not the row's last page; each row gathers its whole page list
    (the full ``pages_per_slot() * page_size`` extent, filled or not,
    the footprint the scheduler's page math assumes) and sees the
    positions ``<= p`` of it: the causal mask in page-table coordinates."""
    ps = page_size
    b, mpp = page_tables.shape
    dev = page_tables.device
    tables = page_tables.long()
    pos = positions.long()[:, None] + torch.arange(step_len, device=dev)  # [b, T]
    inside = pos < mpp * ps
    page_col = torch.clamp(pos // ps, max=mpp - 1)
    page_id = torch.gather(tables, 1, page_col).masked_fill(~inside, 0)
    rows = ((tables * ps)[:, :, None]
            + torch.arange(ps, device=dev)[None, None, :]).reshape(b, mpp * ps)
    visible = torch.arange(mpp * ps, device=dev)[None, None, :] <= pos[:, :, None]
    return PagePlan(flat=(page_id * ps + pos % ps).reshape(-1), rows=rows,
                    visible=visible, inside=inside)


def paged_attention(
    q: torch.Tensor,  # [b, T, h, d] (pre-scaled)
    k: torch.Tensor,  # [b, T, h, d] this step's keys
    v: torch.Tensor,  # [b, T, h, d]
    pool: Tuple[torch.Tensor, torch.Tensor],  # (k, v) [n_pages*ps, h, d]
    plan: PagePlan,
) -> torch.Tensor:
    """Block-paged incremental attention: write this step's K/V into the
    layer's pools in place at ``plan.flat``, gather each row's pages back
    as a ``[b, mpp * ps, h, d]`` view, attend over the visible positions
    with the plain ``dot_product_attention``, and poison with NaN the
    outputs of positions past the table (the reference's overflow guard).
    An inactive row (all-zero table) writes and reads the trash page 0."""
    k_pool, v_pool = pool
    h, d = k.shape[2], k.shape[3]
    k_pool.index_copy_(0, plan.flat, k.reshape(-1, h, d).to(k_pool.dtype))
    v_pool.index_copy_(0, plan.flat, v.reshape(-1, h, d).to(v_pool.dtype))
    out = dot_product_attention(q, k_pool[plan.rows], v_pool[plan.rows], mask=plan.visible)
    return out.masked_fill(~plan.inside[:, :, None, None], float("nan"))


@dataclasses.dataclass
class DecodeCache:
    """The slot-per-batch KV cache of incremental decode: per layer a key
    and a value buffer ``[batch, cache_len, heads, head_dim]`` in
    ``cfg.dtype``, and the next write position, shared by every layer (the
    reference keeps one ``cache_index`` per layer; they always agree). A
    decode step writes its buffers in place and returns a cache with the
    position advanced; the position stays a 0-d int32 tensor on the device,
    so a step issues no host read."""

    keys: List[torch.Tensor]
    values: List[torch.Tensor]
    index: torch.Tensor

    def advanced(self, steps: int) -> "DecodeCache":
        return DecodeCache(self.keys, self.values, self.index + steps)

    def select_rows(self, rows: torch.Tensor) -> "DecodeCache":
        """The cache of the batch rows ``rows`` (new buffers), as beam
        search re-gathers it by parent beam."""
        return DecodeCache([k.index_select(0, rows) for k in self.keys],
                           [v.index_select(0, rows) for v in self.values], self.index)


def clean_cache(cfg: TransformerConfig, batch_size: int,
                device: Union[str, torch.device, None] = None,
                heads: Optional[int] = None) -> DecodeCache:
    """A clean decode cache (zero buffers of ``cfg.decode_cache_len or
    cfg.max_len`` positions, index 0): the port's counterpart of the
    reference's ``clean_cache``, which zeroes the cache shapes a module's
    init reports. ``heads``: the heads a layer holds (default all; a
    tensor rank's block, :func:`cache_heads`)."""
    cache_len = cfg.decode_cache_len or cfg.max_len
    shape = (batch_size, cache_len, heads or cfg.num_heads, cfg.head_dim)

    def zeros() -> List[torch.Tensor]:
        return [torch.zeros(shape, dtype=cfg.dtype, device=device) for _ in range(cfg.num_layers)]

    return DecodeCache(zeros(), zeros(), torch.zeros((), dtype=torch.int32, device=device))


def decode_attention(
    q: torch.Tensor,  # [b, 1, h, d] (pre-scaled)
    k: torch.Tensor,  # [b, 1, h, d] this step's key
    v: torch.Tensor,  # [b, 1, h, d]
    cache: Tuple[torch.Tensor, torch.Tensor],  # (k, v) [b, cache_len, h, d]
    index: torch.Tensor,  # 0-d int: the position this step writes
) -> torch.Tensor:
    """Incremental attention against a layer's decode cache: write this
    step's K/V at ``index`` in place and attend over positions ``<=
    index`` with the plain ``dot_product_attention`` (the causal mask in
    incremental form). Past the buffer the write lands on the last
    position, as ``dynamic_update_slice`` clamps its start, and the output
    is NaN, the reference's overflow guard."""
    k_buf, v_buf = cache
    b, cache_len = k_buf.shape[0], k_buf.shape[1]
    at = index.long().clamp(max=cache_len - 1).view(1)
    k_buf.index_copy_(1, at, k.to(k_buf.dtype))
    v_buf.index_copy_(1, at, v.to(v_buf.dtype))
    valid = torch.arange(cache_len, device=q.device) < index + 1
    out = dot_product_attention(q, k_buf, v_buf, mask=valid.expand(b, cache_len))
    return out.masked_fill(index >= cache_len, float("nan"))


class MultiHeadAttention(nn.Module):
    """Self- or cross-attention. ``attn_fn`` swaps the inner
    softmax(QK^T)V computation (the flash kernels plug in here); a call's
    ``attn_fn`` overrides the layer's. Given a layer's page ``pool`` and
    ``plan``, it runs the block-paged path (:func:`paged_attention`) with
    the forward's :class:`PagePlan`; given a layer's decode ``cache`` and
    ``cache_index``, the incremental path (:func:`decode_attention`), one
    token a call. ``kv_sink``, a list, receives this call's raw ``(k, v)``
    projections (the reference's ``sow_kv``). With ``tp`` it holds that
    rank's block of the heads."""

    def __init__(self, cfg: TransformerConfig, causal: bool = False,
                 attn_fn: Optional[Callable] = None, tp: Optional[TensorShard] = None):
        super().__init__()
        self.cfg, self.causal, self.attn_fn, self.tp = cfg, causal, attn_fn, tp
        lo, hi = (0, cfg.num_heads) if tp is None else tp.block(cfg.num_heads, "num_heads")
        self.heads = hi - lo
        d, inner = cfg.head_dim, cfg.num_heads * cfg.head_dim
        self.q = nn.Linear(cfg.embed_dim, self.heads * d)
        self.k = nn.Linear(cfg.embed_dim, self.heads * d)
        self.v = nn.Linear(cfg.embed_dim, self.heads * d)
        self.out = nn.Linear(self.heads * d, cfg.embed_dim)
        if tp is not None:
            self.tensor_splits = {f"{n}.{p}": split for n in "qkv"
                                  for p, split in column_splits(lo * d, hi * d, inner).items()}
            self.tensor_splits["out.weight"] = Split(1, lo * d, hi * d, inner)
        # q / sqrt(head_dim) with the divisor rounded to cfg.dtype first
        self.q_scale = float(torch.tensor(math.sqrt(cfg.head_dim)).to(cfg.dtype))

    def forward(self, x: torch.Tensor, kv: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None,
                pool: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                plan: Optional[PagePlan] = None,
                cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                cache_index: Optional[torch.Tensor] = None,
                kv_sink: Optional[list] = None,
                attn_fn: Optional[Callable] = None) -> torch.Tensor:
        cfg = self.cfg
        if self.tp is not None and pool is not None:
            raise NotImplementedError(
                "paged serving of a tensor-split model is not ported: the reference "
                "serves each replica on one device (its server builds no mesh), so a "
                "paged decoder over a tensor mesh would be a feature the JAX package "
                "lacks")
        x = enter(x, self.tp)
        kv = x if kv is None else enter(kv, self.tp)
        b, lq, lk = x.shape[0], x.shape[1], kv.shape[1]
        heads = (self.heads, cfg.head_dim)
        q = _dense(self.q, x, cfg.dtype).view(b, lq, *heads) / self.q_scale
        k = _dense(self.k, kv, cfg.dtype).view(b, lk, *heads)
        v = _dense(self.v, kv, cfg.dtype).view(b, lk, *heads)
        if kv_sink is not None:
            kv_sink.append((k, v))
        attn_fn = attn_fn or self.attn_fn
        if cache is not None:
            # one token a call: a longer step would need an intra-step
            # causal mask this path omits; a padding mask would make pad
            # K/V attendable for every later token
            if lq != 1:
                raise ValueError(
                    f"decode mode is incremental (one token per call); "
                    f"got a {lq}-token step"
                )
            if mask is not None:
                raise ValueError(
                    "decode mode does not support padding masks; feed "
                    "unpadded per-row prompts (mask=None)"
                )
            out = decode_attention(q, k, v, cache, cache_index)
        elif pool is not None:
            if mask is not None:
                raise ValueError(
                    "paged mode computes its own prefix mask; feed unpadded "
                    "per-row token slices (mask=None)"
                )
            if plan is None:
                raise ValueError("paged mode needs the forward's page plan")
            out = paged_attention(q, k, v, pool, plan)
        elif attn_fn is not None:
            out = attn_fn(q, k, v, mask=mask, causal=self.causal)
        else:
            out = dot_product_attention(q, k, v, mask=mask, causal=self.causal)
        return row_dense(self.out, out.reshape(b, lq, -1), cfg.dtype, self.tp)


class MlpBlock(nn.Module):
    """``wi``, tanh gelu, ``wo``; with ``tp`` that rank's block of the
    hidden width (``wi`` a column split, ``wo`` a row split)."""

    def __init__(self, cfg: TransformerConfig, tp: Optional[TensorShard] = None):
        super().__init__()
        self.cfg, self.tp = cfg, tp
        lo, hi = (0, cfg.mlp_dim) if tp is None else tp.block(cfg.mlp_dim, "mlp_dim")
        self.wi = nn.Linear(cfg.embed_dim, hi - lo)
        self.wo = nn.Linear(hi - lo, cfg.embed_dim)
        if tp is not None:
            self.tensor_splits = {f"wi.{p}": split for p, split in
                                  column_splits(lo, hi, cfg.mlp_dim).items()}
            self.tensor_splits["wo.weight"] = Split(1, lo, hi, cfg.mlp_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.gelu(_dense(self.wi, enter(x, self.tp), self.cfg.dtype), approximate="tanh")
        return row_dense(self.wo, h, self.cfg.dtype, self.tp)


class EncoderLayer(nn.Module):
    """Pre-LN residual block; ``causal=True`` makes it a decoder-only
    (GPT-style) layer. With ``use_moe`` the MLP is a ``SwitchMoeBlock``
    (``moe``, holding ``experts``' share when the mesh has an expert
    axis), whose aux loss goes to ``aux_sink`` when one is given; ``tp``
    splits the attention and the MLP over the tensor axis."""

    def __init__(self, cfg: TransformerConfig, attn_fn: Optional[Callable] = None,
                 causal: bool = False, use_moe: bool = False,
                 experts: Optional[ExpertShard] = None, tp: Optional[TensorShard] = None):
        super().__init__()
        self.cfg, self.use_moe = cfg, use_moe
        self.ln_attn = nn.LayerNorm(cfg.embed_dim, eps=cfg.ln_eps)
        self.attn = MultiHeadAttention(cfg, causal=causal, attn_fn=attn_fn, tp=tp)
        self.ln_mlp = nn.LayerNorm(cfg.embed_dim, eps=cfg.ln_eps)
        if use_moe:
            self.moe = SwitchMoeBlock(cfg, cfg.num_experts, cfg.moe_capacity_factor,
                                      cfg.moe_top_k, experts, tp)
        else:
            self.mlp = MlpBlock(cfg, tp)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                pool: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                plan: Optional[PagePlan] = None, aux_sink: Optional[list] = None,
                **attn_kw) -> torch.Tensor:
        """``attn_kw`` (``cache``, ``cache_index``, ``kv_sink``,
        ``attn_fn``) goes to the attention as is."""
        dt = self.cfg.dtype
        x = x + self.attn(_ln(self.ln_attn, x, dt), mask=mask, pool=pool, plan=plan, **attn_kw)
        h = _ln(self.ln_mlp, x, dt)
        if not self.use_moe:
            return x + self.mlp(h)
        y, aux = self.moe(h)
        if aux_sink is not None:
            aux_sink.append(aux)
        return x + y


class DecoderLayer(nn.Module):
    """Causal self-attention, cross-attention over the encoder output, then
    the MLP (the reference's T5-style decoder block), each pre-LN with its
    own norm (``ln_self``, ``ln_cross``, ``ln_mlp``). Given a layer's
    decode ``cache`` and ``cache_index`` the self-attention takes the
    incremental path (:func:`decode_attention`, one token a call); the
    cross-attention is always a full attention over ``enc`` under
    ``enc_mask`` and recomputes its K/V every call, as the reference's
    does. ``attn_fn`` overrides the layer's attention for this call;
    ``tp`` splits both attentions and the MLP over the tensor axis."""

    def __init__(self, cfg: TransformerConfig, attn_fn: Optional[Callable] = None,
                 tp: Optional[TensorShard] = None):
        super().__init__()
        self.cfg = cfg
        self.ln_self = nn.LayerNorm(cfg.embed_dim, eps=cfg.ln_eps)
        self.self_attn = MultiHeadAttention(cfg, causal=True, attn_fn=attn_fn, tp=tp)
        self.ln_cross = nn.LayerNorm(cfg.embed_dim, eps=cfg.ln_eps)
        self.cross_attn = MultiHeadAttention(cfg, attn_fn=attn_fn, tp=tp)
        self.ln_mlp = nn.LayerNorm(cfg.embed_dim, eps=cfg.ln_eps)
        self.mlp = MlpBlock(cfg, tp)

    def forward(self, x: torch.Tensor, enc: torch.Tensor,
                enc_mask: Optional[torch.Tensor] = None,
                cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                cache_index: Optional[torch.Tensor] = None,
                attn_fn: Optional[Callable] = None) -> torch.Tensor:
        dt = self.cfg.dtype
        x = x + self.self_attn(_ln(self.ln_self, x, dt), cache=cache, cache_index=cache_index,
                               attn_fn=attn_fn)
        x = x + self.cross_attn(_ln(self.ln_cross, x, dt), kv=enc, mask=enc_mask,
                                attn_fn=attn_fn)
        return x + self.mlp(_ln(self.ln_mlp, x, dt))


class Embedder(nn.Module):
    """Token + learned positional embeddings; the token table is reused
    transposed as the output head (weight tying). With ``tp`` it holds
    that rank's rows ``[vocab_lo, vocab_hi)`` of the table (split unevenly
    where the vocabulary does not divide) and the head gives the matching
    logit columns."""

    def __init__(self, cfg: TransformerConfig, seq_index: int = 0,
                 tp: Optional[TensorShard] = None):
        super().__init__()
        self.cfg, self.tp = cfg, tp
        # this rank's block of a sequence-sharded mesh: with no pos_offset,
        # its positions start at seq_index * (the local length)
        self.seq_index = seq_index
        self.vocab_lo, hi = (0, cfg.vocab_size) if tp is None else tp.rows(cfg.vocab_size)
        self.tok = nn.Embedding(hi - self.vocab_lo, cfg.embed_dim)
        self.pos = nn.Parameter(torch.empty(cfg.max_len, cfg.embed_dim))
        if tp is not None:
            self.tensor_splits = {"tok.weight": Split(0, self.vocab_lo, hi, cfg.vocab_size)}

    def forward(self, ids: torch.Tensor,
                pos_offset: Union[int, torch.Tensor, None] = None) -> torch.Tensor:
        """``pos_offset`` shifts the positional slice; a VECTOR ``[b]``
        gives each row its own offset (paged decode steps rows at
        different positions in one call). Rows past the table read NaN,
        as the reference's ``jnp.take`` fills out-of-range indices. A 0-d
        tensor (incremental decode's cache position) is read on the device
        and clamped so the slice fits, as ``dynamic_slice_in_dim`` does."""
        length = ids.shape[-1]
        max_len = self.pos.shape[0]
        if isinstance(pos_offset, torch.Tensor) and pos_offset.dim() >= 1:
            rows = pos_offset.long()[:, None] + torch.arange(length, device=ids.device)
            inside = (rows >= 0) & (rows < max_len)
            pos = self.pos[rows.clamp(0, max_len - 1)]  # [b, l, embed]
            pos = pos.masked_fill(~inside[..., None], float("nan"))
        elif isinstance(pos_offset, torch.Tensor):
            start = pos_offset.long().clamp(0, max_len - length)
            pos = self.pos.index_select(0, start + torch.arange(length, device=ids.device))
        else:
            start = self.seq_index * length if pos_offset is None else int(pos_offset)
            pos = self.pos[start:start + length]
        tok = vocab_parallel_lookup(self.tok.weight, ids, self.vocab_lo, group_of(self.tp))
        return (tok + pos).to(self.cfg.dtype)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        # tied output head; float32 logits for a stable softmax (this
        # rank's vocab columns on a tensor mesh)
        return F.linear(enter(x.float(), self.tp), self.tok.weight)

    def argmax(self, logits: torch.Tensor) -> torch.Tensor:
        """The greedy pick over :meth:`logits`' vocabulary (the
        vocab-parallel argmax over a split's columns: ties to the lowest
        index, as ``jnp.argmax``)."""
        if self.tp is None:
            return torch.argmax(logits, dim=-1)
        return vocab_parallel_argmax(logits, self.vocab_lo, self.tp.group)

    def whole(self, logits: torch.Tensor) -> torch.Tensor:
        """:meth:`logits` over the whole vocabulary: a split's columns
        gathered over the tensor group (no gradient), for a pick that
        needs every logit (a sampled draw, a beam's scores)."""
        if self.tp is None:
            return logits
        split = Split(logits.dim() - 1, self.vocab_lo,
                      self.vocab_lo + self.tok.weight.shape[0], self.cfg.vocab_size)
        return gather_tensor(logits, split, self.tp.group, self.tp.size)


def token_loss(logits: torch.Tensor, target: torch.Tensor,
               vocab: Optional[Tuple[int, object]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(per-position float32 cross-entropy, per-position hit)`` of
    ``logits [..., V]`` against ``target [...]``; over a vocab split
    (``vocab``: ``(first column, tensor group)``) through the
    vocab-parallel cross-entropy and argmax."""
    target = target.long()
    if vocab is None:
        per_tok = F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                                  target.reshape(-1), reduction="none").reshape(target.shape)
        return per_tok, (logits.argmax(-1) == target).float()
    lo, group = vocab
    return (vocab_parallel_cross_entropy(logits, target, lo, group),
            (vocab_parallel_argmax(logits, lo, group) == target).float())


def masked_token_loss(logits: torch.Tensor, target: torch.Tensor, weight: torch.Tensor,
                      group=None, vocab: Optional[Tuple[int, object]] = None,
                      batch_blocks: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(loss, accuracy)`` over the positions ``weight`` selects: float32
    cross-entropy and argmax accuracy summed over them and divided by
    ``max(sum(weight), 1)``, as the reference's MLM and seq2seq losses take
    them over the global batch (a batch with no selected position gives
    0). ``group`` (:func:`token_group`: the batch and sequence axes) holds
    the other ranks' rows and tokens: the sums run over every rank's, so
    each rank holds the global mean, and its gradient is its own tokens'
    part, scaled by ``batch_blocks`` (the batch axes' size) so that the
    average of the gradients over the batch axes, which every parallel
    mode takes, is the global mean's. ``vocab``
    (``tensor_parallel.vocab_split``): the logits are a vocab split's
    columns."""
    per_tok, hit = token_loss(logits, target, vocab)
    w = weight.float()
    denom = all_reduce_sum(w.sum(), group).clamp_min(1.0)
    hits = all_reduce_sum((hit * w).sum(), group)
    loss = sum_over((per_tok * w).sum(), group) / denom
    return scale_grad(loss, batch_blocks), hits / denom


def init_params(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """The reference's initializers, drawn from ``generator``: xavier-
    uniform projection weights (fan-in/out of the flattened flax kernel,
    which is what ``nn.Linear``'s ``[out, in]`` gives), zero biases,
    normal(0.02) embeddings, unit layer-norm scales."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Linear):
                nn.init.xavier_uniform_(m.weight, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, Embedder):
                m.tok.weight.normal_(0.0, 0.02, generator=generator)
                m.pos.normal_(0.0, 0.02, generator=generator)
            elif isinstance(m, SwitchMoeBlock):
                m.init_weights(generator)
    return module


def mesh_device(mesh) -> torch.device:
    """The device of a :class:`Mesh`, or ``mesh`` itself when it is one
    (the port's one-process mesh)."""
    return mesh.device if isinstance(mesh, Mesh) else torch.device(mesh)


def seq_index(mesh) -> int:
    """This rank's block of the sequence (0 off a sequence-sharded mesh)."""
    return mesh.index(AXIS_SEQUENCE) if isinstance(mesh, Mesh) else 0


def seq_group(mesh):
    """The sequence group of a sequence-sharded mesh, else None."""
    return mesh.group(AXIS_SEQUENCE) if isinstance(mesh, Mesh) else None


def token_group(mesh) -> Tuple[object, int]:
    """``(group, batch blocks)`` of :func:`masked_token_loss` over
    ``mesh``: the group of the batch and sequence axes (None for one
    process) and the number of blocks the batch is split into."""
    if not isinstance(mesh, Mesh):
        return None, 1
    return mesh.group(AXIS_DATA, AXIS_FSDP, AXIS_SEQUENCE), mesh.size(*BATCH_AXES)


def cache_heads(model: nn.Module) -> int:
    """The heads a layer of ``model`` holds: all of them, or a tensor
    rank's block (the decode cache's width)."""
    return next(m.heads for m in model.modules() if isinstance(m, MultiHeadAttention))


def make_layers(cfg: TransformerConfig, attn_fn: Optional[Callable] = None,
                causal: bool = False, mesh=None) -> nn.ModuleList:
    """The encoder stack's layers, MoE where ``cfg.layer_uses_moe`` says,
    holding the mesh's expert share and tensor blocks."""
    experts, tp = ExpertShard.of(mesh), TensorShard.of(mesh)
    return nn.ModuleList(
        EncoderLayer(cfg, attn_fn=attn_fn, causal=causal, use_moe=cfg.layer_uses_moe(i),
                     experts=experts, tp=tp)
        for i in range(cfg.num_layers)
    )


def call_layer(cfg: TransformerConfig, layer: nn.Module, *args, **kw):
    """``layer(*args, **kw)``, recomputed in the backward when
    ``cfg.remat`` (the reference's ``maybe_remat``: activations are not
    held, ``torch.utils.checkpoint`` without reentry runs the layer again)."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(layer, *args, use_reentrant=False, **kw)
    return layer(*args, **kw)


def apply_with_aux(model: nn.Module, cfg: TransformerConfig, *inputs, **kw):
    """``model(*inputs, **kw)`` with the MoE layers' aux losses -> ``(out,
    aux)``, aux the SUM over MoE layers (the reference's sown ``losses``);
    dense configs give aux 0."""
    if cfg.num_experts > 0:
        sink: List[torch.Tensor] = []
        out = model(*inputs, aux_sink=sink, **kw)
        return out, sum(sink, torch.zeros((), device=sink[0].device) if sink else 0.0)
    return model(*inputs, **kw), 0.0


def add_moe_aux(cfg: TransformerConfig, loss: torch.Tensor, metrics: Dict[str, torch.Tensor],
                aux) -> torch.Tensor:
    """The reference's MoE objective: ``loss + moe_aux_weight * aux``, with
    ``moe_aux`` among the metrics (dense configs: ``loss`` as is)."""
    if cfg.num_experts > 0:
        metrics["moe_aux"] = aux
        loss = loss + cfg.moe_aux_weight * aux
    return loss


class Encoder(nn.Module):
    """Embeddings, the encoder stack and a final norm (the reference's
    ``Encoder``): ``ids [b, l]`` -> ``[b, l, embed]`` in ``cfg.dtype``,
    under an optional ``[b, l]`` key mask. Parameter names are
    ``BertWithHead``'s (``embed``, ``layers``, ``ln_final``)."""

    def __init__(self, cfg: TransformerConfig, attn_fn: Optional[Callable] = None, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.embed = Embedder(cfg, seq_index(mesh), TensorShard.of(mesh))
        self.layers = make_layers(cfg, attn_fn=attn_fn, mesh=mesh)
        self.ln_final = nn.LayerNorm(cfg.embed_dim, eps=cfg.ln_eps)

    def forward(self, ids: torch.Tensor, mask: Optional[torch.Tensor] = None,
                aux_sink: Optional[list] = None) -> torch.Tensor:
        x = self.embed(ids)
        for layer in self.layers:
            x = call_layer(self.cfg, layer, x, mask, aux_sink=aux_sink)
        return _ln(self.ln_final, x, self.cfg.dtype)


def select_attn_fn(cfg: TransformerConfig, seq_len: int, mesh):
    """The attention-impl policy (the reference's, shared by every family's
    ``task_for_mesh``) over ``mesh``, a :class:`Mesh` or, for one
    process, its device. ``seq_len`` is the global sequence length.

    - ``ring``/``ulysses`` pins are honoured on any mesh with a sequence
      axis, and in a one-process run (a ring of one, Ulysses with nothing
      to exchange); a multi-rank mesh without the axis raises the
      reference's ``ValueError``.
    - On a sequence-sharded mesh, ``auto`` is Ulysses while a rank's head
      count (``h / tensor``) divides by the sequence degree and ring
      beyond it; a ``full`` or ``flash`` pin raises ``ValueError``.
    - Otherwise ``flash`` -> the CUDA kernels (their plain versions on the
      CPU), ``full`` -> plain attention, ``auto`` -> flash on the card
      from FLASH_SEQ_THRESHOLD up.

    Ulysses' local attention (full sequence, ``h/(t n)`` heads) is the flash
    kernels on the card at every length, for the head widths they are
    built for (``tests/test_ulysses.py``'s composition), and the
    reference's plain attention else."""
    from tfk8s_tpu_torch.parallel.ring_attention import make_ring_attn_fn
    from tfk8s_tpu_torch.parallel.ulysses import make_ulysses_attn_fn

    device = mesh_device(mesh)
    inner = flash_attention if device.type == "cuda" and cfg.head_dim in HEAD_DIMS else None
    sp = mesh.size(AXIS_SEQUENCE) if isinstance(mesh, Mesh) else 1
    if cfg.attention_impl == "ring":
        return make_ring_attn_fn(mesh)
    if cfg.attention_impl == "ulysses":
        return make_ulysses_attn_fn(mesh, inner=inner)
    if sp > 1:
        if cfg.attention_impl != "auto":
            raise ValueError(
                f"attention_impl={cfg.attention_impl!r} pinned on a "
                "sequence-sharded mesh; sequence parallelism needs 'auto', "
                "'ring', or 'ulysses'"
            )
        if (cfg.num_heads // mesh.size(AXIS_TENSOR)) % sp == 0:
            return make_ulysses_attn_fn(mesh, inner=inner)
        return make_ring_attn_fn(mesh)
    return auto_flash_attn_fn(cfg.attention_impl, seq_len, device)
