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
``cfg.dtype``, written in place. The reference's slot-per-batch decode
cache, MoE, remat and sequence parallelism are later ROADMAP items and
raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from tfk8s_tpu_torch.ops.flash_attention import auto_flash_attn_fn


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
    # 'auto' | 'full' | 'flash' ('ring' | 'ulysses' are ROADMAP item 1.9)
    attention_impl: str = "auto"
    # MoE (ROADMAP item 1.9): kept so the env contract parses; >0 raises
    num_experts: int = 0
    moe_top_k: int = 1
    ln_eps: float = 1e-6
    # block-paged KV cache (continuous-batching decode): each layer's K/V
    # live in a pool of kv_max_pages pages of kv_page_size tokens; page 0
    # is the trash page inactive rows write into (runtime/paging)
    kv_page_size: Optional[int] = None
    kv_max_pages: Optional[int] = None

    def pages_per_slot(self) -> int:
        """Page-table width: pages needed to cover ``max_len`` tokens."""
        if not self.kv_page_size:
            raise ValueError("kv_page_size is unset; not a paged config")
        return -(-self.max_len // self.kv_page_size)

    def require_ported(self) -> None:
        """Raise for the features this slice of the port does not run."""
        if self.num_experts > 0:
            raise NotImplementedError(
                f"num_experts={self.num_experts}: MoE layers are ROADMAP item 1.9"
            )
        if self.remat:
            raise NotImplementedError("remat: activation recompute is ROADMAP item 1.9")
        if self.attention_impl in ("ring", "ulysses"):
            raise NotImplementedError(
                f"attention_impl={self.attention_impl!r}: sequence parallelism "
                "is ROADMAP item 1.9"
            )


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


class MultiHeadAttention(nn.Module):
    """Self- or cross-attention. ``attn_fn`` swaps the inner
    softmax(QK^T)V computation (the flash kernels plug in here). Given a
    layer's page ``pool`` and ``plan``, it runs the
    block-paged path (:func:`paged_attention`) with the forward's
    :class:`PagePlan`."""

    def __init__(self, cfg: TransformerConfig, causal: bool = False,
                 attn_fn: Optional[Callable] = None):
        super().__init__()
        self.cfg, self.causal, self.attn_fn = cfg, causal, attn_fn
        inner = cfg.num_heads * cfg.head_dim
        self.q = nn.Linear(cfg.embed_dim, inner)
        self.k = nn.Linear(cfg.embed_dim, inner)
        self.v = nn.Linear(cfg.embed_dim, inner)
        self.out = nn.Linear(inner, cfg.embed_dim)
        # q / sqrt(head_dim) with the divisor rounded to cfg.dtype first
        self.q_scale = float(torch.tensor(math.sqrt(cfg.head_dim)).to(cfg.dtype))

    def forward(self, x: torch.Tensor, kv: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None,
                pool: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                plan: Optional[PagePlan] = None) -> torch.Tensor:
        cfg = self.cfg
        kv = x if kv is None else kv
        b, lq, lk = x.shape[0], x.shape[1], kv.shape[1]
        heads = (cfg.num_heads, cfg.head_dim)
        q = _dense(self.q, x, cfg.dtype).view(b, lq, *heads) / self.q_scale
        k = _dense(self.k, kv, cfg.dtype).view(b, lk, *heads)
        v = _dense(self.v, kv, cfg.dtype).view(b, lk, *heads)
        if pool is not None:
            if mask is not None:
                raise ValueError(
                    "paged mode computes its own prefix mask; feed unpadded "
                    "per-row token slices (mask=None)"
                )
            if plan is None:
                raise ValueError("paged mode needs the forward's page plan")
            out = paged_attention(q, k, v, pool, plan)
        elif self.attn_fn is not None:
            out = self.attn_fn(q, k, v, mask=mask, causal=self.causal)
        else:
            out = dot_product_attention(q, k, v, mask=mask, causal=self.causal)
        return _dense(self.out, out.reshape(b, lq, -1), cfg.dtype)


class MlpBlock(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        self.wi = nn.Linear(cfg.embed_dim, cfg.mlp_dim)
        self.wo = nn.Linear(cfg.mlp_dim, cfg.embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.gelu(_dense(self.wi, x, self.cfg.dtype), approximate="tanh")
        return _dense(self.wo, h, self.cfg.dtype)


class EncoderLayer(nn.Module):
    """Pre-LN residual block; ``causal=True`` makes it a decoder-only
    (GPT-style) layer."""

    def __init__(self, cfg: TransformerConfig, attn_fn: Optional[Callable] = None,
                 causal: bool = False):
        super().__init__()
        self.cfg = cfg
        self.ln_attn = nn.LayerNorm(cfg.embed_dim, eps=cfg.ln_eps)
        self.attn = MultiHeadAttention(cfg, causal=causal, attn_fn=attn_fn)
        self.ln_mlp = nn.LayerNorm(cfg.embed_dim, eps=cfg.ln_eps)
        self.mlp = MlpBlock(cfg)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                pool: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                plan: Optional[PagePlan] = None) -> torch.Tensor:
        dt = self.cfg.dtype
        x = x + self.attn(_ln(self.ln_attn, x, dt), mask=mask, pool=pool, plan=plan)
        return x + self.mlp(_ln(self.ln_mlp, x, dt))


class Embedder(nn.Module):
    """Token + learned positional embeddings; the token table is reused
    transposed as the output head (weight tying)."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        self.tok = nn.Embedding(cfg.vocab_size, cfg.embed_dim)
        self.pos = nn.Parameter(torch.empty(cfg.max_len, cfg.embed_dim))

    def forward(self, ids: torch.Tensor,
                pos_offset: Union[int, torch.Tensor, None] = None) -> torch.Tensor:
        """``pos_offset`` shifts the positional slice; a VECTOR ``[b]``
        gives each row its own offset (paged decode steps rows at
        different positions in one call). Rows past the table read NaN,
        as the reference's ``jnp.take`` fills out-of-range indices."""
        length = ids.shape[-1]
        if isinstance(pos_offset, torch.Tensor) and pos_offset.dim() >= 1:
            rows = pos_offset.long()[:, None] + torch.arange(length, device=ids.device)
            inside = (rows >= 0) & (rows < self.pos.shape[0])
            pos = self.pos[rows.clamp(0, self.pos.shape[0] - 1)]  # [b, l, embed]
            pos = pos.masked_fill(~inside[..., None], float("nan"))
        else:
            start = 0 if pos_offset is None else int(pos_offset)
            pos = self.pos[start:start + length]
        return (self.tok(ids) + pos).to(self.cfg.dtype)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        # tied output head; float32 logits for a stable softmax
        return F.linear(x.float(), self.tok.weight)


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
    return module


def select_attn_fn(cfg: TransformerConfig, seq_len: int, device: torch.device):
    """The attention-impl policy on one device: ``flash`` -> the CUDA
    kernels (their plain versions on the CPU), ``full`` -> plain attention,
    ``auto`` -> flash on the card from FLASH_SEQ_THRESHOLD up.
    ``ring``/``ulysses`` need a sequence-sharded mesh (ROADMAP item 1.9)."""
    cfg.require_ported()
    return auto_flash_attn_fn(cfg.attention_impl, seq_len, device)
