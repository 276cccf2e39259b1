"""The shared encoder stack with a tied head, ported from the JAX
package's ``models/bert.py``: ``BertWithHead`` (``causal=True`` is the GPT
stack; ``decode=True`` its incremental KV-cache mode and ``sow_kv=True``
the full forward that also returns every layer's K/V, as the reference's
flags at ``bert.py:43-100``) and the hermetic chain-token stream both
families train on. The BERT MLM task itself is ROADMAP item 1.7."""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from tfk8s_tpu_torch.models.transformer import (
    DecodeCache,
    Embedder,
    EncoderLayer,
    TransformerConfig,
    _ln,
    page_plan,
)

MASK_ID = 0  # reserved mask token; chain tokens live in [1, vocab)
_CHAIN_A, _CHAIN_B = 31, 17
_RESTART_P = 0.05


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
    parameters."""

    def __init__(self, cfg: TransformerConfig, attn_fn: Optional[Callable] = None,
                 causal: bool = False, decode: bool = False, sow_kv: bool = False):
        super().__init__()
        cfg.require_ported()
        if decode and sow_kv:
            raise ValueError("decode and sow_kv are separate modes")
        self.cfg = cfg
        self.decode, self.sow_kv = decode, sow_kv
        self.embed = Embedder(cfg)
        self.layers = nn.ModuleList(
            EncoderLayer(cfg, attn_fn=attn_fn, causal=causal)
            for _ in range(cfg.num_layers)
        )
        self.ln_final = nn.LayerNorm(cfg.embed_dim, eps=cfg.ln_eps)

    def forward(self, ids: torch.Tensor, mask: Optional[torch.Tensor] = None,
                pos_offset: Union[int, torch.Tensor, None] = None,
                page_tables: Optional[torch.Tensor] = None,
                pages: Optional[Sequence[Tuple[torch.Tensor, torch.Tensor]]] = None,
                cache: Optional[DecodeCache] = None,
                attn_fn: Optional[Callable] = None,
                ):
        """``pages`` (one ``(k, v)`` pool per layer) with ``page_tables``
        runs the block-paged path; ``pos_offset`` is then the per-row
        position vector and feeds both the positional gather and the
        page math (one :func:`page_plan` for every layer), as in the
        reference's ``paged=True`` stack. ``cache`` is the decode mode's
        cache (``pos_offset`` then the tokens' position, as in the
        reference a separate argument). ``attn_fn`` overrides the layers'
        attention for this call."""
        if self.decode and cache is None:
            raise ValueError("decode mode needs the decode cache")
        if cache is not None and not self.decode:
            raise ValueError("a decode cache needs a decode-mode module")
        x = self.embed(ids, pos_offset=pos_offset)
        sown = [] if self.sow_kv else None
        attn_kw = dict(kv_sink=sown, attn_fn=attn_fn)
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
                x = layer(x, mask, **attn_kw)
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
