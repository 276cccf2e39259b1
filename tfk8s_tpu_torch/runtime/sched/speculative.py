"""Speculative decoding engine for the continuous-batching loop.

A small DRAFT model (``tiny_config`` by default) proposes ``k`` tokens
per live row; the serving (TARGET) model verifies all of them in ONE
packed chunk step (``gpt.verify_step_packed``); the executor accepts the
longest draft prefix the target agrees with and appends the target's own
correction token. Because every emitted token is the TARGET's pick at
its position — computed with the same per-row sampling and the same
position-folded PRNG a plain decode step would use — the output stream
is token-identical to non-speculative decoding at the same seeds, no
matter how bad the draft is. Draft quality only sets the speedup: accept
ratio ``a/k`` turns one verify dispatch into ``1..k+1`` emitted tokens.

Paging: the draft runs against its OWN page pool but reuses the TARGET's
page-table VALUES — the draft decoder is built with the target's
``kv_page_size`` / ``kv_max_pages`` (asserted), so ``pages_per_slot()``
matches and every target lease indexes a valid draft page. The executor
already draws a row's whole lease at admission (prefill never grows the
table mid-decode), so speculative rounds need NO page bookkeeping at
all. Draft KV for REJECTED proposals goes stale in the draft pool; the
per-round catch-up chunk re-scatters the true emitted tokens before the
next proposal reads anything, the same overwrite-before-read order the
paged attention itself relies on.

The engine is deliberately dumb about slots: ``propose`` reads the
executor's live ``_Slot`` rows (``spec_chunk`` — the tokens emitted last
round — plus ``position`` and the lease's page table) and returns a
``[slots, k]`` proposal matrix. All accept/retire policy stays in the
executor.

A copy of the JAX package's ``runtime/sched/speculative.py``; the
draft it builds is the port's torch ``PagedGptDecoder``, on the target's
device.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np


class SpeculativeEngine:
    """Owns the draft decoder and the draft-side KV discipline.

    ``draft`` is a loaded ``runtime.server.PagedGptDecoder`` whose page
    geometry matches the target's (see :meth:`build`). The draft always
    proposes GREEDILY — sampling only shapes the target's verify picks,
    where correctness lives; a greedy draft maximizes the accepted
    prefix against a mostly-greedy target and keeps proposal cost at one
    argmax per token.
    """

    def __init__(self, draft: Any, k: int = 4) -> None:
        self.draft = draft
        # clamp rather than raise: a bad knob must degrade to k=1
        # (plain-decode throughput), never brick the replica
        self.k = max(1, int(k))
        # running accept accounting the executor folds into
        # tfk8s_sched_spec_accept_ratio
        self.proposed_total = 0
        self.accepted_total = 0

    # -- construction --------------------------------------------------

    @classmethod
    def build(
        cls,
        target: Any,
        k: int = 4,
        size: str = "tiny",
        checkpoint: Optional[str] = None,
        params: Optional[Any] = None,
    ) -> "SpeculativeEngine":
        """Build + load a draft decoder shaped to shadow ``target``: the
        draft keeps its own (small) width/depth but takes the target's
        vocab, max_len, slot count and page geometry so the two models
        agree on token ids, page-table extent and packed array shapes.
        ``params`` injects pre-trained draft params (the bench trains
        the draft on the same hermetic chain as the target so acceptance
        is genuinely high); otherwise ``checkpoint`` (default
        ``"seed:0"``) initializes them."""
        import dataclasses as _dc

        # lazy: server imports this package inside the executor, never
        # at module scope — keep the reverse edge lazy too
        from tfk8s_tpu_torch.runtime.server import PagedGptDecoder, _gpt_config_of

        base = _dc.replace(
            _gpt_config_of(size),
            vocab_size=target.vocab_size,
            max_len=target.max_len,
        )
        draft = PagedGptDecoder(
            checkpoint or "seed:0",
            slots=target.slots,
            page_size=target.page_size,
            max_pages=target.max_pages,
            gen_tokens=1,
            size=size,
            prefill_chunk=target.prefill_chunk,
            cfg=base,
            params=params,
            device=target.device,
        )
        draft.load()
        assert draft.pages_per_slot == target.pages_per_slot, (
            "draft/target page-table extent desync: "
            f"{draft.pages_per_slot} != {target.pages_per_slot}"
        )
        return cls(draft, k=k)

    # -- draft-side KV mirroring ---------------------------------------

    def prefill_batch(self, batch: np.ndarray) -> None:
        """Mirror a target prefill dispatch into the draft pool: the
        SAME packed batch array (chunk tokens, base position, page
        table) scatters the draft's prompt K/V at the same page ids.
        Picks are discarded — the draft never emits during prefill."""
        self.draft.prefill_batch(batch)

    def prefill_tokens(self, tokens: Sequence[int], pages: Sequence[int]) -> None:
        """Catch the draft up over a FULL resident token list — the
        restore half of preempt/spill and the import half of a KV
        handoff, where the target's KV arrives as a buffer the draft
        never saw. Chunked ``[1, C]`` like the executor's trickle
        path."""
        c = self.draft.prefill_chunk
        mpp = self.draft.pages_per_slot
        plen = len(tokens)
        base = 0
        while base < plen:
            end = min(base + c, plen)
            batch = np.zeros((1, c + 1 + mpp), np.int32)
            batch[0, : end - base] = np.asarray(tokens[base:end], np.int32)
            batch[0, c] = base
            batch[0, c + 1 : c + 1 + len(pages)] = np.asarray(pages, np.int32)
            self.draft.prefill_batch(batch)
            base = end

    # -- proposal ------------------------------------------------------

    def propose(self, slots: List[Any]) -> np.ndarray:
        """One speculative round's draft half: catch the draft up on
        every row's last-round emitted chunk (one packed prefill-shaped
        dispatch — this also produces the first proposal ``d0`` as the
        pick at the chunk's last real token), then chain ``k - 1``
        greedy draft decode steps for the rest. Returns a ``[len(slots),
        k]`` int32 proposal matrix; rows without a live slot (or an
        empty ``spec_chunk``) are zero-filled junk the caller must skip.

        The catch-up chunk embeds row ``r``'s emitted tokens at base
        position ``position - len(chunk) + 1`` — the absolute position
        of the first emitted token — so the draft's KV and logits line
        up with the target's stream exactly, including after an
        all-``k``-accepted round where positions ``P..P+k`` were written
        by the draft's own (now partially stale) proposals."""
        n = len(slots)
        mpp = self.draft.pages_per_slot
        c = self.k + 1  # a round emits at most k accepted + 1 correction
        batch = np.zeros((n, c + 1 + mpp), np.int32)
        lens = np.zeros(n, np.int64)
        for i, slot in enumerate(slots):
            chunk = getattr(slot, "spec_chunk", None) if slot else None
            if not chunk:
                continue
            base = slot.position - len(chunk) + 1
            batch[i, : len(chunk)] = np.asarray(chunk, np.int32)
            batch[i, c] = base
            table = slot.lease.pages
            batch[i, c + 1 : c + 1 + len(table)] = np.asarray(table, np.int32)
            lens[i] = len(chunk)
        picks = self.draft.prefill_batch(batch)  # [n, c] numpy
        state = np.zeros((n, 2 + mpp), np.int32)
        d0 = np.zeros(n, np.int32)
        for i, slot in enumerate(slots):
            if not lens[i]:
                continue
            d0[i] = picks[i, lens[i] - 1]
            state[i, 0] = d0[i]
            state[i, 1] = slot.position + 1
            table = slot.lease.pages
            state[i, 2 : 2 + len(table)] = np.asarray(table, np.int32)
        cols = [d0]
        dev_state: Any = state
        for _ in range(self.k - 1):
            nxt, dev_state = self.draft.decode(dev_state)
            cols.append(np.asarray(nxt, np.int32))
        return np.stack(cols, axis=1)

    # -- accounting ----------------------------------------------------

    def record(self, proposed: int, accepted: int) -> None:
        self.proposed_total += int(proposed)
        self.accepted_total += int(accepted)

    @property
    def accept_ratio(self) -> float:
        if not self.proposed_total:
            return 0.0
        return self.accepted_total / self.proposed_total
