"""Peer tier: pull a warm prefix from another replica over KVTransport.

A replica that misses a prefix locally but learns (via the gateway
cache directory) that a peer holds it warm fetches the peer's pages
instead of re-prefilling. The fetch rides the disaggregation seam
end-to-end: the peer exports a ``KVHandoffBuffer.prefix`` buffer, the
transport moves it (``LocalKVTransport`` round-trips the wire bytes,
which re-verifies the digest chain at the destination), and THIS module
re-checks the chain against the *requesting* prompt — a stale or
confused peer returning a self-consistent buffer for the WRONG prefix
is refused just like a tampered one.

Every failure shape — peer ejected, peer holds nothing, transport
corruption, chain mismatch — raises :class:`HandoffError`; the
executor's caller catches it and falls back to plain prefill, so a
peer fetch is never a user-visible failure.

A copy of the JAX package's ``runtime/kvtier/peer.py`` (only the
imports changed).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

from tfk8s_tpu_torch.runtime.handoff import (
    HandoffError,
    KVHandoffBuffer,
    KVTransport,
    LocalKVTransport,
)
from tfk8s_tpu_torch.runtime.paging import prefix_digest_chain


def fetch_prefix(
    resolve: Callable[[str], Any],
    peer_key: str,
    tokens: Sequence[int],
    transport: Optional[KVTransport] = None,
) -> KVHandoffBuffer:
    """Fetch the longest warm prefix of ``tokens`` that ``peer_key``
    holds. Returns a verified prefix buffer whose digest chain matches
    the requesting prompt; raises :class:`HandoffError` otherwise."""
    transport = transport or LocalKVTransport()
    toks = [int(t) for t in tokens]
    peer = resolve(peer_key)
    if peer is None:
        raise HandoffError(
            f"peer {peer_key!r} not resolvable (drained or ejected)"
        )
    exporter = getattr(peer, "export_prefix", None)
    if exporter is None:
        raise HandoffError(
            f"peer {peer_key!r} does not export prefixes (no KV tier)"
        )
    buf = exporter(toks)
    if buf is None:
        raise HandoffError(
            f"peer {peer_key!r} holds no prefix for this prompt"
        )
    # the transport round trip is the integrity gate for the BYTES
    # (from_bytes -> verify at the destination); tampering anywhere on
    # the wire surfaces here as HandoffError
    buf, _nbytes = transport.transfer(buf)
    # ...and the chain re-check is the integrity gate for the IDENTITY:
    # the buffer must be a prefix of OUR prompt, not merely self-
    # consistent with its own tokens
    ps = buf.page_size
    if ps < 1 or len(buf.tokens) % ps != 0:
        raise HandoffError(
            f"peer buffer is not page-aligned: {len(buf.tokens)} token(s) "
            f"@ page_size {ps}"
        )
    n_pages = len(buf.tokens) // ps
    if n_pages == 0 or len(toks) < len(buf.tokens):
        raise HandoffError(
            f"peer buffer covers {len(buf.tokens)} token(s) — not a "
            f"usable prefix of a {len(toks)}-token prompt"
        )
    want = prefix_digest_chain(toks, ps, n_pages)
    if list(buf.digests) != want:
        raise HandoffError(
            "peer buffer digest chain does not match the requesting "
            "prompt — refusing foreign K/V"
        )
    return buf


__all__ = ["fetch_prefix"]
