"""KV page handoff between the prefill and decode pools (disaggregated
serving), a copy of the JAX package's ``runtime/handoff.py`` whose wire
bytes interchange with it: a buffer exported by either backend imports
into the other.

A prefill-pool replica runs chunked prefill to completion, picks the
request's FIRST output token, then exports the warm KV state —
:class:`KVHandoffBuffer` carries the prompt, the first token, the
generation budget, the page-aligned prefix digest chain
(runtime/paging.prefix_digest_chain), and the per-layer K/V rows of
every prompt page, leaf by leaf in the reference's flax tree order
(``models/gpt.page_leaves``). A decode-pool replica imports the buffer
straight into a ``DecodeLoopExecutor`` slot: the row starts decoding at
position ``len(tokens)`` with the prefill replica's pick as its last
token, as if it had prefilled locally.

The buffer is SELF-DESCRIBING — a fixed magic, a JSON header (shapes,
dtype names, tokens, digests), then the raw leaf bytes. Leaves are torch
tensors or numpy arrays; a bfloat16 leaf travels as its raw 2-byte words
under the dtype name ``"bfloat16"`` (the name numpy gives the reference's
leaves) and is read back with ``Tensor.view(torch.bfloat16)``, so no
bfloat16 numpy type is needed. Decoded leaves are CPU torch tensors.
:class:`KVTransport` is the byte-mover seam; :class:`LocalKVTransport`
is the one-box serialize/deserialize round trip.

Integrity is end-to-end, not transport-trusted: :meth:`KVHandoffBuffer
.verify` recomputes the digest chain from the tokens it carries and
refuses a buffer whose chain (or leaf sizes) don't match —
:class:`HandoffError`, a typed wire error the gateway maps like any
other dispatch failure.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, List, Tuple

import numpy as np
import torch

from tfk8s_tpu_torch.runtime.paging import prefix_digest_chain

#: buffer wire format identity (bump on layout change)
MAGIC = b"TFK8SKV1"


class HandoffError(Exception):
    """A KV handoff buffer that cannot be imported: corrupt framing,
    digest-chain mismatch, or a shape/version that doesn't match the
    importing replica. The gateway treats it like a failed dispatch hop:
    the buffer it still holds is re-sent to another decode replica
    under the bounded retry budget."""


@dataclass(eq=False)
class KVHandoffBuffer:
    """One request's warm prefill state, ready to cross the pool seam."""

    #: model identity (the serve checkpoint ref) — import refuses a
    #: buffer prefilled under different params; bit-identity would break
    version: str
    page_size: int
    #: full prompt (plain ints — hashable identically on both sides)
    tokens: List[int]
    #: the first OUTPUT token, picked at the last prompt position
    last_token: int
    #: decode-side generation budget (the first token counts against it)
    gen_budget: int
    #: chained digests of the FULL prompt pages (integrity + affinity)
    digests: List[str] = field(default_factory=list)
    #: per-layer K/V leaves in tree order, each
    #: ``[n_prompt_pages * page_size, heads, head_dim]`` — page ``k`` of
    #: the prompt is rows ``[k*ps, (k+1)*ps)`` of every leaf
    kv: List[Any] = field(default_factory=list)

    @property
    def n_pages(self) -> int:
        """Prompt pages carried (including a trailing partial page)."""
        return -(-len(self.tokens) // self.page_size)

    def verify(self) -> None:
        """End-to-end integrity: recompute the digest chain from the
        tokens the buffer carries and check every leaf covers exactly
        the prompt pages. Raises :class:`HandoffError` on any mismatch."""
        if self.page_size < 1 or not self.tokens:
            raise HandoffError(
                f"malformed buffer: page_size={self.page_size}, "
                f"{len(self.tokens)} token(s)"
            )
        want = prefix_digest_chain(
            self.tokens, self.page_size, len(self.tokens) // self.page_size
        )
        if list(self.digests) != want:
            raise HandoffError(
                "digest chain mismatch — buffer tokens and K/V disagree "
                f"({len(self.digests)} carried vs {len(want)} recomputed)"
            )
        rows = self.n_pages * self.page_size
        for i, leaf in enumerate(self.kv):
            if getattr(leaf, "shape", (None,))[0] != rows:
                raise HandoffError(
                    f"kv leaf {i} covers {getattr(leaf, 'shape', None)} — "
                    f"expected {rows} prompt rows"
                )

    @classmethod
    def prefix(cls, version: str, page_size: int, tokens: List[int],
               digests: List[str], kv: List[Any]) -> "KVHandoffBuffer":
        """A PREFIX-resident buffer (KV tier demotion/peer export,
        runtime/kvtier): page-aligned cached-prefix K/V with no
        generation state attached. ``gen_budget=0`` marks it
        non-admittable — ``submit_handoff`` refuses a zero budget, so a
        prefix buffer can only re-enter through the warm-insert path
        (cache adoption), never start a decode row by itself."""
        if len(tokens) % page_size != 0:
            raise HandoffError(
                f"prefix buffer must be page-aligned: {len(tokens)} "
                f"token(s) @ page_size {page_size}"
            )
        buf = cls(
            version=version, page_size=page_size, tokens=list(tokens),
            last_token=0, gen_budget=0, digests=list(digests), kv=kv,
        )
        buf.verify()
        return buf

    # -- wire form -----------------------------------------------------------

    def to_bytes(self) -> bytes:
        """MAGIC + u32 header length + JSON header + raw leaf bytes
        (C-order, header order). Self-describing: the importer needs
        nothing but these bytes."""
        leaves = [_leaf_to_wire(leaf) for leaf in self.kv]
        header = json.dumps({
            "version": self.version,
            "page_size": self.page_size,
            "tokens": [int(t) for t in self.tokens],
            "last_token": int(self.last_token),
            "gen_budget": int(self.gen_budget),
            "digests": list(self.digests),
            "leaves": [
                {"dtype": name, "shape": list(shape)}
                for name, shape, _raw in leaves
            ],
        }).encode()
        parts = [MAGIC, len(header).to_bytes(4, "big"), header]
        parts.extend(raw for _name, _shape, raw in leaves)
        return b"".join(parts)

    @classmethod
    def from_bytes(cls, data: bytes) -> "KVHandoffBuffer":
        """Decode and :meth:`verify` a serialized buffer."""
        if data[: len(MAGIC)] != MAGIC:
            raise HandoffError("not a KV handoff buffer (bad magic)")
        off = len(MAGIC)
        hlen = int.from_bytes(data[off:off + 4], "big")
        off += 4
        try:
            header = json.loads(data[off:off + hlen].decode())
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise HandoffError(f"corrupt buffer header: {e}") from e
        off += hlen
        kv = []
        for spec in header.get("leaves", []):
            name = spec["dtype"]
            try:
                dtype = np.dtype(np.int16 if name == "bfloat16" else name)
            except TypeError as e:
                raise HandoffError(f"unknown leaf dtype {name!r}") from e
            shape = tuple(spec["shape"])
            count = int(np.prod(shape)) if shape else 1
            end = off + count * dtype.itemsize
            if end > len(data):
                raise HandoffError("truncated buffer (leaf bytes missing)")
            leaf = torch.from_numpy(
                np.frombuffer(data[off:end], dtype=dtype).reshape(shape).copy()
            )
            kv.append(leaf.view(torch.bfloat16) if name == "bfloat16" else leaf)
            off = end
        buf = cls(
            version=header.get("version", ""),
            page_size=int(header.get("page_size", 0)),
            tokens=list(header.get("tokens", [])),
            last_token=int(header.get("last_token", 0)),
            gen_budget=int(header.get("gen_budget", 0)),
            digests=list(header.get("digests", [])),
            kv=kv,
        )
        buf.verify()
        return buf


def _leaf_to_wire(leaf: Any) -> Tuple[str, Tuple[int, ...], bytes]:
    """``(dtype name, shape, raw C-order bytes)`` of a tensor or array
    leaf; bfloat16 is named ``"bfloat16"`` and sent as its raw words."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return "bfloat16", tuple(t.shape), t.view(torch.int16).numpy().tobytes()
        leaf = t.numpy()
    a = np.ascontiguousarray(leaf)
    return str(a.dtype), tuple(a.shape), a.tobytes()


class KVTransport:
    """The pool-to-pool seam. ``transfer`` moves one buffer and returns
    ``(buffer_at_destination, bytes_moved)``. Implementations own HOW the
    bytes move; callers own the retry/rerouting policy around it."""

    def transfer(self, buf: KVHandoffBuffer) -> Tuple[KVHandoffBuffer, int]:
        raise NotImplementedError


class LocalKVTransport(KVTransport):
    """One-box transport: a full serialize/deserialize round trip (the
    memcpy seam). Deliberately NOT a pass-through of the live object —
    the round trip is what proves the buffer self-describes and what a
    real device-to-device transport replaces."""

    def transfer(self, buf: KVHandoffBuffer) -> Tuple[KVHandoffBuffer, int]:
        wire = buf.to_bytes()
        return KVHandoffBuffer.from_bytes(wire), len(wire)


__all__ = [
    "HandoffError",
    "KVHandoffBuffer",
    "KVTransport",
    "LocalKVTransport",
    "MAGIC",
]
