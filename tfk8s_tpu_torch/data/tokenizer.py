"""Byte-level BPE tokenizer (GPT-2 style), the port's own copy of the JAX
package's ``data/tokenizer.py``: the same token ids and the same saved
files, byte for byte.

- Byte-level: text is mapped through the GPT-2 byte-to-unicode table (a
  format constant: the 256 byte values relabelled onto printable code
  points), so any input round-trips losslessly, with no unknown token.
- Trainable: :func:`train_bpe` learns a merge list from a corpus
  (pair-frequency BPE over pre-tokenized words; ties break
  lexicographically, so training is deterministic).
- Hugging Face layout: ``save``/``load`` write and read ``vocab.json`` and
  ``merges.txt`` as HF tokenizers do, plus ``special_tokens.json``, the
  specials manifest (written even when empty), so a GPT-2 vocabulary in
  the same layout loads unchanged.

Pre-tokenization approximates GPT-2's regex with the standard library's
``re`` (the original's ``\\p{L}``/``\\p{N}`` classes need the third-party
``regex`` module): contractions, letter runs, digit runs, punctuation
runs and space-prefixed words.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Iterable, List, Sequence, Tuple

# stdlib-re approximation of the GPT-2 split pattern
_PRETOKEN = re.compile(
    r"'s|'t|'re|'ve|'m|'ll|'d"
    r"| ?[A-Za-zÀ-ɏ]+"
    r"| ?[0-9]+"
    r"| ?[^\sA-Za-z0-9À-ɏ]+"
    r"|\s+(?!\S)|\s+"
)


def bytes_to_unicode() -> Dict[int, str]:
    """The GPT-2 byte→printable-unicode relabelling (format constant):
    printable ASCII and two Latin-1 ranges map to themselves; the
    remaining 68 byte values map to 256+n."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


_BYTE_ENC = bytes_to_unicode()
_BYTE_DEC = {v: k for k, v in _BYTE_ENC.items()}


def _to_byte_chars(text: str) -> str:
    return "".join(_BYTE_ENC[b] for b in text.encode("utf-8"))


class VocabMismatchError(KeyError):
    """A merge-produced piece has no vocab id — vocab.json and
    merges.txt are from different tokenizers. Subclasses KeyError so
    pre-existing callers catching the bare KeyError keep working."""

    def __str__(self) -> str:  # KeyError repr()s its arg; keep the prose
        return self.args[0] if self.args else ""


def _apply_merge(symbols: Sequence[str], pair: Tuple[str, str]) -> List[str]:
    """One left-to-right pass replacing adjacent ``pair`` occurrences with
    their concatenation — the ONE merge-application used by both encoding
    (_bpe) and training (train_bpe), so their semantics cannot drift."""
    merged: List[str] = []
    i = 0
    while i < len(symbols):
        if i < len(symbols) - 1 and (symbols[i], symbols[i + 1]) == pair:
            merged.append(symbols[i] + symbols[i + 1])
            i += 2
        else:
            merged.append(symbols[i])
            i += 1
    return merged


class BPETokenizer:
    """Encode/decode with a (vocab, merges) pair. ``vocab`` maps token
    string (in byte-char space) → id; ``merges`` is the ordered merge
    list, earlier = higher priority."""

    def __init__(
        self,
        vocab: Dict[str, int],
        merges: Sequence[Tuple[str, str]],
        specials: Sequence[str] = (),
    ):
        self.vocab = dict(vocab)
        self.inv_vocab = {i: t for t, i in self.vocab.items()}
        self.ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.merges = [tuple(m) for m in merges]
        self.specials = list(specials)
        # longest-first alternation so overlapping specials resolve to
        # the longest match (HF AddedToken behavior); None when there
        # are no specials to split out
        self._special_re = (
            re.compile(
                "|".join(
                    re.escape(s)
                    for s in sorted(self.specials, key=len, reverse=True)
                )
            )
            if self.specials
            else None
        )
        self._cache: Dict[str, List[str]] = {}

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def _bpe(self, word: str) -> List[str]:
        if word in self._cache:
            return self._cache[word]
        parts = list(word)
        while len(parts) > 1:
            pairs = {(parts[i], parts[i + 1]) for i in range(len(parts) - 1)}
            best = min(
                pairs, key=lambda p: self.ranks.get(p, float("inf"))
            )
            if best not in self.ranks:
                break
            parts = _apply_merge(parts, best)
        if len(self._cache) < 65536:  # bound the per-process cache
            self._cache[word] = parts
        return parts

    def _lookup(self, piece: str) -> int:
        try:
            return self.vocab[piece]
        except KeyError:
            raise VocabMismatchError(
                f"BPE piece {piece!r} is missing from the vocab "
                f"({len(self.vocab)} entries) although the merge list "
                "produced it — vocab.json and merges.txt are almost "
                "certainly from DIFFERENT tokenizers; re-export the pair "
                "together"
            ) from None

    def encode(self, text: str) -> List[int]:
        """Text -> ids. Special tokens appearing IN the text (e.g.
        ``<|endoftext|>`` as a document separator) encode atomically to
        their reserved ids instead of being BPE-split — matching HF
        added-token behavior, so callers other than corpus.py (which
        appends the EOS id directly) get the same stream."""
        ids: List[int] = []
        for chunk, special in self._split_specials(text):
            if special:
                ids.append(self._lookup(chunk))
                continue
            for tok in _PRETOKEN.findall(chunk):
                for piece in self._bpe(_to_byte_chars(tok)):
                    ids.append(self._lookup(piece))
        return ids

    def _split_specials(self, text: str) -> List[Tuple[str, bool]]:
        """Split ``text`` into (chunk, is_special) runs; specials match
        longest-first and never cross BPE pre-tokenization."""
        if self._special_re is None:
            return [(text, False)]
        out: List[Tuple[str, bool]] = []
        pos = 0
        for m in self._special_re.finditer(text):
            if m.start() > pos:
                out.append((text[pos : m.start()], False))
            out.append((m.group(), True))
            pos = m.end()
        if pos < len(text):
            out.append((text[pos:], False))
        return out

    def decode(self, ids: Iterable[int]) -> str:
        chars = "".join(self.inv_vocab[int(i)] for i in ids)
        data = bytes(_BYTE_DEC[c] for c in chars)
        return data.decode("utf-8", errors="replace")

    # -- HF-compatible persistence -----------------------------------------

    def save(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        with open(os.path.join(directory, "vocab.json"), "w") as f:
            json.dump(self.vocab, f, ensure_ascii=False)
        with open(os.path.join(directory, "merges.txt"), "w") as f:
            f.write("#version: 0.2\n")
            for a, b in self.merges:
                f.write(f"{a} {b}\n")
        # The HF layout has no positional-specials manifest; persist ours
        # so ARBITRARY special shapes (e.g. "[PAD]") survive a save/load
        # round trip with atomic encoding intact. Written even when
        # EMPTY: an explicit [] tells load() "no specials" — otherwise
        # its <|...|>-shape fallback could mint a phantom special out of
        # a vocab piece that merely LOOKS like one (a corpus containing
        # the literal text), silently changing the reloaded id stream.
        with open(os.path.join(directory, "special_tokens.json"), "w") as f:
            json.dump(self.specials, f, ensure_ascii=False)

    @classmethod
    def load(cls, directory: str) -> "BPETokenizer":
        with open(os.path.join(directory, "vocab.json")) as f:
            vocab = json.load(f)
        merges: List[Tuple[str, str]] = []
        with open(os.path.join(directory, "merges.txt")) as f:
            for line in f:
                line = line.rstrip("\n")
                if not line or line.startswith("#"):
                    continue
                a, _, b = line.partition(" ")
                merges.append((a, b))
        # specials: the save()-written manifest when present (possibly
        # an explicit empty list); else recover reserved tokens by their
        # ``<|...|>`` shape (plain HF directories / pre-manifest saves)
        # so a reloaded tokenizer still encodes them atomically
        manifest = os.path.join(directory, "special_tokens.json")
        if os.path.exists(manifest):
            with open(manifest) as f:
                specials = json.load(f)
        else:
            specials = [
                t for t in vocab if t.startswith("<|") and t.endswith("|>")
            ]
        return cls(vocab, merges, specials=specials)


def train_bpe(
    texts: Iterable[str],
    vocab_size: int,
    specials: Sequence[str] = (),
) -> BPETokenizer:
    """Classic BPE training: count pre-tokenized words, then greedily
    merge the most frequent adjacent symbol pair until ``vocab_size`` is
    reached (256 byte-level symbols + specials + merges). Deterministic:
    frequency ties break lexicographically."""
    base = [_BYTE_ENC[b] for b in range(256)]
    n_reserved = len(base) + len(specials)
    if vocab_size < n_reserved:
        raise ValueError(
            f"vocab_size {vocab_size} < {n_reserved} "
            "(256 byte symbols + specials)"
        )
    words: Dict[Tuple[str, ...], int] = {}
    for text in texts:
        for tok in _PRETOKEN.findall(text):
            key = tuple(_to_byte_chars(tok))
            words[key] = words.get(key, 0) + 1

    merges: List[Tuple[str, str]] = []
    vocab_tokens = set(base)
    while len(vocab_tokens) + len(specials) < vocab_size:
        pair_counts: Dict[Tuple[str, str], int] = {}
        for word, cnt in words.items():
            for i in range(len(word) - 1):
                p = (word[i], word[i + 1])
                pair_counts[p] = pair_counts.get(p, 0) + cnt
        if not pair_counts:
            break
        best = max(pair_counts, key=lambda p: (pair_counts[p], p))
        merges.append(best)
        vocab_tokens.add(best[0] + best[1])
        new_words: Dict[Tuple[str, ...], int] = {}
        for word, cnt in words.items():
            key = tuple(_apply_merge(word, best))
            new_words[key] = new_words.get(key, 0) + cnt
        words = new_words

    # id order: specials first (stable ids for PAD/EOS regardless of
    # corpus), then base bytes, then merges in creation order
    vocab: Dict[str, int] = {}
    for s in specials:
        vocab[s] = len(vocab)
    for t in base:
        vocab[t] = len(vocab)
    for a, b in merges:
        tok = a + b
        if tok not in vocab:
            vocab[tok] = len(vocab)
    return BPETokenizer(vocab, merges, specials=specials)
