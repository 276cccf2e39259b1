"""Text corpus to tokenized record shards, the port's own copy of the JAX
package's ``data/corpus.py``: train or load a BPE tokenizer, pack the
token stream into fixed-length rows, and write record shards that the
trainer's files input mode reads (``TFK8S_INPUT_FILES``). The shards are
the JAX package's byte for byte.

CLI::

    python -m tfk8s_tpu_torch.data.corpus \
        --input 'corpus/*.txt' --out-dir shards --seq-len 128 \
        --vocab-size 2048 --num-shards 4 --tokenizer-dir tok

It trains a byte-level BPE tokenizer on the corpus when
``--tokenizer-dir`` is empty or absent, else loads it (the HF
``vocab.json``/``merges.txt`` layout: a GPT-2 vocabulary works
unchanged). Documents are separated by EOS; the stream is cut into
``seq_len``-token rows (the causal LM's shift happens inside the task),
the remainder dropped; rows go round-robin to ``--num-shards`` files (at
least one file per training host keeps each host's reads to its own
files, ``data/recordio.shard_files``)."""

from __future__ import annotations

import argparse
import glob
import os
from typing import Iterator, List

import numpy as np

from tfk8s_tpu_torch.data.example import encode
from tfk8s_tpu_torch.data.recordio import RecordWriter
from tfk8s_tpu_torch.data.tokenizer import BPETokenizer, train_bpe

PAD, EOS = "<|pad|>", "<|endoftext|>"


def _read_texts(patterns: List[str]) -> List[str]:
    paths = sorted({p for pat in patterns for p in glob.glob(pat)})
    if not paths:
        raise FileNotFoundError(f"no files match {patterns}")
    texts = []
    for p in paths:
        with open(p, encoding="utf-8") as f:
            texts.append(f.read())
    return texts


def get_tokenizer(
    texts: List[str], tokenizer_dir: str, vocab_size: int
) -> BPETokenizer:
    if tokenizer_dir and os.path.exists(
        os.path.join(tokenizer_dir, "vocab.json")
    ):
        return BPETokenizer.load(tokenizer_dir)
    tok = train_bpe(texts, vocab_size=vocab_size, specials=[PAD, EOS])
    if tokenizer_dir:
        tok.save(tokenizer_dir)
    return tok


def pack_rows(
    tok: BPETokenizer, texts: List[str], seq_len: int
) -> Iterator[np.ndarray]:
    """One flat token stream, documents separated by EOS, chunked into
    ``seq_len`` rows (remainder dropped — same convention as GPT-2
    pretraining packing)."""
    eos = tok.vocab.get(EOS)
    stream: List[int] = []
    for text in texts:
        stream.extend(tok.encode(text))
        if eos is not None:
            stream.append(eos)
    for lo in range(0, len(stream) - seq_len + 1, seq_len):
        yield np.asarray(stream[lo : lo + seq_len], np.int32)


def write_shards(
    rows: Iterator[np.ndarray], out_dir: str, num_shards: int
) -> List[str]:
    """Writes to temp names, renaming into ``part-*.rio`` only on
    success — a failed/invalid packing must not leave partial shards
    behind that a later run's ``part-*.rio`` glob would feed a host."""
    os.makedirs(out_dir, exist_ok=True)
    paths = [
        os.path.join(out_dir, f"part-{i:04d}.rio") for i in range(num_shards)
    ]
    tmps = [p + ".tmp" for p in paths]
    writers = [RecordWriter(p) for p in tmps]
    n = 0
    ok = False
    try:
        for row in rows:
            writers[n % num_shards].write(encode({"input": row}))
            n += 1
        if n < num_shards:
            raise ValueError(
                f"corpus packed into only {n} rows for {num_shards} shards — "
                "use fewer shards, a shorter seq_len, or more text"
            )
        ok = True
    finally:
        for w in writers:
            w.close()
        if ok:
            for t, p in zip(tmps, paths):
                os.replace(t, p)
        else:
            for t in tmps:
                try:
                    os.unlink(t)
                except OSError:
                    pass
    return paths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--input", nargs="+", required=True,
                    help="text file paths/globs")
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--vocab-size", type=int, default=2048)
    ap.add_argument("--num-shards", type=int, default=4)
    ap.add_argument("--tokenizer-dir", default="",
                    help="load (if populated) or save the tokenizer here")
    args = ap.parse_args(argv)

    texts = _read_texts(args.input)
    tok = get_tokenizer(texts, args.tokenizer_dir, args.vocab_size)
    paths = write_shards(
        pack_rows(tok, texts, args.seq_len), args.out_dir, args.num_shards
    )
    total = sum(os.path.getsize(p) for p in paths)
    print(
        f"tokenized {len(texts)} file(s) with vocab {tok.vocab_size} -> "
        f"{len(paths)} shard(s), {total / 1e6:.2f} MB at {args.out_dir}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
