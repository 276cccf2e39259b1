"""The image Example schema: one classification sample per record, a
copy of the JAX package's ``data/images/schema.py`` (records and shards
byte for byte the same).

Rides the ``data/example.py`` array codec (so image shards share the
recordio framing, CRC discipline, native bulk reader, and per-host
sharding every other record type gets) instead of inventing a second
container. The compressed image travels as a uint8 byte array — decode
happens in the input pipeline (``pipeline.ImageDataset``), never at
pack time, so shards stay at JPEG size (~25x smaller than decoded
float32) and the decode cost lands on the training hosts where it
parallelizes.

Keys (the wire names mirror tf.Example's ``image/*`` convention, so a
reader coming from TensorFlow finds the same fields):

- ``image/encoded``  uint8[n]  — the compressed JPEG/PNG bytes
- ``image/format``   uint8[m]  — ascii format tag (``jpeg`` | ``png``)
- ``image/label``    int32     — class index
- ``image/height|width|channels`` int32 — decoded geometry, parsed from
  the header at pack time (-1 when unknown); readers can size buffers
  and reject corrupt records before paying a full decode
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from tfk8s_tpu_torch.data import example as example_codec
from tfk8s_tpu_torch.data.recordio import RecordWriter

KEY_ENCODED = "image/encoded"
KEY_FORMAT = "image/format"
KEY_LABEL = "image/label"
KEY_HEIGHT = "image/height"
KEY_WIDTH = "image/width"
KEY_CHANNELS = "image/channels"

_JPEG_MAGIC = b"\xff\xd8\xff"
_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


class ImageSchemaError(ValueError):
    """A record that is not a well-formed image Example."""


@dataclasses.dataclass
class ImageExample:
    """One decoded-from-the-wire image sample (still compressed)."""

    encoded: bytes
    label: int
    format: str = ""
    height: int = -1
    width: int = -1
    channels: int = -1


def sniff_format(encoded: bytes) -> str:
    """Container format from magic bytes ('' when unrecognized)."""
    if encoded[:3] == _JPEG_MAGIC:
        return "jpeg"
    if encoded[:8] == _PNG_MAGIC:
        return "png"
    return ""


def encode_image_example(
    encoded: bytes,
    label: int,
    fmt: Optional[str] = None,
    shape: Optional[Tuple[int, int, int]] = None,
) -> bytes:
    """One image sample -> record bytes (pair with ``RecordWriter``).
    ``fmt=None`` sniffs the container from magic bytes; unrecognized
    bytes are rejected — a shard of garbage must fail at PACK time, not
    as a decode error on step 40k of a training run."""
    if fmt is None:
        fmt = sniff_format(encoded)
        if not fmt:
            raise ImageSchemaError(
                f"unrecognized image container (first bytes "
                f"{bytes(encoded[:4])!r}); pass fmt= explicitly for "
                "formats without magic-byte sniffing"
            )
    h, w, c = shape if shape is not None else (-1, -1, -1)
    return example_codec.encode(
        {
            KEY_ENCODED: np.frombuffer(bytes(encoded), np.uint8),
            KEY_FORMAT: np.frombuffer(fmt.encode(), np.uint8),
            KEY_LABEL: np.int32(label),
            KEY_HEIGHT: np.int32(h),
            KEY_WIDTH: np.int32(w),
            KEY_CHANNELS: np.int32(c),
        }
    )


def is_image_example(example: Dict[str, np.ndarray]) -> bool:
    return KEY_ENCODED in example and KEY_LABEL in example


def decode_image_example(data: bytes) -> ImageExample:
    """Record bytes -> :class:`ImageExample` (compressed bytes + label +
    metadata). Raises :class:`ImageSchemaError` on any record that is
    not an image Example — the pipeline turns a wrong-schema shard into
    one clear message instead of a shape error deep inside the model."""
    try:
        ex = example_codec.decode(data)
    except example_codec.ExampleDecodeError as exc:
        raise ImageSchemaError(f"corrupt record: {exc}") from exc
    if not is_image_example(ex):
        raise ImageSchemaError(
            f"record keys {sorted(ex.keys())} are not the image schema "
            f"({KEY_ENCODED!r} + {KEY_LABEL!r}); was this shard packed "
            "by data/corpus.py instead of data/images/pack.py?"
        )

    def scalar(key: str, default: int = -1) -> int:
        if key not in ex:
            return default
        return int(np.asarray(ex[key]).reshape(()))

    return ImageExample(
        encoded=ex[KEY_ENCODED].tobytes(),
        label=scalar(KEY_LABEL),
        format=ex.get(KEY_FORMAT, np.zeros(0, np.uint8)).tobytes().decode(
            "ascii", errors="replace"
        ),
        height=scalar(KEY_HEIGHT),
        width=scalar(KEY_WIDTH),
        channels=scalar(KEY_CHANNELS),
    )


def write_image_shards(
    records: Iterable[bytes],
    out_dir: str,
    num_shards: int,
    prefix: str = "images",
) -> List[str]:
    """Round-robin encoded records across ``num_shards`` recordio files
    (``{prefix}-00000.rio`` ...). Writes temp names, renaming into place
    only after every record landed — a failed packing must not leave
    partial shards behind for a later run's glob to feed a host. Write
    >= one shard per training host to keep the 1/hosts file-IO property
    (``data/recordio.shard_files``)."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    os.makedirs(out_dir, exist_ok=True)
    paths = [
        os.path.join(out_dir, f"{prefix}-{i:05d}.rio")
        for i in range(num_shards)
    ]
    tmp = [p + ".tmp" for p in paths]
    writers = [RecordWriter(p) for p in tmp]
    n = 0
    try:
        for n, rec in enumerate(records, start=1):
            writers[(n - 1) % num_shards].write(rec)
        for w in writers:
            w.close()
        if n < num_shards:
            raise ValueError(
                f"only {n} images for {num_shards} shards — every shard "
                "must hold at least one record (fewer shards, more data)"
            )
        for t, p in zip(tmp, paths):
            os.replace(t, p)
    finally:
        for w in writers:
            # a records-iterator failure must not leak open shard
            # handles (same class of leak corpus._read_texts had);
            # close() flushes, which is fine — the tmp files die next
            try:
                w.close()
            except Exception:  # noqa: BLE001 — cleanup must reach remove
                pass
        for t in tmp:
            if os.path.exists(t):
                os.remove(t)
    return paths
