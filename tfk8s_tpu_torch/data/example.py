"""Binary codec for training examples: a ``{name: np.ndarray}`` dict to
one record's bytes and back. The framework-native equivalent of the
reference ecosystem's tf.Example payload inside TFRecord frames — but
array-shaped (dtype + shape preserved exactly), so decoded batches stack
straight into ``TrainTask`` host batches with no feature-spec parsing.

Layout (all little-endian):
``magic 'TFX1' | u16 n_entries`` then per entry
``u16 keylen | key utf8 | u8 dtypelen | dtype str | u8 ndim |
i64 shape[ndim] | u64 nbytes | raw array bytes (C order)``.
"""

from __future__ import annotations

import struct
from typing import Dict

import numpy as np

_MAGIC = b"TFX1"


class ExampleDecodeError(ValueError):
    pass


def encode(example: Dict[str, np.ndarray]) -> bytes:
    parts = [_MAGIC, struct.pack("<H", len(example))]
    for key in sorted(example):
        # NOT ascontiguousarray: that promotes 0-d arrays to 1-d, which
        # would silently change a scalar label's decoded shape
        arr = np.asarray(example[key], order="C")
        kb = key.encode()
        db = arr.dtype.str.encode()  # e.g. '<i4' — endian + kind + size
        raw = arr.tobytes()
        parts.append(struct.pack("<H", len(kb)))
        parts.append(kb)
        parts.append(struct.pack("<B", len(db)))
        parts.append(db)
        parts.append(struct.pack("<B", arr.ndim))
        parts.append(struct.pack(f"<{arr.ndim}q", *arr.shape))
        parts.append(struct.pack("<Q", len(raw)))
        parts.append(raw)
    return b"".join(parts)


def decode(data: bytes) -> Dict[str, np.ndarray]:
    if data[:4] != _MAGIC:
        raise ExampleDecodeError(f"bad magic {data[:4]!r}")
    (n,) = struct.unpack_from("<H", data, 4)
    pos = 6
    out: Dict[str, np.ndarray] = {}
    try:
        for _ in range(n):
            (klen,) = struct.unpack_from("<H", data, pos)
            pos += 2
            key = data[pos : pos + klen].decode()
            pos += klen
            (dlen,) = struct.unpack_from("<B", data, pos)
            pos += 1
            dtype = np.dtype(data[pos : pos + dlen].decode())
            pos += dlen
            (ndim,) = struct.unpack_from("<B", data, pos)
            pos += 1
            shape = struct.unpack_from(f"<{ndim}q", data, pos)
            pos += 8 * ndim
            (nbytes,) = struct.unpack_from("<Q", data, pos)
            pos += 8
            raw = data[pos : pos + nbytes]
            if len(raw) != nbytes:
                raise ExampleDecodeError("truncated array payload")
            pos += nbytes
            out[key] = np.frombuffer(raw, dtype).reshape(shape).copy()
    except struct.error as exc:
        raise ExampleDecodeError(f"truncated example: {exc}") from exc
    except (TypeError, ValueError) as exc:
        # garbled dtype strings (np.dtype -> TypeError) and shape/nbytes
        # mismatches (reshape -> ValueError) are corruption too — callers
        # catch the module's typed error, not numpy's
        if isinstance(exc, ExampleDecodeError):
            raise
        raise ExampleDecodeError(f"corrupt example metadata: {exc}") from exc
    return out
