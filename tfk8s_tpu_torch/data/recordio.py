"""Record-file IO: TFRecord-framed shards with crc32c integrity.

Each worker of a training job reads its own division of the input
shards; this module is the shard container, a copy of the JAX package's
``data/recordio.py`` (files are byte-identical both ways). Two
interchangeable backends:

- **native** (default): the C++ core in ``native/recordio.cc`` via
  ctypes — single-pass index of a multi-GB shard and bulk CRC-verified
  reads with zero Python-per-record cost;
- **pure Python**: identical framing and CRC semantics, used when no
  toolchain is available (``TFK8S_PURE_PY=1`` forces it; the tests run
  both and assert byte-identical behavior).

Wire framing per record (TFRecord-compatible):
``uint64le length | uint32le masked_crc(length) | data |
uint32le masked_crc(data)`` with crc32c (Castagnoli) and the standard
mask ``rot_right15(crc) + 0xa282ead8``.
"""

from __future__ import annotations

import ctypes
import logging
import os
import struct
import threading
from typing import Iterator, List, Sequence, Tuple

from tfk8s_tpu_torch.data import _native

log = logging.getLogger("tfk8s.data.recordio")

_MASK_DELTA = 0xA282EAD8

_fallback_warned = False
_fallback_lock = threading.Lock()


def _warn_fallback_once() -> None:
    """One loud line the first time a shard is read without the native
    core: the pure-Python codec loops over bytes, an input-bandwidth
    outage rather than a detail. A deliberate opt-out (TFK8S_PURE_PY=1)
    stays quiet."""
    global _fallback_warned
    if _fallback_warned or os.environ.get("TFK8S_PURE_PY") == "1":
        return
    with _fallback_lock:
        if _fallback_warned:
            return
        _fallback_warned = True
        log.warning(
            "recordio: native reader unavailable — pure-Python codec in "
            "use (about 120x slower). Install g++ (or see the build "
            "warning above) to restore input bandwidth."
        )

# -- crc32c (pure-Python fallback; the native lib serves the fast path) --

_TABLE: List[int] = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (0x82F63B78 ^ (_c >> 1)) if (_c & 1) else (_c >> 1)
    _TABLE.append(_c)


def crc32c(data: bytes) -> int:
    lib = _native.load()
    if lib is not None:
        return int(lib.rio_crc32c(data, len(data)))
    crc = 0xFFFFFFFF
    for b in data:
        crc = _TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + _MASK_DELTA) & 0xFFFFFFFF


class RecordIOError(IOError):
    """Framing or checksum violation in a record file."""


class RecordWriter:
    """Append-only writer. Buffers frames and flushes through the native
    bulk writer when available (one fwrite loop in C), else writes the
    same bytes from Python. Context-manager; ``write`` takes raw bytes —
    pair with ``example.encode`` for array dicts."""

    def __init__(self, path: str, flush_every: int = 256):
        self.path = path
        self._pending: List[bytes] = []
        self._flush_every = flush_every
        self._closed = False
        # truncate: a writer owns its shard (matches TF writer semantics)
        open(path, "wb").close()

    def write(self, data: bytes) -> None:
        if self._closed:
            raise ValueError("writer is closed")
        self._pending.append(bytes(data))
        if len(self._pending) >= self._flush_every:
            self.flush()

    def flush(self) -> None:
        if not self._pending:
            return
        recs = self._pending
        # retry safety: on ANY failure, roll the file back to its
        # pre-flush size AND keep the records buffered — a retried
        # flush() then neither drops records nor appends duplicates of a
        # partial write
        pre_size = os.path.getsize(self.path)
        try:
            lib = _native.load()
            if lib is not None:
                blob = b"".join(recs)
                lens = (ctypes.c_int64 * len(recs))(*[len(r) for r in recs])
                buf = (ctypes.c_uint8 * len(blob)).from_buffer_copy(blob)
                rc = lib.rio_write(self.path.encode(), len(recs), buf, lens)
                if rc != 0:
                    raise RecordIOError(
                        f"native write failed rc={rc}: {self.path}"
                    )
            else:
                with open(self.path, "ab") as f:
                    for r in recs:
                        hdr = struct.pack("<Q", len(r))
                        f.write(hdr)
                        f.write(struct.pack("<I", masked_crc32c(hdr)))
                        f.write(r)
                        f.write(struct.pack("<I", masked_crc32c(r)))
        except BaseException:
            try:
                with open(self.path, "rb+") as f:
                    f.truncate(pre_size)
            except OSError:
                pass  # the original error is the one to surface
            raise
        self._pending = []

    def close(self) -> None:
        self.flush()
        self._closed = True

    def __enter__(self) -> "RecordWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _index_py(path: str) -> Tuple[List[int], List[int]]:
    offsets, lengths = [], []
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        while True:
            hdr = f.read(12)
            if not hdr:
                break
            if len(hdr) != 12:
                raise RecordIOError(f"truncated frame header: {path}")
            (length,) = struct.unpack("<Q", hdr[:8])
            (want,) = struct.unpack("<I", hdr[8:])
            if masked_crc32c(hdr[:8]) != want:
                raise RecordIOError(
                    f"header crc mismatch at record {len(offsets)}: {path}"
                )
            off = f.tell()
            if off + length + 4 > size:
                raise RecordIOError(
                    f"truncated record {len(offsets)} body: {path}"
                )
            offsets.append(off)
            lengths.append(length)
            f.seek(length + 4, os.SEEK_CUR)
    return offsets, lengths


def _index_native(lib, path: str) -> Tuple[List[int], List[int]]:
    po = ctypes.POINTER(ctypes.c_int64)()
    pl = ctypes.POINTER(ctypes.c_int64)()
    n = lib.rio_index(path.encode(), ctypes.byref(po), ctypes.byref(pl))
    if n < 0:
        reason = {-1: "open failed", -2: "truncated frame",
                  -3: "header crc mismatch",
                  -5: "out of memory growing the index"}.get(n, f"rc={n}")
        raise RecordIOError(f"index failed ({reason}): {path}")
    try:
        return list(po[:n]), list(pl[:n])
    finally:
        lib.rio_free(po)
        lib.rio_free(pl)


class RecordFile:
    """An indexed record shard with random access by record number.
    Indexing verifies every header CRC up front; reads verify data CRCs
    (``verify=False`` to skip on trusted storage)."""

    def __init__(self, path: str):
        self.path = path
        lib = _native.load()
        if lib is not None:
            self.offsets, self.lengths = _index_native(lib, path)
        else:
            _warn_fallback_once()
            self.offsets, self.lengths = _index_py(path)

    def __len__(self) -> int:
        return len(self.offsets)

    def read(self, indices: Sequence[int], verify: bool = True) -> List[bytes]:
        offs = [self.offsets[i] for i in indices]
        lens = [self.lengths[i] for i in indices]
        lib = _native.load()
        if lib is not None:
            total = sum(lens)
            out = (ctypes.c_uint8 * total)()
            bad = ctypes.c_int64(-1)
            rc = lib.rio_read(
                self.path.encode(), len(offs),
                (ctypes.c_int64 * len(offs))(*offs),
                (ctypes.c_int64 * len(lens))(*lens),
                out, 1 if verify else 0, ctypes.byref(bad),
            )
            if rc == -4:
                raise RecordIOError(
                    f"data crc mismatch at record {indices[bad.value]}: "
                    f"{self.path}"
                )
            if rc != 0:
                raise RecordIOError(f"native read failed rc={rc}: {self.path}")
            # slice through a memoryview: one copy per record, not an
            # extra whole-blob copy first (bulk reads can be GBs)
            view = memoryview(out)
            res, pos = [], 0
            for ln in lens:
                res.append(bytes(view[pos : pos + ln]))
                pos += ln
            return res
        res = []
        with open(self.path, "rb") as f:
            for idx, off, ln in zip(indices, offs, lens):
                f.seek(off)
                data = f.read(ln)
                tail = f.read(4)
                if len(data) != ln or len(tail) != 4:
                    raise RecordIOError(f"short read at record {idx}: {self.path}")
                if verify and struct.unpack("<I", tail)[0] != masked_crc32c(data):
                    raise RecordIOError(
                        f"data crc mismatch at record {idx}: {self.path}"
                    )
                res.append(data)
        return res

    def __iter__(self) -> Iterator[bytes]:
        for i in range(len(self)):
            yield self.read([i])[0]


def shard_files(
    files: Sequence[str], shard_index: int, num_shards: int
) -> List[str]:
    """Deterministic per-host file assignment: round-robin over the
    SORTED file list (every host computes the same division from the
    same inputs — no coordination). Shards are disjoint and cover the
    list. Fails loudly when a host would get zero files: silent empty
    input starves that host's data-parallel shard."""
    if not 0 <= shard_index < num_shards:
        raise ValueError(f"shard_index {shard_index} not in [0, {num_shards})")
    ordered = sorted(files)
    if len(ordered) < num_shards:
        raise ValueError(
            f"{len(ordered)} record files cannot feed {num_shards} hosts — "
            "write at least one file per host"
        )
    return ordered[shard_index::num_shards]
