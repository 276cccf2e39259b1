"""Malformed-input smoke corpus for the port's two native cores.

The JAX package's ``tools/sanitize_smoke.py`` corpus, driven through the
port's binders: the record-IO core (``data/native/recordio.cc``, through
``data.recordio.RecordFile``) and the image-decode core
(``data/native/imagecore.cc``, through ``data.images._native_decode``).
Run it inside a sanitizer environment::

    TFK8S_NATIVE_SANITIZE=ubsan python -m tfk8s_tpu_torch.tools.sanitize_smoke
    TFK8S_NATIVE_SANITIZE=asan LD_PRELOAD=$(gcc -print-file-name=libasan.so) \\
        ASAN_OPTIONS=detect_leaks=0 python -m tfk8s_tpu_torch.tools.sanitize_smoke

The corpus is generated, not checked in, and deterministic: a valid record
shard and JPEG, then truncations sweeping the file, bit flips sweeping its
head and tail, a lying length field, a lying geometry stamp, and garbage.
The contract: malformed bytes are refused typed (``RecordIOError``, None,
False), valid ones accepted, and no sanitizer report; asan and ubsan turn
an out-of-bounds parse into an abort with the sanitizer's own trace.

Exit 0: the corpus passed. Exit 1: a core accepted what it must refuse or
refused what it must accept. Exit 2: no sanitizer was asked for (a plain
run proves nothing about memory safety; ``tests/test_torch_lint.py`` runs
the corpus against the plainly built cores in process). A sanitizer's
abort exits with the sanitizer's status.
"""

from __future__ import annotations

import argparse
import os
import struct
import sys
import tempfile
import traceback
from typing import Callable, List


def _mutations(valid: bytes) -> List[bytes]:
    """Truncations sweeping the whole file, single-bit flips sweeping its
    head and tail, and garbage."""
    out: List[bytes] = []
    step = max(1, len(valid) // 64)
    out.extend(valid[:n] for n in range(0, len(valid), step))
    for pos in list(range(0, min(64, len(valid)))) + list(
            range(max(0, len(valid) - 16), len(valid))):
        flipped = bytearray(valid)
        flipped[pos] ^= 0x40
        out.append(bytes(flipped))
    out.append(b"")
    out.append(b"\xff" * 257)
    out.append(bytes(range(256)) * 5)
    return out


def smoke_recordio(tmp: str) -> int:
    """The record core's corpus; returns the failures (0 when the core is
    not built: it prints why)."""
    from tfk8s_tpu_torch.data import _native
    from tfk8s_tpu_torch.data.recordio import RecordFile, RecordIOError, RecordWriter

    if _native.load() is None:
        print("recordio: native core not loaded; nothing to smoke")
        return 0

    shard = os.path.join(tmp, "valid.rio")
    want = [bytes([i]) * (i * 7 + 1) for i in range(32)]
    with RecordWriter(shard) as w:
        for record in want:
            w.write(record)
    with open(shard, "rb") as f:
        valid = f.read()

    corpus = _mutations(valid)
    # a lying length field: a record body far past the end of the file
    lying = bytearray(valid)
    lying[0:8] = struct.pack("<Q", 2**40)
    corpus.append(bytes(lying))

    failures = 0
    path = os.path.join(tmp, "case.rio")
    for i, blob in enumerate(corpus):
        with open(path, "wb") as f:
            f.write(blob)
        try:
            rf = RecordFile(path)
            rf.read(range(len(rf)), verify=True)
        except RecordIOError:
            pass  # the typed refusal: the contract
        except Exception:  # noqa: BLE001 — any other class fails the case
            print(f"recordio case {i} ({len(blob)} bytes): wrong error type")
            traceback.print_exc()
            failures += 1
    rf = RecordFile(shard)
    if rf.read(range(len(rf))) != want:
        print("recordio: the valid shard did not round-trip")
        failures += 1
    print(f"recordio: {len(corpus)} corpus cases, {failures} failure(s)")
    return failures


def smoke_imagecore(tmp: str) -> int:
    """The image core's corpus; returns the failures (0 when the core is
    not built or PIL is missing to write the JPEG: it prints why)."""
    import numpy as np

    from tfk8s_tpu_torch.data.images import _native_decode as nd

    if nd.load() is None:
        print("imagecore: native core not loaded; nothing to smoke")
        return 0
    try:
        from PIL import Image
    except ImportError:
        print("imagecore: PIL unavailable; cannot write the corpus")
        return 0

    # a deterministic gradient frame as real JPEG bytes
    h, w = 97, 131
    y, x = np.mgrid[0:h, 0:w]
    frame = np.stack([(x * 2) % 256, (y * 3) % 256, (x + y) % 256], axis=-1).astype(np.uint8)
    jpg_path = os.path.join(tmp, "valid.jpg")
    Image.fromarray(frame).save(jpg_path, "JPEG", quality=90)
    with open(jpg_path, "rb") as f:
        valid = f.read()

    scale = np.ones(3, np.float32)
    bias = np.zeros(3, np.float32)

    def drive(blob: bytes, stamp=(h, w)) -> None:
        nd.jpeg_info(blob)
        for s in (8, 4, 3, 1):
            nd.decode_jpeg_scaled(blob, s)
        dst = np.empty((32, 32, 3), np.float32)
        nd.decode_rrc_into(blob, (5, 5, 48, 48), 32, True, 8, scale, bias, dst, stamp)

    failures = 0
    corpus = _mutations(valid)
    for i, blob in enumerate(corpus):
        try:
            drive(blob)
        except Exception:  # noqa: BLE001 — the binder refuses by return value
            print(f"imagecore case {i} ({len(blob)} bytes): unexpected raise")
            traceback.print_exc()
            failures += 1
    # the lying geometry stamp: the header says 97x131, the caller claims a
    # tiny frame (undersized scratch) and a huge one; both must be refused
    # or decoded right, never overflow the scratch
    for stamp in ((8, 8), (4000, 4000)):
        try:
            drive(valid, stamp=stamp)
        except Exception:  # noqa: BLE001 — as above
            print(f"imagecore lying stamp {stamp}: unexpected raise")
            traceback.print_exc()
            failures += 1
    out = nd.decode_jpeg(valid)
    if out is None or out.shape != (h, w, 3):
        print("imagecore: the valid JPEG no longer decodes")
        failures += 1
    print(f"imagecore: {len(corpus) + 2} corpus cases, {failures} failure(s)")
    return failures


def main(argv: List[str]) -> int:
    ap = argparse.ArgumentParser(prog="python -m tfk8s_tpu_torch.tools.sanitize_smoke")
    ap.add_argument("--core", choices=["recordio", "imagecore", "all"], default="all")
    args = ap.parse_args(argv)

    from tfk8s_tpu_torch.data import _native

    if _native.sanitize_mode() is None:
        print("refusing to run: set TFK8S_NATIVE_SANITIZE=asan|ubsan "
              "(an unsanitized smoke run proves nothing)", file=sys.stderr)
        return 2

    cores: List[Callable[[str], int]] = []
    if args.core in ("recordio", "all"):
        cores.append(smoke_recordio)
    if args.core in ("imagecore", "all"):
        cores.append(smoke_imagecore)
    failures = 0
    with tempfile.TemporaryDirectory(prefix="tfk8s-sanitize-") as tmp:
        for core in cores:
            failures += core(tmp)
    print("sanitize smoke:", "FAIL" if failures else "ok")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
