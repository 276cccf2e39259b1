"""Lazy g++ build + ctypes binding for the native image-decode core
(``data/native/imagecore.cc``: libjpeg via the system ``jpeglib.h``,
linked ``-ljpeg``).

Built by ``data/_native.build_cached``, as the record core is: on first
use, into ``build/native/`` (``$TFK8S_NATIVE_CACHE`` overrides it), under
a name carrying the source's hash (and ``TFK8S_NATIVE_SANITIZE``'s mode),
so an edited source is rebuilt and concurrent builders race benignly
(atomic rename). Hosts without a toolchain or without
``jpeglib.h``/``libjpeg`` — or ``TFK8S_PURE_PY=1``, the single switch
that disables ALL native codepaths — fall back to the PIL decoder in
``decode.py``; every capability has both paths and the tests assert
they agree (exact pixels for PNG-through-PIL, bounded tolerance for
JPEG — IDCT implementations legitimately differ).

The binder exposes the C core at two levels:

- :func:`decode_jpeg` / :func:`decode_jpeg_scaled` / :func:`jpeg_info`
  — array in, array out (tests, :func:`decode.decode_image`);
- :func:`decode_rrc_into` — the fused training hot path: scaled decode
  + crop + bilinear resize + flip + normalize written straight into a
  caller-provided float32 batch slot, one C call per image. The decode
  scratch frame is thread-local and reused, so a steady-state decode
  worker allocates nothing per image.
"""

from __future__ import annotations

import ctypes
import logging
import os
import threading
from typing import Optional, Tuple

import numpy as np

from tfk8s_tpu_torch.data._native import build_cached, dlopen_checked

log = logging.getLogger("tfk8s.data.images.native")

_SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "native", "imagecore.cc",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_fallback_warned = False

_i64 = ctypes.c_int64
_pi64 = ctypes.POINTER(_i64)
_pu8 = ctypes.POINTER(ctypes.c_uint8)
_pf32 = ctypes.POINTER(ctypes.c_float)


def _build() -> Optional[str]:
    # the shared hash-keyed build (data/_native.build_cached); a FAILED
    # build with g++ present is most often a missing jpeglib.h —
    # build_cached logs the compiler's own words either way
    return build_cached(
        _SRC, "imagecore", log,
        "image-decode core (missing jpeglib.h / libjpeg-dev?)",
        "the PIL decoder (slower per decode worker)",
        extra_flags=("-ljpeg",),
    )


def load() -> Optional[ctypes.CDLL]:
    """The bound native library, or None (toolchain/libjpeg missing, or
    disabled). Build + bind happen once per process and the result is
    latched; the ``TFK8S_PURE_PY=1`` opt-out is checked on EVERY call so
    flipping it (tests, operator toggles) takes effect immediately."""
    global _lib, _tried
    if os.environ.get("TFK8S_PURE_PY") == "1":
        return None
    if _tried:
        return _lib
    with _lock:
        if _tried:
            return _lib
        path = _build()
        if path is None:
            _tried = True
            return None
        lib = dlopen_checked(
            path, log, "image-decode core",
            "the PIL decoder (slower per decode worker)",
        )
        if lib is None:
            _tried = True
            return None
        lib.img_info.restype = _i64
        lib.img_info.argtypes = [ctypes.c_char_p, _i64, _pi64, _pi64, _pi64]
        lib.img_decode.restype = _i64
        lib.img_decode.argtypes = [
            ctypes.c_char_p, _i64, _pu8, _i64, _pi64, _pi64
        ]
        lib.img_decode_scaled.restype = _i64
        lib.img_decode_scaled.argtypes = [
            ctypes.c_char_p, _i64, _i64, _pu8, _i64, _pi64, _pi64
        ]
        lib.img_decode_rrc.restype = _i64
        lib.img_decode_rrc.argtypes = [
            ctypes.c_char_p, _i64,            # data, n
            _i64, _i64, _i64, _i64,           # top, left, crop_h, crop_w
            _i64, _i64,                       # full_h, full_w (the stamp)
            _i64, ctypes.c_int32, _i64,       # target, flip, scale_num
            _pf32, _pf32,                     # chan_scale, chan_bias
            _pu8, _i64,                       # scratch, scratch_cap
            _pf32,                            # out
        ]
        _lib = lib
        _tried = True
        return _lib


def available() -> bool:
    return load() is not None


def warn_fallback_once(reason: str) -> None:
    """One loud line the first time image decode runs without the native
    core it expected: an input-bandwidth loss, not a detail (PIL decodes
    the whole frame, where the fused native call decodes at the smallest
    DCT scale that covers the crop, and crops, resizes and normalizes in
    one pass). Deliberate opt-outs (``TFK8S_PURE_PY=1``,
    ``TFK8S_IMAGE_BACKEND=pil``) stay quiet: the operator chose them."""
    global _fallback_warned
    if _fallback_warned:
        return
    with _lock:
        if _fallback_warned:
            return
        _fallback_warned = True
    log.warning(
        "image decode: native core unavailable (%s) — PIL decoder in use "
        "(slower per decode worker; large sources lose DCT-scaled decode). "
        "Install g++ + libjpeg-dev (or see the build warning above) to "
        "restore decode bandwidth.",
        reason,
    )


def scaled_dim(dim: int, scale_num: int) -> int:
    """libjpeg's output size for one side at ``scale_num/8``:
    ``ceil(dim * scale_num / 8)`` (jdiv_round_up)."""
    return (dim * scale_num + 7) // 8


def jpeg_info(encoded: bytes) -> Optional[Tuple[int, int, int]]:
    """(height, width, source components) from the JPEG header, or None
    when the native core is unavailable or rejects the bytes."""
    lib = load()
    if lib is None:
        return None
    h, w, c = _i64(), _i64(), _i64()
    if lib.img_info(encoded, len(encoded), h, w, c) != 0:
        return None
    return h.value, w.value, c.value


def decode_jpeg_scaled(
    encoded: bytes, scale_num: int = 8
) -> Optional[np.ndarray]:
    """JPEG bytes -> HWC uint8 RGB at ``scale_num/8`` scale, or None
    (native core unavailable, or bytes it cannot decode — the caller
    retries through PIL, whose error text names the corruption)."""
    lib = load()
    if lib is None:
        return None
    info = jpeg_info(encoded)
    if info is None:
        return None
    h, w = scaled_dim(info[0], scale_num), scaled_dim(info[1], scale_num)
    out = np.empty((h, w, 3), np.uint8)
    oh, ow = _i64(), _i64()
    rc = lib.img_decode_scaled(
        encoded, len(encoded), scale_num,
        out.ctypes.data_as(_pu8), out.nbytes, oh, ow,
    )
    if rc != 0:
        return None
    return out[: oh.value, : ow.value]


def decode_jpeg(encoded: bytes) -> Optional[np.ndarray]:
    """JPEG bytes -> full-scale HWC uint8 RGB, or None (see
    :func:`decode_jpeg_scaled`)."""
    return decode_jpeg_scaled(encoded, 8)


# per-decode-worker scratch frame, grown to the largest scaled frame the
# worker has seen — steady state decodes allocate nothing
_scratch = threading.local()


def _scratch_buf(nbytes: int) -> np.ndarray:
    buf = getattr(_scratch, "buf", None)
    if buf is None or buf.nbytes < nbytes:
        buf = np.empty(nbytes, np.uint8)
        _scratch.buf = buf
    return buf


def decode_rrc_into(
    encoded: bytes,
    box: Tuple[int, int, int, int],
    target: int,
    flip: bool,
    scale_num: int,
    chan_scale: np.ndarray,
    chan_bias: np.ndarray,
    dst: np.ndarray,
    frame: Tuple[int, int],
) -> bool:
    """The fused hot path: decode ``encoded`` at ``scale_num/8``, crop
    ``box`` (top, left, h, w in FULL-resolution coordinates — drawn by
    the caller from header-stamped geometry so crop parameters stay
    backend-independent), bilinear-resize to ``target``, mirror when
    ``flip``, and write ``pix * chan_scale[c] + chan_bias[c]`` float32
    into ``dst`` (a C-contiguous [target, target, 3] float32 view, e.g.
    one slot of the preallocated batch). ``frame`` is the full-scale
    (height, width) — the header stamp; it sizes the scratch frame and
    the C side verifies it against the real frame (a lying stamp comes
    back as a refusal, never an overflow). Returns False when the
    native path cannot serve the image (library absent, corrupt bytes,
    geometry mismatch) — the caller falls back to PIL."""
    lib = load()
    if lib is None:
        return False
    # the pointer handoff is unchecked past here: a wrong dtype or a
    # strided view would be SILENT pixel corruption, and an undersized
    # buffer a heap overwrite — the C kernel writes target*target*3
    # floats unconditionally
    if (
        dst.dtype != np.float32
        or not dst.flags.c_contiguous
        or dst.shape != (target, target, 3)
    ):
        raise ValueError(
            f"dst must be C-contiguous float32 [{target}, {target}, 3], "
            f"got {dst.dtype} {dst.shape} "
            f"(contiguous={dst.flags.c_contiguous})"
        )
    for name, arr in (("chan_scale", chan_scale), ("chan_bias", chan_bias)):
        if arr.dtype != np.float32 or not arr.flags.c_contiguous or arr.size != 3:
            raise ValueError(f"{name} must be 3 C-contiguous float32 values")
    h, w = frame
    need = scaled_dim(h, scale_num) * scaled_dim(w, scale_num) * 3
    scratch = _scratch_buf(need)
    top, left, ch, cw = box
    rc = lib.img_decode_rrc(
        encoded, len(encoded),
        top, left, ch, cw,
        h, w,
        target, 1 if flip else 0, scale_num,
        chan_scale.ctypes.data_as(_pf32),
        chan_bias.ctypes.data_as(_pf32),
        scratch.ctypes.data_as(_pu8), scratch.nbytes,
        dst.ctypes.data_as(_pf32),
    )
    return rc == 0
