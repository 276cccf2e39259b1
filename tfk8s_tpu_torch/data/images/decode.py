"""Compressed image bytes -> HWC uint8 RGB arrays (and back, for the
packer and the tests), behind a backend dispatch. A copy of the JAX
package's ``data/images/decode.py``: the same backend policy, the same
pixels and the same error texts.

Two decode backends, selected by ``TFK8S_IMAGE_BACKEND``:

- ``native`` — the libjpeg core (``data/native/imagecore.cc``, built
  lazily by ``_native_decode.py``): JPEG decode with DCT-domain scaling
  and the fused decode+crop+resize+normalize hot path the
  ``pipeline.ImageDataset`` workers use. JPEG only; PNG and anything
  the core rejects falls through to PIL per image.
- ``pil``    — the PIL path (libjpeg/zlib with the GIL released), the
  reference implementation every native capability is tested against.
- ``auto``   (default) — native when the core builds, else PIL with ONE
  loud line saying what is lost. ``TFK8S_PURE_PY=1`` forces PIL quietly — the single switch
  that disables ALL native codepaths (recordio and image decode), and a
  deliberate choice the logs don't second-guess.

Callers depend on ``decode_image``/``open_image``/``image_size`` only;
the transform/pipeline stack reaches the fused native entrypoints
through ``_native_decode`` directly.

PIL is gated at import: the package imports on a host with neither PIL
nor libjpeg (the control plane, or a card host without a decoder), and
there the first decode raises :class:`ImageDecodeError` naming Pillow.
"""

from __future__ import annotations

import io
import os
from typing import Optional, Tuple

import numpy as np

from tfk8s_tpu_torch.data.images.schema import sniff_format

try:  # gate, don't hard-require: the control plane never decodes
    from PIL import Image as _PILImage
except Exception:  # noqa: BLE001 — any import failure means "no PIL"
    _PILImage = None


class ImageDecodeError(ValueError):
    """Bytes that do not decode as an image (corrupt or wrong schema)."""


def _require_pil():
    if _PILImage is None:
        raise ImageDecodeError(
            "image decode needs Pillow, which is not importable here — "
            "install it in the training image (control-plane hosts don't "
            "need it)"
        )
    return _PILImage


def resolve_backend(choice: Optional[str]) -> str:
    """The ONE place the backend-fallback policy lives — callers pass a
    request (an ``ImageDataset(backend=...)`` argument, or None/"auto"
    to read ``TFK8S_IMAGE_BACKEND``) and get the backend that will run:
    ``"native"`` or ``"pil"``. Policy: an explicit ``pil`` — or
    ``TFK8S_PURE_PY=1``, the single switch disabling ALL native
    codepaths — forces PIL quietly (deliberate choices aren't
    second-guessed); ``native``/``auto`` take the native core when it
    loads, else PIL — loudly once, because losing the native core is an
    input-bandwidth regression, not a detail."""
    if choice is None or choice == "auto":
        choice = os.environ.get(
            "TFK8S_IMAGE_BACKEND", "auto"
        ).strip().lower()
    if choice not in ("auto", "native", "pil"):
        raise ValueError(
            f"image backend {choice!r} is not one of native|pil|auto "
            "(TFK8S_IMAGE_BACKEND)"
        )
    if choice == "pil":
        return "pil"
    if os.environ.get("TFK8S_PURE_PY") == "1":
        return "pil"
    from tfk8s_tpu_torch.data.images import _native_decode

    if _native_decode.load() is not None:
        return "native"
    _native_decode.warn_fallback_once(
        "backend 'native' requested" if choice == "native"
        else "no toolchain or libjpeg to build it"
    )
    return "pil"


def image_backend() -> str:
    """The env-resolved decode backend for this process (see
    :func:`resolve_backend`)."""
    return resolve_backend(None)


def open_image(encoded: bytes):
    """Compressed bytes -> PIL RGB image (the PIL transform path crops
    on the PIL object BEFORE materializing pixels — cheaper than
    decoding to a full array first)."""
    Image = _require_pil()
    try:
        img = Image.open(io.BytesIO(encoded))
        img.load()
    except Exception as exc:  # noqa: BLE001 — PIL raises a zoo of types
        raise ImageDecodeError(f"undecodable image bytes: {exc}") from exc
    if img.mode != "RGB":
        img = img.convert("RGB")
    return img


def image_size(
    encoded: bytes,
    stamped: Optional[Tuple[int, int, int]] = None,
) -> Tuple[int, int, int]:
    """(height, width, channels), cheapest source first: the packer's
    header-stamped geometry when the caller already decoded the Example
    (``stamped=(ex.height, ex.width, ex.channels)`` — no second header
    parse per record on the hot path), else the container HEADER only —
    never a full decode."""
    if stamped is not None and all(int(v) > 0 for v in stamped):
        return int(stamped[0]), int(stamped[1]), int(stamped[2])
    if _PILImage is None and sniff_format(encoded) == "jpeg":
        # PIL-less rig with the native core: the C header parse serves
        from tfk8s_tpu_torch.data.images import _native_decode

        info = _native_decode.jpeg_info(encoded)
        if info is not None:
            return info
    Image = _require_pil()
    try:
        with Image.open(io.BytesIO(encoded)) as img:
            w, h = img.size
            bands = len(img.getbands())
    except Exception as exc:  # noqa: BLE001
        raise ImageDecodeError(f"unreadable image header: {exc}") from exc
    return h, w, bands


def decode_image(encoded: bytes) -> np.ndarray:
    """Compressed bytes -> HWC uint8 RGB array, through the resolved
    backend. The native core serves JPEG; PNG — and any bytes the core
    rejects — falls through to PIL, whose error text names the
    corruption."""
    if sniff_format(encoded) == "jpeg" and image_backend() == "native":
        from tfk8s_tpu_torch.data.images import _native_decode

        out = _native_decode.decode_jpeg(encoded)
        if out is not None:
            return out
    return np.asarray(open_image(encoded), dtype=np.uint8)


def encode_jpeg(array: np.ndarray, quality: int = 90) -> bytes:
    """HWC uint8 RGB -> JPEG bytes (packer and test helper)."""
    Image = _require_pil()
    buf = io.BytesIO()
    Image.fromarray(np.asarray(array, np.uint8), "RGB").save(
        buf, format="JPEG", quality=quality
    )
    return buf.getvalue()


def encode_png(array: np.ndarray) -> bytes:
    """HWC uint8 RGB -> PNG bytes (lossless — the golden-decode tests
    pin exact pixels through this path)."""
    Image = _require_pil()
    buf = io.BytesIO()
    Image.fromarray(np.asarray(array, np.uint8), "RGB").save(
        buf, format="PNG"
    )
    return buf.getvalue()


def have_decoder() -> bool:
    return _PILImage is not None
