"""Image transforms: the standard ImageNet training recipe (random
resized crop + horizontal flip + per-channel normalize) and its
deterministic eval counterpart (resize shorter side + center crop); a
copy of the JAX package's ``data/images/transforms.py``, the same draws
and the same pixels.

Seed discipline: every random choice draws from the ``np.random
.Generator`` the caller passes — no module/global state — so the
pipeline can derive one generator per (seed, epoch, record) and a
resumed run replays the IDENTICAL augmentation stream (the same
property the record shuffle in ``data/dataset.py`` has).

Backend split: the CROP PARAMETERS (:func:`train_crop_params`,
:func:`eval_crop_box`) are computed from the record's header-stamped
geometry first, in full-resolution coordinates, consuming a fixed rng
draw sequence — so they are identical whichever decoder materializes
the pixels, and resume determinism survives a backend switch mid-fleet.
The decode backend then picks the cheapest way to realize the crop:

- PIL: :func:`apply_crop` resizes on the PIL object with ``box=`` (a
  224 crop of a 500x375 JPEG touches ~1/3 of the pixels a
  decode-then-crop pipeline would);
- native: :func:`choose_scale` picks the largest DCT-domain downscale
  (``scale_num/8``) whose decoded frame still covers the crop's resize
  target, and the fused C kernel does the rest
  (``_native_decode.decode_rrc_into``).
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple, Union

import numpy as np

# ImageNet per-channel statistics (the constants every pretrained-vision
# pipeline normalizes with)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# eval resizes the shorter side to size * (256/224) before the center
# crop — the canonical 256-resize/224-crop ratio, kept exact for any
# target size
_EVAL_RESIZE_RATIO = 256 / 224

# DCT-domain scales the pipeline will ask libjpeg for: powers of two
# only — libjpeg-turbo has SIMD IDCT at 1/8, 2/8, 4/8, 8/8; a "cheaper"
# 6/8 decode runs the scalar 6x6 IDCT and measures SLOWER than a
# full-scale SIMD decode
_SIMD_SCALES = (1, 2, 4, 8)


def _as_pil(img):
    from tfk8s_tpu_torch.data.images.decode import _require_pil

    Image = _require_pil()
    if isinstance(img, np.ndarray):
        return Image.fromarray(np.asarray(img, np.uint8), "RGB")
    return img


def _bilinear():
    from tfk8s_tpu_torch.data.images.decode import _require_pil

    Image = _require_pil()
    # Pillow >= 9.1 moved resample filters to Image.Resampling
    return getattr(Image, "Resampling", Image).BILINEAR


def sample_crop(
    rng: np.random.Generator,
    height: int,
    width: int,
    scale: Tuple[float, float] = (0.08, 1.0),
    ratio: Tuple[float, float] = (3 / 4, 4 / 3),
    attempts: int = 10,
) -> Tuple[int, int, int, int]:
    """The random-resized-crop box (top, left, h, w): area uniform in
    ``scale`` x image area, aspect log-uniform in ``ratio``; after
    ``attempts`` rejections fall back to the largest in-ratio center
    crop (torchvision's exact fallback, so tail-shaped images don't
    bias toward tiny crops)."""
    area = height * width
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(attempts):
        target = area * rng.uniform(scale[0], scale[1])
        aspect = math.exp(rng.uniform(*log_ratio))
        w = int(round(math.sqrt(target * aspect)))
        h = int(round(math.sqrt(target / aspect)))
        if 0 < w <= width and 0 < h <= height:
            top = int(rng.integers(0, height - h + 1))
            left = int(rng.integers(0, width - w + 1))
            return top, left, h, w
    in_ratio = width / height
    if in_ratio < ratio[0]:
        w, h = width, int(round(width / ratio[0]))
    elif in_ratio > ratio[1]:
        w, h = int(round(height * ratio[1])), height
    else:
        w, h = width, height
    return (height - h) // 2, (width - w) // 2, h, w


def train_crop_params(
    rng: np.random.Generator,
    height: int,
    width: int,
    min_scale: float = 0.08,
) -> Tuple[int, int, int, int, bool]:
    """The full training draw for one image — RRC box (top, left, h, w)
    plus the horizontal-flip coin — from geometry alone, BEFORE any
    pixel is decoded. Consumes exactly the same rng draws regardless of
    which backend later materializes the crop, so the per-(seed, epoch,
    record) stream is backend-independent and a resumed run replays it
    identically."""
    top, left, ch, cw = sample_crop(rng, height, width, scale=(min_scale, 1.0))
    flip = bool(rng.integers(0, 2))
    return top, left, ch, cw, flip


def eval_crop_box(height: int, width: int, size: int) -> Tuple[int, int, int, int]:
    """The deterministic eval view's crop as a SOURCE-coordinate box
    (top, left, h, w): resize-shorter-side-then-center-crop is, in
    source coordinates, a centered square of side
    ``min(h, w) * size / (size * 256/224)`` — the form the native
    scaled-decode path consumes (crop box first, cheapest covering
    scale second)."""
    short = max(int(round(size * _EVAL_RESIZE_RATIO)), size)
    side = int(round(min(height, width) * size / short))
    side = max(min(side, height, width), 1)
    return (height - side) // 2, (width - side) // 2, side, side


def choose_scale(crop_h: int, crop_w: int, target: int) -> int:
    """The largest DCT-domain downscale (smallest ``scale_num``, denom
    8) whose decoded frame still COVERS the crop's resize target — i.e.
    the scaled crop stays >= ``target`` px on both sides, so the
    follow-on bilinear resize never upscales (quality) and the IDCT
    does the least work (speed). A crop already smaller than the target
    decodes at full scale. Scales are restricted to the SIMD set
    {1, 2, 4, 8}."""
    for s in _SIMD_SCALES:
        if crop_h * s >= 8 * target and crop_w * s >= 8 * target:
            return s
    return 8


@functools.lru_cache(maxsize=8)
def normalize_affine(
    mean: Tuple[float, float, float] = IMAGENET_MEAN,
    std: Tuple[float, float, float] = IMAGENET_STD,
) -> Tuple[np.ndarray, np.ndarray]:
    """Normalization as ONE fused per-channel multiply-add:
    ``(p/255 - mean)/std == p * scale + bias`` with
    ``scale = 1/(255*std)``, ``bias = -mean/std`` — float32,
    C-contiguous, cached. THE single source of the constants both
    backends apply (the PIL path through :func:`_affine_to`, the native
    path handed to the fused C kernel) — so they cannot drift apart.
    Treat the returned arrays as read-only (they are shared)."""
    std32 = np.asarray(std, np.float32)
    scale = np.ascontiguousarray(1.0 / (255.0 * std32))
    bias = np.ascontiguousarray(-np.asarray(mean, np.float32) / std32)
    return scale, bias


def normalize(
    pixels: np.ndarray,
    mean: Tuple[float, float, float] = IMAGENET_MEAN,
    std: Tuple[float, float, float] = IMAGENET_STD,
) -> np.ndarray:
    """uint8 HWC -> float32 HWC, scaled to [0,1] then per-channel
    standardized."""
    return _affine_to(pixels, True, mean, std, None)


def _affine_to(
    pixels: np.ndarray,
    do_normalize: bool,
    mean: Tuple[float, float, float],
    std: Tuple[float, float, float],
    out: Optional[np.ndarray],
) -> np.ndarray:
    """uint8 -> float32 as one fused per-channel affine written into
    ``out`` when given (a preallocated batch slot — no per-image array,
    no later stack copy): normalize is ``p/255/std - mean/std``; the
    raw-float contract (``do_normalize=False``) is ``p * 1 + 0``."""
    pixels = np.asarray(pixels)
    if pixels.dtype != np.uint8:
        # keep float32 math whatever arrives (the old contract)
        pixels = pixels.astype(np.float32, copy=False)
    if do_normalize:
        scale, bias = normalize_affine(tuple(mean), tuple(std))
        out = np.multiply(pixels, scale, out=out)
        out += bias
        return out
    if out is None:
        return np.asarray(pixels, np.float32)
    out[...] = pixels
    return out


def apply_crop(
    img: Union[np.ndarray, "object"],
    box: Tuple[int, int, int, int],
    size: int,
    flip: bool = False,
    do_normalize: bool = True,
    mean: Tuple[float, float, float] = IMAGENET_MEAN,
    std: Tuple[float, float, float] = IMAGENET_STD,
    out: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Materialize an already-drawn crop through PIL: resize ``box``
    (top, left, h, w) to ``size`` x ``size``, mirror when ``flip``,
    float32(+normalize) into ``out`` when given. The PIL half of the
    backend split — pixel-identical to the historical
    ``train_transform`` for the same draws."""
    pil = _as_pil(img)
    top, left, ch, cw = box
    pil = pil.resize(
        (size, size), _bilinear(), box=(left, top, left + cw, top + ch)
    )
    arr = np.asarray(pil, np.uint8)
    if flip:
        arr = arr[:, ::-1]
    return _affine_to(arr, do_normalize, mean, std, out)


def train_transform(
    img: Union[np.ndarray, "object"],
    rng: np.random.Generator,
    size: int,
    do_normalize: bool = True,
    min_scale: float = 0.08,
    out: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Random-resized-crop to ``size`` + horizontal flip (p=0.5) +
    normalize -> float32 [size, size, 3], written into ``out`` when
    given. Draws via :func:`train_crop_params` (fixed rng consumption),
    materializes via :func:`apply_crop`.

    ``min_scale`` is the crop-area floor: 0.08 is the ImageNet
    standard (224px natural images, ~1.3M samples); small/synthetic
    datasets usually want a gentler 0.3-0.6 — an 8%-area crop of a
    28px image is an 8px blob, and a toy task trained on those stops
    converging (regularization outweighing signal)."""
    pil = _as_pil(img)
    w, h = pil.size
    top, left, ch, cw, flip = train_crop_params(rng, h, w, min_scale)
    return apply_crop(
        pil, (top, left, ch, cw), size, flip, do_normalize, out=out
    )


def eval_transform(
    img: Union[np.ndarray, "object"],
    size: int,
    do_normalize: bool = True,
    out: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Deterministic eval view: shorter side to ``size * 256/224``,
    center crop ``size`` -> float32 [size, size, 3]."""
    pil = _as_pil(img)
    w, h = pil.size
    short = max(int(round(size * _EVAL_RESIZE_RATIO)), size)
    if w <= h:
        rw, rh = short, max(int(round(h * short / w)), short)
    else:
        rw, rh = max(int(round(w * short / h)), short), short
    pil = pil.resize((rw, rh), _bilinear())
    left, top = (rw - size) // 2, (rh - size) // 2
    pil = pil.crop((left, top, left + size, top + size))
    arr = np.asarray(pil, np.uint8)
    return _affine_to(arr, do_normalize, IMAGENET_MEAN, IMAGENET_STD, out)
