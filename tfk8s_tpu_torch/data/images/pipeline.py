"""ImageDataset: record shards of compressed images -> augmented
float32 batches, decoded on a bounded worker pool; a copy of the JAX
package's ``data/images/pipeline.py`` whose batches equal it bit for bit
(the same shards, seed, epoch, backend and options).

A ``RecordDataset`` whose decode stage (``_decode_records``) fans each
batch's images out over a ``ThreadPoolExecutor`` and assembles the
result IN PLACE: the batch ``[B, size, size, 3]`` float32 (and the
``[B]`` int32 labels) is preallocated once per batch and every worker
writes its slot directly — no per-image array, no downstream
``np.stack`` copy of the full batch on the hot path.

Two decode backends per image (``decode.image_backend``,
``TFK8S_IMAGE_BACKEND=native|pil|auto``):

- native — the libjpeg core: the seeded crop box is drawn FIRST from
  the record's header-stamped geometry (crop parameters are
  backend-independent, so the per-(seed, epoch, record) rng contract
  and resume determinism survive a backend switch), then one fused C
  call decodes at the largest DCT-domain downscale that still covers
  the crop (``transforms.choose_scale``), crops, resizes, flips and
  normalizes straight into the batch slot;
- pil — the reference path (PIL's libjpeg/zlib loops release the GIL,
  so W workers buy close to W-way decode parallelism without
  processes). PNG records — and any bytes the native core rejects —
  take this path even under the native backend, with the SAME
  already-drawn crop.

Observability: pass the process's ``utils/logging.Metrics`` registry to
:func:`set_metrics` and the pipeline exports

- ``tfk8s_images_decoded_total{mode, backend}`` — images decoded
- ``tfk8s_image_decode_errors_total{mode}`` — records that failed
- ``tfk8s_image_decode_seconds{mode, backend}`` — per-batch
  decode+augment wall time
- ``tfk8s_image_decode_queue_depth{mode}`` — staged batches in the
  prefetch queue, labeled per mode so concurrent train and evaluator
  datasets stop clobbering each other's gauge (the input-starvation
  early-warning: a queue pinned at 0 means the decode pool, not the
  trainer, is the bottleneck)
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np

from tfk8s_tpu_torch.data.dataset import RecordDataset
from tfk8s_tpu_torch.data.images import _native_decode, schema
from tfk8s_tpu_torch.data.images.decode import (
    ImageDecodeError,
    image_size,
    open_image,
    resolve_backend,
)
from tfk8s_tpu_torch.data.images.transforms import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    apply_crop,
    choose_scale,
    eval_crop_box,
    eval_transform,
    normalize_affine,
    train_crop_params,
)

# decouples the augmentation rng stream from the shuffle stream (which
# folds [seed, epoch] in RecordDataset._epoch_order)
_AUG_SALT = 0x1A6E5EED

_metrics = None
_metrics_lock = threading.Lock()


def set_metrics(registry) -> None:
    """Install the process's ``Metrics`` registry (utils/logging) as
    the sink for the pipeline's decode metrics. None disables."""
    global _metrics
    with _metrics_lock:
        _metrics = registry
        if registry is not None:
            registry.describe(
                "tfk8s_images_decoded_total",
                "Images decoded by the input pipeline",
            )
            registry.describe(
                "tfk8s_image_decode_seconds",
                "Wall time of one batch decode+augment",
            )
            registry.describe(
                "tfk8s_image_decode_queue_depth",
                "Decoded batches staged in the prefetch queue",
            )
            registry.describe(
                "tfk8s_image_decode_errors_total",
                "Records that failed image decode (corrupt or wrong schema)",
            )


def get_metrics():
    return _metrics


def default_workers() -> int:
    """Decode pool width: every core up to 8 — past that, JPEG decode on
    one host is usually no longer the binding constraint and the threads
    just contend with the trainer's own host work."""
    return max(min(os.cpu_count() or 1, 8), 1)


class ImageDataset(RecordDataset):
    """Shard-assigned, shuffled, batched IMAGE input: each record is an
    image Example (``schema.py``); batches come out as
    ``{"image": float32 [B, size, size, 3], "label": int32 [B]}`` —
    exactly the host-batch schema ``models/resnet.py`` and
    ``models/vit.py`` train on.

    ``train=True`` applies the seeded training augmentation
    (random-resized-crop + flip + normalize); ``train=False`` the
    deterministic eval view (resize + center-crop). All RecordDataset
    semantics (per-host file/record sharding, seeded epoch shuffle,
    resume fast-forward) carry over unchanged.

    ``backend`` picks the decoder (None/"auto" = env-resolved;
    ``TFK8S_IMAGE_BACKEND``); ``scaled_decode`` gates the native
    DCT-domain scaled decode (None = env ``TFK8S_IMAGE_SCALED_DECODE``,
    default on — off forces full-scale IDCT).
    """

    def __init__(
        self,
        files: Sequence[str],
        batch_size: int,
        image_size: int,
        train: bool = True,
        workers: Optional[int] = None,
        host_index: int = 0,
        num_hosts: int = 1,
        seed: int = 0,
        shuffle: Optional[bool] = None,
        do_normalize: bool = True,
        min_scale: float = 0.08,
        backend: Optional[str] = None,
        scaled_decode: Optional[bool] = None,
    ):
        super().__init__(
            files,
            batch_size,
            host_index=host_index,
            num_hosts=num_hosts,
            seed=seed,
            # eval wants the stable unshuffled order unless told otherwise
            shuffle=train if shuffle is None else shuffle,
        )
        if image_size < 1:
            raise ValueError(f"image_size must be >= 1, got {image_size}")
        self.image_size = image_size
        self.train = train
        self.do_normalize = do_normalize
        self.min_scale = min_scale  # RRC area floor (transforms.py)
        self.workers = workers or default_workers()
        self.backend = resolve_backend(backend)
        if scaled_decode is None:
            scaled_decode = os.environ.get(
                "TFK8S_IMAGE_SCALED_DECODE", "1"
            ) != "0"
        self.scaled_decode = bool(scaled_decode)
        self.images_decoded = 0  # cumulative (windowed-rate source)
        self.native_decoded = 0  # slots served by the fused native call
        # the per-channel affine the fused native kernel applies — the
        # SAME cached constants the PIL path normalizes with
        # (transforms.normalize_affine), so the backends cannot drift;
        # identity when do_normalize=False -> raw 0..255 float pixels
        if do_normalize:
            self._chan_scale, self._chan_bias = normalize_affine(
                IMAGENET_MEAN, IMAGENET_STD
            )
        else:
            self._chan_scale = np.ones(3, np.float32)
            self._chan_bias = np.zeros(3, np.float32)
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pool_lock = threading.Lock()

    # -- decode stage -------------------------------------------------------

    def _ensure_pool(self) -> ThreadPoolExecutor:
        with self._pool_lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self.workers,
                    thread_name_prefix="img-decode",
                )
            return self._pool

    def _rng_for(self, record_id: int, epoch: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, _AUG_SALT, epoch, record_id])
        )

    def _decode_into(
        self,
        dst: np.ndarray,
        record: bytes,
        record_id: int,
        epoch: int,
    ) -> tuple:
        """Decode + augment one record INTO ``dst`` (a [size, size, 3]
        float32 batch slot); returns (label, native_served). The crop
        parameters are drawn before any pixel materializes, from the
        header-stamped geometry, so they are identical under either
        backend — the native call and the PIL fallback realize the SAME
        crop."""
        size = self.image_size
        try:
            ex = schema.decode_image_example(record)
            fmt = ex.format or schema.sniff_format(ex.encoded)
            if self.backend == "native" and fmt == "jpeg":
                h, w, _c = image_size(
                    ex.encoded, stamped=(ex.height, ex.width, ex.channels)
                )
                if self.train:
                    top, left, ch, cw, flip = train_crop_params(
                        self._rng_for(record_id, epoch), h, w,
                        self.min_scale,
                    )
                else:
                    top, left, ch, cw = eval_crop_box(h, w, size)
                    flip = False
                s = choose_scale(ch, cw, size) if self.scaled_decode else 8
                if _native_decode.decode_rrc_into(
                    ex.encoded, (top, left, ch, cw), size, flip, s,
                    self._chan_scale, self._chan_bias, dst, (h, w),
                ):
                    return ex.label, True
                # the core refused this one image (corrupt-for-native,
                # stamp/geometry mismatch): SAME crop through PIL — the
                # rng stream is already consumed and must not re-draw
                img = open_image(ex.encoded)
                aw, ah = img.size
                if (h, w) != (ah, aw):
                    # the crop was drawn from a LYING stamp; whether it
                    # overflows the real frame (PIL would crash on the
                    # box) or lands inside a larger one (silently
                    # mis-positioned, backend-divergent crops), the draw
                    # is invalid — name the corruption (fail-loudly)
                    raise ImageDecodeError(
                        f"header-stamped geometry {h}x{w} disagrees with "
                        f"the decoded frame {ah}x{aw} — re-pack the shard"
                    )
                apply_crop(
                    img, (top, left, ch, cw), size, flip,
                    self.do_normalize, out=dst,
                )
                return ex.label, False
            img = open_image(ex.encoded)
            w, h = img.size
            if ex.height > 0 and ex.width > 0 and (
                (ex.height, ex.width) != (h, w)
            ):
                # the PIL backend must refuse a lying stamp exactly like
                # the native one — otherwise the same shard trains
                # silently under pil and raises under native, and the
                # backend-independent crop contract quietly breaks
                raise ImageDecodeError(
                    f"header-stamped geometry {ex.height}x{ex.width} "
                    f"disagrees with the decoded frame {h}x{w} — re-pack "
                    "the shard"
                )
            if self.train:
                # geometry from the decoded object (free here, and
                # header-equal, so the draw matches the native path)
                top, left, ch, cw, flip = train_crop_params(
                    self._rng_for(record_id, epoch), h, w, self.min_scale
                )
                apply_crop(
                    img, (top, left, ch, cw), size, flip,
                    self.do_normalize, out=dst,
                )
            else:
                eval_transform(img, size, self.do_normalize, out=dst)
        except (ImageDecodeError, schema.ImageSchemaError) as exc:
            m = get_metrics()
            if m is not None:
                m.inc(
                    "tfk8s_image_decode_errors_total",
                    labels={"mode": "train" if self.train else "eval"},
                )
            raise ImageDecodeError(
                f"record {record_id} of shard set {self.files}: {exc}"
            ) from exc
        return ex.label, False

    def _decode_records(
        self, records: List[bytes], record_ids: List[int], epoch: int
    ) -> Dict[str, np.ndarray]:
        """The decode stage, assembling IN PLACE: one preallocated
        [B, size, size, 3] float32 batch, every worker writing its slot
        directly (``RecordDataset._load`` passes an assembled dict
        through untouched — no np.stack copy)."""
        t0 = time.perf_counter()
        n = len(records)
        size = self.image_size
        images = np.empty((n, size, size, 3), np.float32)
        labels = np.empty((n,), np.int32)

        def one(i: int) -> int:
            label, native = self._decode_into(
                images[i], records[i], record_ids[i], epoch
            )
            labels[i] = label
            return 1 if native else 0

        if n == 1 or self.workers == 1:
            native_n = sum(one(i) for i in range(n))
        else:
            native_n = sum(self._ensure_pool().map(one, range(n)))
        self.images_decoded += n
        self.native_decoded += native_n
        m = get_metrics()
        if m is not None:
            mode = "train" if self.train else "eval"
            # decoded_total counts the backend that ACTUALLY served each
            # slot — a native dataset whose images fell back to PIL (PNG
            # shards, bytes the core refuses) must show up as pil, or
            # /metrics would hide exactly the bandwidth regression the
            # label exists to expose
            if native_n:
                m.inc(
                    "tfk8s_images_decoded_total", float(native_n),
                    labels={"mode": mode, "backend": "native"},
                )
            if n - native_n:
                m.inc(
                    "tfk8s_images_decoded_total", float(n - native_n),
                    labels={"mode": mode, "backend": "pil"},
                )
            # batch wall time is one observation; labeled by the
            # CONFIGURED backend (the batch may mix per-image paths)
            m.observe(
                "tfk8s_image_decode_seconds", time.perf_counter() - t0,
                labels={"mode": mode, "backend": self.backend},
            )
        return {"image": images, "label": labels}

    # -- lifecycle ----------------------------------------------------------

    def iterator(self, prefetch: int = 2, start_batch: int = 0):
        it = super().iterator(prefetch, start_batch)
        if prefetch > 0:
            return _QueueDepthIterator(it, "train" if self.train else "eval")
        return it

    def close(self) -> None:
        """Shut the decode pool down (joins idle workers — no leaked
        threads after the run; the e2e tests assert this)."""
        with self._pool_lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True)

    def __del__(self):  # best-effort: a dropped dataset must not pin threads
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter may be tearing down
            pass


class _QueueDepthIterator:
    """Prefetch-iterator wrapper exporting the staged-batch count as the
    ``tfk8s_image_decode_queue_depth{mode}`` gauge on every dequeue —
    mode-labeled so a train pipeline and a concurrent evaluator each
    own their series instead of clobbering one shared gauge."""

    def __init__(self, inner, mode: str):
        self._inner = inner
        self._mode = mode

    def __iter__(self):
        return self

    def __next__(self):
        item = next(self._inner)
        m = get_metrics()
        if m is not None:
            q = getattr(self._inner, "_q", None)
            if q is not None:
                m.set_gauge(
                    "tfk8s_image_decode_queue_depth", float(q.qsize()),
                    labels={"mode": self._mode},
                )
        return item

    def close(self) -> None:
        self._inner.close()
