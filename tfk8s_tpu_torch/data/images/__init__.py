"""Image data plane: JPEG/PNG image records, decode and augmentation, a
copy of the JAX package's ``data/images``: the same shards, seed and
options give the same batches, bit for bit.

- ``schema``   — the image Example layout (encoded JPEG/PNG bytes +
  label + shape metadata) on the ``data/example.py`` codec, plus the
  atomic shard writer;
- ``decode``   — compressed bytes -> HWC uint8 RGB behind a backend
  dispatch (``TFK8S_IMAGE_BACKEND=native|pil|auto``): the native
  libjpeg core (``data/native/imagecore.cc``, built at first use by
  ``_native_decode.py``) serves JPEG with DCT-scaled decode; PIL is the
  reference path and the fallback when the toolchain, libjpeg, or the
  format support is absent. Neither is needed to import this package;
  without both, the first decode raises ``ImageDecodeError``;
- ``transforms`` — random-resized-crop / horizontal-flip / per-channel
  normalize for training, resize + center-crop for eval, all
  seed-deterministic for resume;
- ``pipeline`` — ``ImageDataset``: a ``RecordDataset`` whose decode
  stage fans out over a bounded worker pool, exporting
  ``tfk8s_images_decoded_total`` / decode-seconds / queue-depth through
  the ``utils/logging.Metrics`` registry;
- ``pack``     — the CLI (``python -m tfk8s_tpu_torch.data.images.pack``)
  packing a class-per-subdir image tree (or a synthetic JPEG set) into
  training shards.
"""

from tfk8s_tpu_torch.data.images.decode import (  # noqa: F401
    ImageDecodeError,
    decode_image,
    encode_jpeg,
    encode_png,
    image_backend,
    image_size,
)
from tfk8s_tpu_torch.data.images.pipeline import (  # noqa: F401
    ImageDataset,
    get_metrics,
    set_metrics,
)
from tfk8s_tpu_torch.data.images.schema import (  # noqa: F401
    ImageExample,
    ImageSchemaError,
    decode_image_example,
    encode_image_example,
    is_image_example,
    write_image_shards,
)
from tfk8s_tpu_torch.data.images.transforms import (  # noqa: F401
    IMAGENET_MEAN,
    IMAGENET_STD,
    eval_transform,
    train_transform,
)

__all__ = [
    "IMAGENET_MEAN",
    "IMAGENET_STD",
    "ImageDataset",
    "ImageDecodeError",
    "ImageExample",
    "ImageSchemaError",
    "decode_image",
    "decode_image_example",
    "encode_image_example",
    "encode_jpeg",
    "encode_png",
    "eval_transform",
    "get_metrics",
    "image_backend",
    "image_size",
    "is_image_example",
    "set_metrics",
    "train_transform",
    "write_image_shards",
]
