"""Image tree -> recordio shards (the image half of the loop; the text
half is ``data/corpus.py``); the shards are byte for byte the JAX
package's packer's.

CLI::

    # pack an ImageNet-style tree (one subdirectory per class)
    python -m tfk8s_tpu_torch.data.images.pack \
        --input /data/imagenet/train --out-dir shards --num-shards 64

    # or generate a synthetic labeled JPEG set (demos, tests)
    python -m tfk8s_tpu_torch.data.images.pack \
        --synthetic 512 --classes 8 --image-size 64 --out-dir shards \
        --num-shards 4

Class labels are the sorted subdirectory order, written to
``labels.json`` next to the shards so training and evaluation agree on
the index mapping. Images are packed as their ORIGINAL compressed bytes
(no re-encode — packing is IO-bound, and generation loss is forever);
geometry is parsed from each header and stamped into the record. Write
>= one shard per training host to keep per-host file IO
(``data/recordio.shard_files``).

The synthetic mode draws class-conditional template images plus noise —
the same learnable-task construction as ``models/resnet.make_batch_fn``
— then JPEG-encodes them, so a files-mode ResNet can demonstrably
CONVERGE on packed shards end to end.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Iterator, List, Tuple

import numpy as np

from tfk8s_tpu_torch.data.images import decode as imgdecode
from tfk8s_tpu_torch.data.images import schema

_IMAGE_EXTS = (".jpg", ".jpeg", ".png")


def iter_class_tree(root: str) -> Tuple[List[str], Iterator[Tuple[str, int]]]:
    """(class names, iterator of (image path, label)) over a
    one-subdir-per-class tree, both in sorted order."""
    classes = sorted(
        d for d in os.listdir(root)
        if os.path.isdir(os.path.join(root, d))
    )
    if not classes:
        raise FileNotFoundError(f"no class subdirectories under {root}")

    def gen():
        for label, cls in enumerate(classes):
            cdir = os.path.join(root, cls)
            for fname in sorted(os.listdir(cdir)):
                if fname.lower().endswith(_IMAGE_EXTS):
                    yield os.path.join(cdir, fname), label

    return classes, gen()


def pack_tree(
    root: str, out_dir: str, num_shards: int, limit_per_class: int = 0
) -> Tuple[List[str], int]:
    """Pack a class tree into shards; returns (shard paths, n packed)."""
    classes, items = iter_class_tree(root)
    counts = [0] * len(classes)
    packed = [0]

    def records():
        for path, label in items:
            if limit_per_class and counts[label] >= limit_per_class:
                continue
            with open(path, "rb") as f:
                raw = f.read()
            try:
                shape = imgdecode.image_size(raw)
            except imgdecode.ImageDecodeError as exc:
                raise imgdecode.ImageDecodeError(
                    f"{path}: {exc}"
                ) from exc
            counts[label] += 1
            packed[0] += 1
            yield schema.encode_image_example(raw, label, shape=shape)

    paths = schema.write_image_shards(records(), out_dir, num_shards)
    with open(os.path.join(out_dir, "labels.json"), "w") as f:
        json.dump({cls: i for i, cls in enumerate(classes)}, f, indent=1)
    return paths, packed[0]


def synthetic_records(
    n: int, classes: int, image_size: int, seed: int, quality: int
) -> Iterator[bytes]:
    """Class-template-plus-noise uint8 images, JPEG-encoded. Labels
    cycle so every shard sees every class.

    Templates are LOW-FREQUENCY color fields (a 4x4 random grid
    bilinearly upsampled), not per-pixel noise: any random-resized crop
    of a smooth field still carries the class's color structure, so the
    task stays learnable UNDER the training augmentation — and smooth
    content is also what JPEG preserves (iid-noise templates die twice:
    once to quantization, once to cropping)."""
    from tfk8s_tpu_torch.data.images.transforms import _bilinear

    from PIL import Image  # packer host == training host; PIL present

    rng = np.random.default_rng(seed)
    temps = np.stack(
        [
            np.asarray(
                Image.fromarray(
                    rng.integers(0, 256, size=(4, 4, 3)).astype(np.uint8),
                    "RGB",
                ).resize((image_size, image_size), _bilinear()),
                dtype=np.float32,
            )
            for _ in range(classes)
        ]
    )
    for i in range(n):
        label = i % classes
        noise = rng.normal(0.0, 16.0, (image_size, image_size, 3))
        arr = np.clip(temps[label] + noise, 0, 255)
        raw = imgdecode.encode_jpeg(arr.astype(np.uint8), quality=quality)
        yield schema.encode_image_example(
            raw, label, shape=(image_size, image_size, 3)
        )


def pack_synthetic(
    out_dir: str,
    n: int,
    classes: int,
    image_size: int,
    num_shards: int,
    seed: int = 0,
    quality: int = 90,
) -> List[str]:
    paths = schema.write_image_shards(
        synthetic_records(n, classes, image_size, seed, quality),
        out_dir,
        num_shards,
    )
    with open(os.path.join(out_dir, "labels.json"), "w") as f:
        json.dump({f"class{i:03d}": i for i in range(classes)}, f, indent=1)
    return paths


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument(
        "--input", help="class-per-subdirectory image tree to pack"
    )
    src.add_argument(
        "--synthetic", type=int, metavar="N",
        help="generate N synthetic labeled JPEGs instead of reading a tree",
    )
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--num-shards", type=int, default=4)
    ap.add_argument(
        "--limit-per-class", type=int, default=0,
        help="cap images per class (0 = all; subsetting for smoke runs)",
    )
    ap.add_argument("--classes", type=int, default=8, help="synthetic only")
    ap.add_argument(
        "--image-size", type=int, default=64, help="synthetic only"
    )
    ap.add_argument("--seed", type=int, default=0, help="synthetic only")
    ap.add_argument(
        "--quality", type=int, default=90, help="synthetic JPEG quality"
    )
    args = ap.parse_args(argv)

    if args.synthetic is not None:
        paths = pack_synthetic(
            args.out_dir, args.synthetic, args.classes, args.image_size,
            args.num_shards, seed=args.seed, quality=args.quality,
        )
        n = args.synthetic
    else:
        paths, n = pack_tree(
            args.input, args.out_dir, args.num_shards,
            limit_per_class=args.limit_per_class,
        )
    total = sum(os.path.getsize(p) for p in paths)
    print(
        f"packed {n} images into {len(paths)} shards "
        f"({total / 1e6:.1f} MB) under {args.out_dir}"
    )


if __name__ == "__main__":
    main()
