"""The port's image data plane (``tfk8s_tpu_torch/data/images``) against
the JAX package's ``data/images``.

The first classes are the JAX package's own image-pipeline tests, run on
the port: the schema round trip, golden decode, the native libjpeg core
against PIL, seed-deterministic augmentation across epochs and resume
under both backends, the decode pool (no leaked thread, metrics through
``utils/logging.Metrics``) and the packer CLI. The native cases skip
where the core does not build (no ``g++`` or no ``jpeglib.h``).

``TestParity`` holds the port to the reference on one module-scoped set of
shards: example bytes and packed shards byte for byte, ``ImageDataset``
batches bit for bit under ``pil`` and ``native``, in train and eval mode,
at epochs 0 and 1 and resumed at batch 3, the decoded counters, and the
error types and texts; a subprocess without PIL and with
``TFK8S_PURE_PY=1`` imports the package and its first decode raises
``ImageDecodeError`` naming Pillow. ``TestSanitizerPlumbing`` holds the
toolchain-free half of the ``TFK8S_NATIVE_SANITIZE`` wiring.
"""

import ctypes.util
import json
import logging
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from tfk8s_tpu_torch.data.images import (
    ImageDataset,
    ImageDecodeError,
    ImageSchemaError,
    decode_image,
    decode_image_example,
    encode_image_example,
    encode_jpeg,
    encode_png,
    eval_transform,
    image_backend,
    image_size,
    set_metrics,
    train_transform,
    write_image_shards,
)
from tfk8s_tpu.data.images import ImageDataset as RefImageDataset
from tfk8s_tpu.data.images import encode_image_example as ref_encode
from tfk8s_tpu.data.images import pack as ref_pack
from tfk8s_tpu.data.images import pipeline as ref_pipeline
from tfk8s_tpu_torch.data import _native
from tfk8s_tpu_torch.data.images import _native_decode, pack, schema
from tfk8s_tpu_torch.data.images import pipeline as port_pipeline
from tfk8s_tpu_torch.data.images.transforms import (
    choose_scale,
    eval_crop_box,
    sample_crop,
    train_crop_params,
)
from tfk8s_tpu_torch.utils.logging import Metrics
import _torch_threads  # noqa: F401  (torch's threads under xdist)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

needs_native = pytest.mark.skipif(
    _native_decode.load() is None,
    reason="native image core unavailable (no g++ or no jpeglib.h) — "
    "PIL paths still covered",
)


def _checker(h=24, w=32, seed=7):
    """A deterministic RGB test card: per-pixel ramps + a checkerboard,
    so crops/flips are position-sensitive."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    arr = np.stack(
        [
            (x * 255 // max(w - 1, 1)),
            (y * 255 // max(h - 1, 1)),
            ((x + y) % 2) * 255,
        ],
        axis=-1,
    ).astype(np.uint8)
    arr ^= rng.integers(0, 8, size=arr.shape, dtype=np.uint8)
    return arr


class TestSchema:
    def test_roundtrip_jpeg(self):
        raw = encode_jpeg(_checker(), quality=95)
        rec = encode_image_example(raw, label=3, shape=(24, 32, 3))
        ex = decode_image_example(rec)
        assert ex.encoded == raw
        assert (ex.label, ex.format) == (3, "jpeg")
        assert (ex.height, ex.width, ex.channels) == (24, 32, 3)

    def test_format_sniffed_from_magic(self):
        assert schema.sniff_format(encode_png(_checker())) == "png"
        assert schema.sniff_format(encode_jpeg(_checker())) == "jpeg"
        ex = decode_image_example(encode_image_example(encode_png(_checker()), 0))
        assert ex.format == "png"

    def test_garbage_bytes_rejected_at_pack_time(self):
        with pytest.raises(ImageSchemaError, match="container"):
            encode_image_example(b"not an image at all", label=0)

    def test_wrong_schema_record_named(self):
        from tfk8s_tpu_torch.data import example as codec

        rec = codec.encode({"input": np.arange(8, dtype=np.int32)})
        with pytest.raises(ImageSchemaError, match="corpus"):
            decode_image_example(rec)

    def test_shard_writer_atomic(self, tmp_path):
        def records():
            yield encode_image_example(encode_png(_checker()), 0)
            raise RuntimeError("packing died mid-stream")

        with pytest.raises(RuntimeError):
            write_image_shards(records(), str(tmp_path), 1)
        assert list(tmp_path.iterdir()) == []  # no partial shards left

    def test_shard_writer_rejects_underfilled_shards(self, tmp_path):
        recs = [encode_image_example(encode_png(_checker()), 0)]
        with pytest.raises(ValueError, match="at least one record"):
            write_image_shards(iter(recs), str(tmp_path), 4)


class TestDecode:
    def test_golden_png_pins_exact_pixels(self):
        """PNG is lossless: encode -> decode must reproduce the array
        bit-for-bit (the pinned-pixel golden the augmentations build on)."""
        src = _checker()
        out = decode_image(encode_png(src))
        assert out.dtype == np.uint8 and out.shape == (24, 32, 3)
        np.testing.assert_array_equal(out, src)

    def test_jpeg_decodes_close_to_source(self):
        # smooth gradients (no checkerboard): JPEG is lossy but bounded
        # on low-frequency content
        y, x = np.mgrid[0:24, 0:32]
        src = np.stack(
            [x * 8, y * 10, (x + y) * 4], axis=-1
        ).astype(np.uint8)
        out = decode_image(encode_jpeg(src, quality=95))
        assert out.shape == (24, 32, 3)
        assert float(np.mean(np.abs(out.astype(int) - src.astype(int)))) < 8

    def test_undecodable_bytes_raise_typed_error(self):
        with pytest.raises(ImageDecodeError):
            decode_image(b"\xff\xd8\xffgarbage-after-jpeg-magic")

    def test_image_size_prefers_stamped_geometry(self):
        """A caller that already decoded the Example hands over the
        header-stamped geometry — no second header parse on the hot
        path (the bytes are not even looked at)."""
        assert image_size(b"not parsed at all", stamped=(24, 32, 3)) == (
            24, 32, 3,
        )
        # unstamped (-1) falls back to the real header parse
        raw = encode_png(_checker())
        assert image_size(raw, stamped=(-1, -1, -1)) == (24, 32, 3)
        assert image_size(raw) == (24, 32, 3)


class TestNativeBackend:
    """The libjpeg core (native/imagecore.cc) against the PIL reference:
    every capability keeps both paths and they must agree — exact pixels
    where the container is lossless-through-PIL, bounded tolerance for
    JPEG (IDCT implementations legitimately differ)."""

    def test_backend_resolution_env(self, monkeypatch):
        monkeypatch.setenv("TFK8S_IMAGE_BACKEND", "pil")
        assert image_backend() == "pil"
        monkeypatch.setenv("TFK8S_IMAGE_BACKEND", "bogus")
        with pytest.raises(ValueError, match="bogus"):
            image_backend()

    def test_pure_py_forces_pil_everywhere(self, monkeypatch, shards):
        """TFK8S_PURE_PY=1 is the single switch disabling ALL native
        codepaths — the new image decoder included, whatever the
        backend request says."""
        monkeypatch.setenv("TFK8S_PURE_PY", "1")
        monkeypatch.setenv("TFK8S_IMAGE_BACKEND", "native")
        assert _native_decode.load() is None
        assert image_backend() == "pil"
        ds = ImageDataset(
            shards, batch_size=8, image_size=32, backend="native"
        )
        try:
            assert ds.backend == "pil"
            next(iter(ds.batches(0)))
            assert ds.native_decoded == 0
        finally:
            ds.close()

    def test_involuntary_fallback_warns_once_with_cost(self, monkeypatch,
                                                       caplog):
        """Losing the native core without opting out is an
        input-bandwidth regression — ONE loud line names the cost;
        deliberate opt-outs stay quiet."""
        import logging

        monkeypatch.setattr(_native_decode, "_tried", True)
        monkeypatch.setattr(_native_decode, "_lib", None)
        monkeypatch.setattr(_native_decode, "_fallback_warned", False)
        with caplog.at_level(logging.WARNING, "tfk8s.data.images.native"):
            monkeypatch.setenv("TFK8S_IMAGE_BACKEND", "pil")
            assert image_backend() == "pil"  # deliberate: quiet
            monkeypatch.setenv("TFK8S_PURE_PY", "1")
            monkeypatch.setenv("TFK8S_IMAGE_BACKEND", "auto")
            assert image_backend() == "pil"  # deliberate: quiet
            assert caplog.records == []
            monkeypatch.delenv("TFK8S_PURE_PY")
            assert image_backend() == "pil"  # involuntary: loud, once
            assert image_backend() == "pil"
        assert len(caplog.records) == 1
        assert "slower" in caplog.records[0].getMessage()

    @needs_native
    def test_png_through_native_backend_pins_exact_pixels(self, monkeypatch):
        """The native core serves JPEG only; PNG falls through to PIL
        even under the native backend — bit-exact with the golden."""
        monkeypatch.setenv("TFK8S_IMAGE_BACKEND", "native")
        src = _checker()
        np.testing.assert_array_equal(decode_image(encode_png(src)), src)

    @needs_native
    def test_jpeg_native_vs_pil_bounded(self):
        """Same JPEG through both decoders: tolerance, not equality —
        the IDCTs may legitimately differ by a level or two."""
        y, x = np.mgrid[0:48, 0:64]
        src = np.stack([x * 4, y * 5, (x + y) * 3], axis=-1).astype(np.uint8)
        enc = encode_jpeg(src, quality=95)
        nat = _native_decode.decode_jpeg(enc)
        assert nat is not None and nat.shape == (48, 64, 3)
        from tfk8s_tpu_torch.data.images.decode import open_image

        pil = np.asarray(open_image(enc), np.uint8)
        assert float(
            np.mean(np.abs(nat.astype(int) - pil.astype(int)))
        ) < 2.0
        assert int(np.max(np.abs(nat.astype(int) - pil.astype(int)))) <= 8

    @needs_native
    def test_native_rejects_garbage_returns_none(self):
        assert _native_decode.decode_jpeg(b"\xff\xd8\xffnope") is None
        assert _native_decode.jpeg_info(b"\xff\xd8\xffnope") is None

    @needs_native
    def test_scaled_decode_dims_match_libjpeg(self):
        """img_decode_scaled at scale_num/8 produces exactly
        ceil(dim * scale_num / 8) per side — the dim contract
        choose_scale and the scratch sizing rely on."""
        y, x = np.mgrid[0:57, 0:91]  # deliberately non-multiple-of-8
        src = np.stack([x, y, x + y], axis=-1).astype(np.uint8)
        enc = encode_jpeg(src, quality=90)
        for s in (1, 2, 4, 8):
            out = _native_decode.decode_jpeg_scaled(enc, s)
            assert out is not None
            assert out.shape == (
                _native_decode.scaled_dim(57, s),
                _native_decode.scaled_dim(91, s),
                3,
            )

    def test_choose_scale_always_covers_crop(self):
        """The ≥-covers-crop property: whatever the crop/target
        geometry, the chosen scale's decoded crop is never smaller than
        the resize target unless even the FULL-scale crop is (upscale
        case, where only scale 8 is acceptable)."""
        rng = np.random.default_rng(7)
        for _ in range(500):
            h = int(rng.integers(8, 4096))
            w = int(rng.integers(8, 4096))
            target = int(rng.integers(8, 512))
            s = choose_scale(h, w, target)
            assert s in (1, 2, 4, 8)
            if h >= target and w >= target:
                # covers: scaled crop >= target on both sides
                assert (h * s) // 8 >= target and (w * s) // 8 >= target
            else:
                assert s == 8  # can't cover at any scale: decode full
            if s > 1:
                # and it is the LARGEST covering downscale among the
                # SIMD set — the next cheaper one would undershoot
                prev = {2: 1, 4: 2, 8: 4}[s]
                assert (h * prev) // 8 < target or (w * prev) // 8 < target

    def test_crop_params_are_backend_independent(self):
        """The seeded draw consumes geometry only — identical box and
        flip from the stamped header whichever backend decodes."""
        a = train_crop_params(np.random.default_rng(3), 375, 500, 0.08)
        b = train_crop_params(np.random.default_rng(3), 375, 500, 0.08)
        assert a == b
        top, left, ch, cw = eval_crop_box(375, 500, 224)
        assert 0 <= top and top + ch <= 375
        assert 0 <= left and left + cw <= 500
        assert ch == cw  # eval view is a centered square

    @needs_native
    def test_dataset_backends_agree(self, shards):
        """Same shard set, same seed, both backends: identical labels
        (crop params are backend-independent) and pixel streams within
        JPEG-decode tolerance."""
        for train in (True, False):
            a = ImageDataset(shards, batch_size=8, image_size=32, seed=5,
                             train=train, workers=1, backend="pil")
            b = ImageDataset(shards, batch_size=8, image_size=32, seed=5,
                             train=train, workers=1, backend="native")
            try:
                ba = next(iter(a.batches(0)))
                bb = next(iter(b.batches(0)))
                np.testing.assert_array_equal(ba["label"], bb["label"])
                assert bb["image"].shape == ba["image"].shape
                # normalized units; 0.1 is the alarm line — a plain
                # 2-tap resample (not support-scaled like PIL's) fails it
                assert float(
                    np.mean(np.abs(ba["image"] - bb["image"]))
                ) < 0.1
                assert b.native_decoded == b.images_decoded
            finally:
                a.close()
                b.close()

    @needs_native
    def test_resume_replays_identically_under_native(self, shards):
        """iterator(start_batch=k) equals batch k of an uninterrupted
        run under the NATIVE backend too — the per-(seed, epoch,
        record) rng contract survives the backend switch."""
        ds = ImageDataset(shards, batch_size=8, image_size=32, seed=11,
                          workers=1, backend="native")
        it = ds.iterator(prefetch=0)
        want = [next(it) for _ in range(5)]
        res = ImageDataset(shards, batch_size=8, image_size=32, seed=11,
                           workers=1, backend="native")
        rit = res.iterator(prefetch=0, start_batch=3)
        try:
            for k in (3, 4):
                got = next(rit)
                np.testing.assert_array_equal(want[k]["image"], got["image"])
                np.testing.assert_array_equal(want[k]["label"], got["label"])
        finally:
            it.close()
            rit.close()
            ds.close()
            res.close()

    @needs_native
    def test_native_pool_shutdown_leaks_no_threads(self, shards):
        ds = ImageDataset(shards, batch_size=16, image_size=32, seed=0,
                          workers=4, backend="native")
        next(iter(ds.batches(0)))  # spin the pool up
        assert ds.native_decoded > 0  # the native path actually ran
        assert any(
            t.name.startswith("img-decode") for t in threading.enumerate()
        )
        ds.close()
        assert not any(
            t.name.startswith("img-decode") for t in threading.enumerate()
        ), [t.name for t in threading.enumerate()]

    def test_lying_stamp_raises_typed_error(self, tmp_path):
        """A record whose stamped geometry disagrees with the real frame
        must surface as ImageDecodeError with the record context UNDER
        EITHER BACKEND — the crop contract is stamp-drawn, so a lying
        stamp that trained silently under pil but raised under native
        would break backend interchangeability (and the PIL box error
        would otherwise escape unwrapped)."""
        raw = encode_jpeg(_checker())
        backends = ["pil"] + (
            ["native"] if _native_decode.load() is not None else []
        )
        # both directions lie: overstating overflows the real frame,
        # UNDERSTATING would silently mis-position every crop (the box
        # fits inside the larger real frame) — both must raise
        for lie in ((480, 640, 3), (12, 16, 3)):
            rec = encode_image_example(raw, label=1, shape=lie)
            p = str(tmp_path / f"lies-{lie[0]}")
            paths = write_image_shards([rec for _ in range(8)], p, 1)
            for backend in backends:
                ds = ImageDataset(paths, batch_size=8, image_size=8,
                                  seed=0, workers=1, backend=backend)
                try:
                    with pytest.raises(ImageDecodeError, match="disagrees"):
                        next(iter(ds.batches(0)))
                finally:
                    ds.close()

    def test_binder_rejects_wrong_dst(self):
        """The fused entrypoint validates the pointer handoff — a
        strided or wrong-dtype destination is an error, not silent
        pixel corruption."""
        if _native_decode.load() is None:
            pytest.skip("native image core unavailable")
        s = np.asarray([1, 1, 1], np.float32)
        b = np.zeros(3, np.float32)
        enc = encode_jpeg(_checker())
        bad = np.empty((8, 8, 3), np.float64)
        with pytest.raises(ValueError, match="float32"):
            _native_decode.decode_rrc_into(
                enc, (0, 0, 16, 16), 8, False, 8, s, b, bad, (24, 32)
            )
        strided = np.empty((8, 16, 3), np.float32)[:, ::2]
        with pytest.raises(ValueError, match="contiguous"):
            _native_decode.decode_rrc_into(
                enc, (0, 0, 16, 16), 8, False, 8, s, b, strided, (24, 32)
            )

    @needs_native
    def test_scaled_decode_off_still_agrees(self, shards):
        """TFK8S_IMAGE_SCALED_DECODE=0 pins full-scale IDCT; output
        stays within tolerance of the scaled path (same crop, same
        resample — only the decode resolution differs)."""
        # target 8 on 40px sources: typical crops choose scale 4/8, so
        # the pair really compares scaled vs full-scale IDCT
        a = ImageDataset(shards, batch_size=8, image_size=8, seed=2,
                         workers=1, backend="native", scaled_decode=True)
        b = ImageDataset(shards, batch_size=8, image_size=8, seed=2,
                         workers=1, backend="native", scaled_decode=False)
        try:
            ba = next(iter(a.batches(0)))
            bb = next(iter(b.batches(0)))
            np.testing.assert_array_equal(ba["label"], bb["label"])
            assert float(np.mean(np.abs(ba["image"] - bb["image"]))) < 0.3
        finally:
            a.close()
            b.close()


class TestTransforms:
    def test_train_transform_seed_deterministic(self):
        src = _checker(64, 48)
        a = train_transform(src, np.random.default_rng(5), 32)
        b = train_transform(src, np.random.default_rng(5), 32)
        np.testing.assert_array_equal(a, b)
        c = train_transform(src, np.random.default_rng(6), 32)
        assert not np.array_equal(a, c)
        assert a.shape == (32, 32, 3) and a.dtype == np.float32

    def test_eval_transform_deterministic_and_centered(self):
        src = _checker(100, 80)
        a = eval_transform(src, 32)
        np.testing.assert_array_equal(a, eval_transform(src, 32))
        assert a.shape == (32, 32, 3) and a.dtype == np.float32

    def test_sample_crop_within_bounds(self):
        rng = np.random.default_rng(0)
        for _ in range(200):
            top, left, h, w = sample_crop(rng, 37, 53)
            assert 0 <= top and top + h <= 37
            assert 0 <= left and left + w <= 53
            assert h > 0 and w > 0

    def test_normalize_statistics(self):
        from tfk8s_tpu_torch.data.images.transforms import normalize

        flat = np.full((4, 4, 3), 128, np.uint8)
        out = normalize(flat)
        # (128/255 - mean) / std, per channel
        want = (128 / 255 - np.array([0.485, 0.456, 0.406])) / np.array(
            [0.229, 0.224, 0.225]
        )
        np.testing.assert_allclose(out[0, 0], want.astype(np.float32), rtol=1e-5)


@pytest.fixture()
def shards(tmp_path):
    return pack.pack_synthetic(
        str(tmp_path / "sh"), 48, classes=4, image_size=40, num_shards=2,
        seed=9,
    )


class TestImageDataset:
    def test_batches_match_vision_schema(self, shards):
        ds = ImageDataset(shards, batch_size=8, image_size=32, seed=1)
        try:
            b = next(iter(ds.batches(0)))
            assert b["image"].shape == (8, 32, 32, 3)
            assert b["image"].dtype == np.float32
            assert b["label"].shape == (8,) and b["label"].dtype == np.int32
            assert set(int(x) for x in b["label"]) <= set(range(4))
        finally:
            ds.close()

    def test_augmentation_deterministic_across_instances(self, shards):
        a = ImageDataset(shards, batch_size=8, image_size=32, seed=3)
        b = ImageDataset(shards, batch_size=8, image_size=32, seed=3)
        try:
            for ba, bb, _ in zip(a.batches(0), b.batches(0), range(3)):
                np.testing.assert_array_equal(ba["image"], bb["image"])
                np.testing.assert_array_equal(ba["label"], bb["label"])
        finally:
            a.close()
            b.close()

    def test_epochs_reaugment(self, shards):
        """Same records, new epoch -> different crops/flips (the seed
        folds the epoch), while re-running the SAME epoch reproduces it."""
        ds = ImageDataset(shards, batch_size=48, image_size=32, seed=3,
                          shuffle=False)
        try:
            e0 = next(iter(ds.batches(0)))["image"]
            e0_again = next(iter(ds.batches(0)))["image"]
            e1 = next(iter(ds.batches(1)))["image"]
            np.testing.assert_array_equal(e0, e0_again)
            assert not np.array_equal(e0, e1)
        finally:
            ds.close()

    def test_resume_replays_identical_stream(self, shards):
        """iterator(start_batch=k) must equal batch k of an uninterrupted
        run — augmentation AND shuffle both replay (checkpoint-resume
        determinism, the tentpole's resume requirement)."""
        ds = ImageDataset(shards, batch_size=8, image_size=32, seed=11)
        it = ds.iterator(prefetch=0)
        want = [next(it) for _ in range(5)]
        res = ImageDataset(shards, batch_size=8, image_size=32, seed=11)
        rit = res.iterator(prefetch=0, start_batch=3)
        try:
            for k in (3, 4):
                got = next(rit)
                np.testing.assert_array_equal(want[k]["image"], got["image"])
                np.testing.assert_array_equal(want[k]["label"], got["label"])
        finally:
            it.close()
            rit.close()
            ds.close()
            res.close()

    def test_eval_mode_unshuffled_and_stable(self, shards):
        ds = ImageDataset(shards, batch_size=8, image_size=32, train=False)
        try:
            assert ds.shuffle is False
            a = next(iter(ds.batches(0)))["image"]
            b = next(iter(ds.batches(0)))["image"]
            np.testing.assert_array_equal(a, b)
        finally:
            ds.close()

    def test_pool_shutdown_leaks_no_threads(self, shards):
        ds = ImageDataset(shards, batch_size=16, image_size=32, seed=0,
                          workers=4)
        next(iter(ds.batches(0)))  # spin the pool up
        assert any(
            t.name.startswith("img-decode") for t in threading.enumerate()
        )
        ds.close()
        assert not any(
            t.name.startswith("img-decode") for t in threading.enumerate()
        ), [t.name for t in threading.enumerate()]

    def test_metrics_exported_through_obs_registry(self, shards):
        reg = Metrics()
        set_metrics(reg)
        try:
            ds = ImageDataset(shards, batch_size=8, image_size=32, seed=0)
            it = ds.iterator(prefetch=2)
            for _ in range(3):
                next(it)
            it.close()
            ds.close()
            snap = reg.snapshot()
            decoded = reg.get_counter(
                "tfk8s_images_decoded_total",
                {"mode": "train", "backend": ds.backend},
            )
            assert decoded is not None and decoded >= 24, snap["counters"]
            assert any(
                k.startswith("tfk8s_image_decode_seconds")
                for k in snap["histograms"]
            ), snap["histograms"]
            # the queue gauge is mode-labeled (a concurrent evaluator
            # owns its own series instead of clobbering this one)
            assert any(
                k.startswith("tfk8s_image_decode_queue_depth")
                and 'mode="train"' in k
                for k in snap["gauges"]
            ), snap["gauges"]
            text = reg.prometheus_text()
            assert "tfk8s_images_decoded_total" in text
        finally:
            set_metrics(None)

    def test_corpus_shard_fails_with_schema_message(self, tmp_path):
        from tfk8s_tpu_torch.data.recordio import RecordWriter
        from tfk8s_tpu_torch.data import example as codec

        p = str(tmp_path / "text.rio")
        with RecordWriter(p) as w:
            for _ in range(4):
                w.write(codec.encode({"input": np.arange(8, dtype=np.int32)}))
        ds = ImageDataset([p], batch_size=2, image_size=32)
        try:
            with pytest.raises(ImageDecodeError, match="corpus"):
                next(iter(ds.batches(0)))
        finally:
            ds.close()


class TestPackCLI:
    def test_synthetic_pack_writes_shards_and_labels(self, tmp_path):
        out = tmp_path / "packed"
        pack.main([
            "--synthetic", "24", "--classes", "3", "--image-size", "32",
            "--out-dir", str(out), "--num-shards", "2", "--seed", "5",
        ])
        shards = sorted(os.listdir(out))
        assert shards == ["images-00000.rio", "images-00001.rio", "labels.json"]
        labels = json.loads((out / "labels.json").read_text())
        assert labels == {"class000": 0, "class001": 1, "class002": 2}
        ds = ImageDataset(
            [str(out / s) for s in shards if s.endswith(".rio")],
            batch_size=8, image_size=32,
        )
        try:
            assert len(ds) == 24
            next(iter(ds.batches(0)))
        finally:
            ds.close()

    def test_tree_pack_imagenet_layout(self, tmp_path):
        root = tmp_path / "tree"
        for ci, cls in enumerate(["ant", "bee"]):
            d = root / cls
            d.mkdir(parents=True)
            for i in range(3):
                (d / f"im{i}.jpg").write_bytes(
                    encode_jpeg(_checker(seed=ci * 10 + i))
                )
            # non-image clutter must be skipped, not packed
            (d / "notes.txt").write_text("skip me")
        paths, n = pack.pack_tree(str(root), str(tmp_path / "out"), 2)
        assert n == 6
        labels = json.loads((tmp_path / "out" / "labels.json").read_text())
        assert labels == {"ant": 0, "bee": 1}
        got = sorted(
            decode_image_example(r).label
            for p in paths
            for r in __import__(
                "tfk8s_tpu_torch.data.recordio", fromlist=["RecordFile"]
            ).RecordFile(p)
        )
        assert got == [0, 0, 0, 1, 1, 1]


class TestTrainerGeometry:
    def test_non_vision_task_rejected_loudly(self):
        from tfk8s_tpu_torch.runtime.train import _image_geometry

        with pytest.raises(ValueError, match="image"):
            _image_geometry({"input": np.zeros((1, 16), np.int32)})

    def test_vision_task_size_read_off_batch(self):
        from tfk8s_tpu_torch.runtime.train import _image_geometry

        assert _image_geometry(
            {"image": np.zeros((1, 40, 40, 3), np.float32),
             "label": np.zeros((1,), np.int32)}
        ) == 40


# -- parity with the JAX package's data/images -------------------------------

BACKENDS = ["pil", "native"]


def _backend(backend):
    if backend == "native" and _native_decode.load() is None:
        pytest.skip("native image core unavailable (no g++ or no jpeglib.h)")
    return backend


@pytest.fixture(scope="module")
def parity_shards(tmp_path_factory):
    """The port's and the reference's packed shards of one synthetic set
    (96 JPEGs of 40 px, 4 classes, 2 shards, seed 9)."""
    d = tmp_path_factory.mktemp("parity")
    port = pack.pack_synthetic(str(d / "port"), 96, classes=4, image_size=40, num_shards=2,
                               seed=9)
    ref = ref_pack.pack_synthetic(str(d / "ref"), 96, classes=4, image_size=40, num_shards=2,
                                  seed=9)
    return port, ref


def _pair(files, **kw):
    """The port's and the reference's ImageDataset on the same files."""
    return ImageDataset(files, **kw), RefImageDataset(files, **kw)


def _assert_batches_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


class TestParity:
    def test_example_bytes_equal_the_reference(self):
        for raw, shape in ((encode_jpeg(_checker(), quality=90), (24, 32, 3)),
                           (encode_png(_checker(40, 30)), None)):
            assert encode_image_example(raw, 5, shape=shape) == ref_encode(raw, 5, shape=shape)
        jpeg = encode_jpeg(_checker(), quality=90)
        assert encode_image_example(jpeg, 1, fmt="jpeg") == ref_encode(jpeg, 1, fmt="jpeg")

    def test_packed_shards_and_labels_byte_identical(self, parity_shards):
        port, ref = parity_shards
        assert [os.path.basename(p) for p in port] == [os.path.basename(p) for p in ref]
        for a, b in zip(port, ref):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), a
        labels = [os.path.join(os.path.dirname(p[0]), "labels.json") for p in (port, ref)]
        assert json.load(open(labels[0])) == json.load(open(labels[1]))

    @pytest.mark.parametrize("backend", BACKENDS)
    @pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
    def test_batches_bit_for_bit(self, parity_shards, backend, train):
        """Epochs 0 and 1 (two batches each), then a resume at batch 3
        against an uninterrupted iterator's batch 3 and 4, each batch equal
        to the reference's; the decoded counters of both registries agree."""
        files = parity_shards[0]
        kw = dict(batch_size=16, image_size=24, seed=5, train=train, workers=2,
                  backend=_backend(backend))
        regs = (Metrics(), Metrics())
        port_pipeline.set_metrics(regs[0])
        ref_pipeline.set_metrics(regs[1])
        port, ref = _pair(files, **kw)
        try:
            assert port.backend == ref.backend == backend
            for epoch in (0, 1):
                gens = port.batches(epoch), ref.batches(epoch)
                for _ in range(2):
                    _assert_batches_equal(next(gens[0]), next(gens[1]))
            assert port.images_decoded == ref.images_decoded == 64
            assert port.native_decoded == ref.native_decoded
            assert (port.native_decoded == 64) == (backend == "native")
            mode = "train" if train else "eval"
            counts = [r.get_counter("tfk8s_images_decoded_total",
                                    {"mode": mode, "backend": backend}) for r in regs]
            assert counts[0] == counts[1] == 64.0
        finally:
            port_pipeline.set_metrics(None)
            ref_pipeline.set_metrics(None)
            port.close()
            ref.close()
        port, ref = _pair(files, **kw)
        its = [port.iterator(prefetch=0, start_batch=3), ref.iterator(prefetch=0, start_batch=3)]
        whole = port.iterator(prefetch=0)
        try:
            uninterrupted = [next(whole) for _ in range(5)]
            for k in (3, 4):
                got, want = next(its[0]), next(its[1])
                _assert_batches_equal(got, want)
                _assert_batches_equal(got, uninterrupted[k])
        finally:
            for it in its + [whole]:
                it.close()
            port.close()
            ref.close()

    def _errors(self, files, backend):
        """The (type name, text) each package's first batch raises."""
        out = []
        for ds in _pair(files, batch_size=4, image_size=8, seed=0, workers=1,
                        backend=_backend(backend)):
            try:
                with pytest.raises(Exception) as info:
                    next(iter(ds.batches(0)))
            finally:
                ds.close()
            out.append((type(info.value).__name__, str(info.value)))
        return out

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_error_types_and_texts_equal_the_reference(self, tmp_path, backend):
        from tfk8s_tpu_torch.data import example as codec

        cases = {
            # jpeg magic, then garbage: the decoder names the corruption
            "garbage": [encode_image_example(b"\xff\xd8\xffgarbage-after-jpeg-magic", 1)] * 4,
            # a text shard fed as images: the schema error, wrapped
            "wrong_schema": [codec.encode({"input": np.arange(8, dtype=np.int32)})] * 4,
            # a stamp that overstates the frame
            "lying_stamp": [encode_image_example(encode_jpeg(_checker()), 1,
                                                 shape=(480, 640, 3))] * 4,
        }
        for name, recs in cases.items():
            files = write_image_shards(iter(recs), str(tmp_path / name), 1)
            (port_type, port_text), (ref_type, ref_text) = self._errors(files, backend)
            assert port_type == ref_type == "ImageDecodeError", name
            assert port_text == ref_text, name

    def test_package_imports_without_pil_and_decode_names_pillow(self, parity_shards):
        """The card host's case: no PIL and no native core (``TFK8S_PURE_PY=1``).
        The package imports, the backend resolves to PIL, and the first
        batch raises ImageDecodeError naming Pillow."""
        code = r"""
import importlib.abc, sys

class NoPil(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no PIL here")
        return None

sys.meta_path.insert(0, NoPil())
from tfk8s_tpu_torch.data import images
from tfk8s_tpu_torch.data.images import ImageDataset, ImageDecodeError, image_backend

assert image_backend() == "pil"
ds = ImageDataset(sys.argv[1:], batch_size=4, image_size=8, workers=1)
try:
    next(iter(ds.batches(0)))
except ImageDecodeError as exc:
    print("RAISED " + str(exc))
finally:
    ds.close()
assert "PIL" not in sys.modules
"""
        env = dict(os.environ, TFK8S_PURE_PY="1", PYTHONPATH=REPO)
        proc = subprocess.run([sys.executable, "-c", code, *parity_shards[0]], cwd=REPO,
                              env=env, capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        assert "RAISED " in proc.stdout and "Pillow" in proc.stdout, proc.stdout


# -- TFK8S_NATIVE_SANITIZE plumbing (toolchain-free) --------------------------


class TestSanitizerPlumbing:
    def test_sanitize_mode_parses_known_values(self, monkeypatch):
        monkeypatch.delenv("TFK8S_NATIVE_SANITIZE", raising=False)
        assert _native.sanitize_mode() is None
        monkeypatch.setenv("TFK8S_NATIVE_SANITIZE", "asan")
        assert _native.sanitize_mode() == "asan"
        monkeypatch.setenv("TFK8S_NATIVE_SANITIZE", " UBSAN ")
        assert _native.sanitize_mode() == "ubsan"

    def test_sanitize_mode_unknown_value_warns_and_builds_plain(self, monkeypatch, caplog):
        monkeypatch.setenv("TFK8S_NATIVE_SANITIZE", "msan")
        with caplog.at_level(logging.WARNING, logger="tfk8s.data.native"):
            assert _native.sanitize_mode() is None
        assert "TFK8S_NATIVE_SANITIZE" in caplog.text

    def test_dlopen_checked_downgrades_oserror_to_fallback(self, tmp_path, caplog):
        bogus = tmp_path / "broken.so"
        bogus.write_bytes(b"\x7fNOT-AN-ELF")
        with caplog.at_level(logging.WARNING, logger="tfk8s.data.native"):
            lib = _native.dlopen_checked(str(bogus), logging.getLogger("tfk8s.data.native"),
                                         "test core", "the pure fallback")
        assert lib is None
        assert "failed to load" in caplog.text

    def test_dlopen_checked_loads_a_real_library(self):
        name = ctypes.util.find_library("c")
        if name is None:
            pytest.skip("no libc found to load")
        assert _native.dlopen_checked(name, logging.getLogger("tfk8s.data.native"), "libc",
                                      "n/a") is not None

    def test_sanitized_build_uses_its_own_cache_name(self, tmp_path, monkeypatch):
        """Both cores go through ``build_cached``: a sanitized build lands
        beside the plain one under a name of its own (a stubbed compiler
        stands in for g++, so no toolchain is needed)."""
        made = []

        def fake_run(cmd, **kw):
            made.append(cmd)
            with open(cmd[cmd.index("-o") + 1], "wb") as f:
                f.write(b"so")

        monkeypatch.setattr(_native.subprocess, "run", fake_run)
        monkeypatch.setenv("TFK8S_NATIVE_CACHE", str(tmp_path))
        log = logging.getLogger("tfk8s.data.native")
        monkeypatch.delenv("TFK8S_NATIVE_SANITIZE", raising=False)
        plain = _native.build_cached(_native_decode._SRC, "imagecore", log, "t", "t",
                                     extra_flags=("-ljpeg",))
        monkeypatch.setenv("TFK8S_NATIVE_SANITIZE", "ubsan")
        sanitized = _native.build_cached(_native_decode._SRC, "imagecore", log, "t", "t",
                                         extra_flags=("-ljpeg",))
        assert plain != sanitized
        assert os.path.basename(sanitized).startswith("imagecore-ubsan-")
        assert os.path.exists(plain) and os.path.exists(sanitized)
        assert "-fsanitize=undefined" in made[1] and "-ljpeg" in made[1]
        assert not any(f.startswith("-fsanitize") for f in made[0])
