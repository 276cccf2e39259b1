"""The port's record-file input against the JAX package's.

Record I/O (``tfk8s_tpu_torch.data``): crc32c, the framing both ways
byte for byte, the example codec, corruption on both backends, and
``RecordDataset`` batches equal to the reference's for the same files,
seed, host index and host count. Then the trainer's input modes against
the reference ``Trainer`` on one process, from the same bridged tiny f32
GPT: ``files`` (batches exact, losses rtol 1e-4, with and without
gradient accumulation; a resume equals the uninterrupted run; a schema
mismatch fails loudly) and ``per_host`` with two input shards.
"""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfk8s_tpu.data import RecordDataset as JRecordDataset
from tfk8s_tpu.data import RecordFile as JRecordFile
from tfk8s_tpu.data import RecordWriter as JRecordWriter
from tfk8s_tpu.data import encode as jencode
from tfk8s_tpu.data import shard_files as jshard_files
from tfk8s_tpu.models import gpt as jgpt
from tfk8s_tpu.parallel.mesh import make_mesh
from tfk8s_tpu.runtime import train as jtrain
from tfk8s_tpu_torch import bridge
from tfk8s_tpu_torch.data import _native, example, recordio
from tfk8s_tpu_torch.data.dataset import RecordDataset
from tfk8s_tpu_torch.data.recordio import RecordFile, RecordIOError, RecordWriter, crc32c, shard_files
from tfk8s_tpu_torch.models import gpt as tgpt
from tfk8s_tpu_torch.models.bert import make_chain_tokens
from tfk8s_tpu_torch.ops import flash_attention as tfa
from tfk8s_tpu_torch.runtime import train as ttrain

SEQ, BATCH, RTOL = 32, 8, 1e-4


@pytest.fixture(params=["native", "python"])
def backend(request, monkeypatch):
    """Route the port's record I/O through one backend."""
    if request.param == "python":
        monkeypatch.setattr(_native, "_lib", None)
        monkeypatch.setattr(_native, "_tried", True)
    elif _native.load() is None:
        pytest.skip("no native toolchain")
    return request.param


def _records(n=6):
    rng = np.random.default_rng(7)
    return [b"", b"x" * 70000] + [rng.bytes(int(k)) for k in rng.integers(1, 5000, n)]


def test_crc32c_known_vector(backend):
    # the canonical crc32c check value (RFC 3720 B.4)
    assert crc32c(b"123456789") == 0xE3069283
    assert crc32c(b"") == 0


def test_native_core_builds_into_the_build_directory():
    if _native.load() is None:
        pytest.skip("no g++ on this machine")
    lib = _native.load()
    assert os.path.dirname(lib._name) == str(_native.build_dir())
    data = np.random.default_rng(0).bytes(4097)
    assert int(lib.rio_crc32c(data, len(data))) == crc32c(data)


def test_shards_are_byte_identical_both_ways(tmp_path, backend):
    recs = _records()
    port, ref = str(tmp_path / "port.rio"), str(tmp_path / "ref.rio")
    with RecordWriter(port, flush_every=3) as w:
        for r in recs:
            w.write(r)
    with JRecordWriter(ref) as w:
        for r in recs:
            w.write(r)
    assert open(port, "rb").read() == open(ref, "rb").read()
    # each side reads the other's file
    assert JRecordFile(port).read(range(len(recs))) == recs
    rf = RecordFile(ref)
    assert (rf.offsets, rf.lengths) == (JRecordFile(ref).offsets, JRecordFile(ref).lengths)
    assert rf.read(range(len(recs))) == recs
    assert list(rf) == recs


def test_python_and_native_readers_agree(tmp_path, monkeypatch):
    if _native.load() is None:
        pytest.skip("no native toolchain")
    path = str(tmp_path / "b.rio")
    with RecordWriter(path) as w:
        for r in _records():
            w.write(r)
    native = RecordFile(path)
    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setattr(_native, "_tried", True)
    py = RecordFile(path)
    assert (py.offsets, py.lengths) == (native.offsets, native.lengths)
    n = len(py)
    assert py.read(range(n)) == native.read(range(n))


def test_encode_bytes_equal_the_reference():
    ex = {
        "input": np.arange(12, dtype=np.int32).reshape(3, 4),
        "label": np.asarray(7, np.int64),
        "weights": np.random.default_rng(0).standard_normal((2, 2)).astype(np.float32),
        "mask": np.array([True, False]),
    }
    assert example.encode(ex) == jencode(ex)
    out = example.decode(jencode(ex))
    assert out.keys() == ex.keys()
    for k in ex:
        assert out[k].dtype == ex[k].dtype and out[k].shape == ex[k].shape
        np.testing.assert_array_equal(out[k], ex[k])
    with pytest.raises(ValueError, match="bad magic"):
        example.decode(b"nope" + b"\x00" * 10)
    with pytest.raises(ValueError, match="truncat"):
        example.decode(example.encode(ex)[:-5])


def test_corruption_detected(tmp_path, backend):
    path = str(tmp_path / "c.rio")
    with RecordWriter(path) as w:
        for r in (b"alpha", b"bravo", b"charlie"):
            w.write(r)
    rf = RecordFile(path)
    raw = bytearray(open(path, "rb").read())
    raw[rf.offsets[1] + 2] ^= 0xFF  # inside record 1's data
    open(path, "wb").write(bytes(raw))
    with pytest.raises(RecordIOError, match="crc mismatch at record 1"):
        RecordFile(path).read([0, 1, 2])
    unverified = RecordFile(path).read([1], verify=False)[0]
    assert len(unverified) == 5 and unverified != b"bravo"
    raw[8] ^= 0xFF  # record 0's masked length crc
    open(path, "wb").write(bytes(raw))
    with pytest.raises(RecordIOError):
        RecordFile(path)
    with RecordWriter(path) as w:
        w.write(b"alpha")
        w.write(b"bravo")
    full = open(path, "rb").read()
    open(path, "wb").write(full[:-3])
    with pytest.raises(RecordIOError, match="truncat"):
        RecordFile(path)


def test_shard_files_matches_the_reference():
    files = [f"/d/part-{i:03d}" for i in range(10)]
    for n in (1, 3, 4):
        for i in range(n):
            assert shard_files(files, i, n) == jshard_files(files, i, n)
    with pytest.raises(ValueError, match="cannot feed"):
        shard_files(files[:3], 0, 4)
    with pytest.raises(ValueError, match="not in"):
        shard_files(files, 4, 4)


def _write_tagged_shards(tmp_path, n_files, per_file=16, seq=8):
    rng = np.random.default_rng(0)
    files = []
    for fi in range(n_files):
        path = str(tmp_path / f"part-{fi:02d}.rio")
        with RecordWriter(path) as w:
            for ri in range(per_file):
                toks = rng.integers(1, 32, size=(seq,), dtype=np.int32)
                toks[0] = fi * per_file + ri  # provenance tag
                w.write(example.encode({"input": toks}))
        files.append(path)
    return files


@pytest.mark.parametrize("n_files,host,hosts", [
    (4, 0, 1), (4, 0, 2), (4, 1, 2),  # by files
    (1, 0, 2), (3, 2, 4),  # by record striping
])
def test_dataset_batches_equal_the_reference(tmp_path, n_files, host, hosts):
    files = _write_tagged_shards(tmp_path, n_files)
    kw = dict(batch_size=4, host_index=host, num_hosts=hosts, seed=3)
    ds, jds = RecordDataset(files, **kw), JRecordDataset(files, **kw)
    assert ds.shard_by == jds.shard_by == ("files" if n_files >= hosts else "records")
    assert ds.files == jds.files and len(ds) == len(jds)
    assert ds.batches_per_epoch() == jds.batches_per_epoch()
    for epoch, start in ((0, 0), (1, 1)):
        got = [b["input"] for b in ds.batches(epoch, start)]
        want = [b["input"] for b in jds.batches(epoch, start)]
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    # the endless iterators, sync and prefetching, across an epoch edge
    start = ds.batches_per_epoch() - 1
    for prefetch in (0, 2):
        it, jit_ = ds.iterator(prefetch, start_batch=start), jds.iterator(prefetch, start_batch=start)
        for _ in range(3):
            np.testing.assert_array_equal(next(it)["input"], next(jit_)["input"])
        it.close()
        jit_.close()
    fn = ds.as_batch_fn()
    assert fn(None, 4)["input"].shape == (4, 8)
    with pytest.raises(ValueError, match="built for batch_size"):
        fn(None, 16)
    fn.close()


def test_pure_python_fallback_warns_loudly(tmp_path, monkeypatch, caplog):
    path = str(tmp_path / "w.rio")
    with RecordWriter(path) as w:
        w.write(b"payload")
    monkeypatch.setattr(_native, "load", lambda: None)
    monkeypatch.delenv("TFK8S_PURE_PY", raising=False)
    monkeypatch.setattr(recordio, "_fallback_warned", False)
    with caplog.at_level(logging.WARNING, logger="tfk8s.data.recordio"):
        RecordFile(path)
        RecordFile(path)
    assert len([r for r in caplog.records if "pure-Python codec" in r.message]) == 1


def test_failed_native_build_warns_with_stderr(tmp_path, monkeypatch, caplog):
    import subprocess as sp

    def fake_run(cmd, **kw):
        raise sp.CalledProcessError(1, cmd, stderr=b"fatal error: boom")

    monkeypatch.setattr(_native, "_tried", False)
    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setenv("TFK8S_NATIVE_CACHE", str(tmp_path / "fresh"))
    monkeypatch.setattr(_native.subprocess, "run", fake_run)
    with caplog.at_level(logging.WARNING, logger="tfk8s.data.native"):
        assert _native.load() is None
    assert any("boom" in r.message for r in caplog.records)


# -- the trainer's input modes against the reference ---------------------------


def _write_chain_shards(tmp_path, vocab, n_files=2, per_file=32):
    rng = np.random.default_rng(0)
    for fi in range(n_files):
        with RecordWriter(str(tmp_path / f"train-{fi:02d}.rio")) as w:
            for _ in range(per_file):
                toks = make_chain_tokens(rng, 1, SEQ, vocab)[0]
                w.write(example.encode({"input": toks.astype(np.int32)}))
    return str(tmp_path / "train-*.rio")


def _pair(steps=3, **cfg_kw):
    """The reference Trainer on a one-device mesh and the port's, from the
    same bridged initial parameters of the tiny f32 GPT."""
    jtask = jgpt.make_task(jgpt.tiny_config(dtype=jnp.float32), seq_len=SEQ, batch_size=BATCH)
    jtr = jtrain.Trainer(jtask, jtrain.TrainConfig(steps=steps, learning_rate=3e-3, log_every=1,
                                                   **cfg_kw), make_mesh(data=1))
    jstate = jtr.init_state()
    params = jax.tree_util.tree_map(np.asarray, jstate.params)
    tcfg = tgpt.tiny_config(dtype=torch.float32)
    ttask = tgpt.make_task(tcfg, seq_len=SEQ, batch_size=BATCH, attn_fn=tfa.flash_attention)
    ttr = ttrain.Trainer(ttask, ttrain.TrainConfig(steps=steps, learning_rate=3e-3, log_every=1,
                                                   **cfg_kw), torch.device("cpu"))
    tstate = ttr.init_state()
    tstate.model.load_state_dict(bridge.params_to_state_dict(params, tcfg))
    return (jtr, jstate), (ttr, tstate)


@pytest.mark.parametrize("accum", [1, 2])
def test_files_mode_matches_the_reference(tmp_path, accum):
    files = _write_chain_shards(tmp_path, tgpt.tiny_config().vocab_size)
    (jtr, jstate), (ttr, tstate) = _pair(input_files=files, grad_accum_steps=accum, seed=5)
    assert ttr.input_mode() == "files"
    # the record stream, batch for batch
    got, want = ttr._open_input_files(1), jtr._open_input_files(1)
    for _ in range(3):
        np.testing.assert_array_equal(next(got)["input"], next(want)["input"])
    got.close()
    want.close()
    _, jh = jtr.fit(state=jstate)
    _, th = ttr.fit(state=tstate)
    assert [h["step"] for h in th] == [h["step"] for h in jh] == [1, 2, 3]
    np.testing.assert_allclose([h["loss"] for h in th], [h["loss"] for h in jh], rtol=RTOL)
    np.testing.assert_allclose([h["grad_norm"] for h in th], [h["grad_norm"] for h in jh],
                               rtol=RTOL)


def test_files_mode_resume_equals_the_uninterrupted_run(tmp_path):
    files = _write_chain_shards(tmp_path, tgpt.tiny_config().vocab_size)
    env = {"TFK8S_DEVICE": "cpu", "TFK8S_MODEL_PRESET": "tiny", "TFK8S_SEQ_LEN": str(SEQ),
           "TFK8S_BATCH_SIZE": str(BATCH), "TFK8S_LOG_EVERY": "1", "TFK8S_LEARNING_RATE": "3e-3",
           "TFK8S_ATTENTION_IMPL": "flash", "TFK8S_INPUT_FILES": files, "TFK8S_SEED": "5"}
    full = tgpt.train(dict(env, TFK8S_TRAIN_STEPS="6"))
    ckpt = str(tmp_path / "ckpt")
    tgpt.train(dict(env, TFK8S_TRAIN_STEPS="3", TFK8S_CHECKPOINT_DIR=ckpt))
    resumed = tgpt.train(dict(env, TFK8S_TRAIN_STEPS="6", TFK8S_CHECKPOINT_DIR=ckpt,
                              TFK8S_GANG_RESTARTS="1"))
    assert [h["step"] for h in resumed] == [4, 5, 6]
    for h in resumed:
        assert abs(h["loss"] - full[h["step"] - 1]["loss"]) < 1e-6, (h, full)


def test_files_mode_schema_mismatch_fails_loudly(tmp_path):
    path = str(tmp_path / "bad.rio")
    task = tgpt.make_task(tgpt.tiny_config(), seq_len=SEQ, batch_size=BATCH)
    for rec, match in (({"input": np.zeros((16,), np.int32)}, "record example mismatch"),
                       ({"tokens": np.zeros((SEQ,), np.int32)}, "record schema")):
        with RecordWriter(path) as w:
            for _ in range(16):
                w.write(example.encode(rec))
        trainer = ttrain.Trainer(task, ttrain.TrainConfig(steps=2, input_files=path),
                                 torch.device("cpu"))
        with pytest.raises(ValueError, match=match):
            trainer.fit()
    with pytest.raises(ValueError, match="matched nothing"):
        ttrain.Trainer(task, ttrain.TrainConfig(steps=2, input_files=str(tmp_path / "no-*.rio")),
                       torch.device("cpu")).fit()


def test_per_host_matches_the_reference_emulation():
    (jtr, jstate), (ttr, tstate) = _pair(input_mode="per_host", input_shards=2)
    for step in range(3):
        got = ttr._make_shard_batch(step, 0, 2, 2)
        want = jtr._make_shard_batch(step, 0, 2, 2)
        np.testing.assert_array_equal(got["input"], want["input"])
    _, jh = jtr.fit(state=jstate)
    _, th = ttr.fit(state=tstate)
    assert ttr.input_shard_range == jtr.input_shard_range == (0, 2, 2)
    np.testing.assert_allclose([h["loss"] for h in th], [h["loss"] for h in jh], rtol=RTOL)


def test_input_mode_rules():
    task = tgpt.make_task(tgpt.tiny_config(), seq_len=SEQ, batch_size=BATCH)
    cpu = torch.device("cpu")
    assert ttrain.Trainer(task, ttrain.TrainConfig(), cpu).input_mode() == "replicated"
    with pytest.raises(ValueError, match="needs input_files"):
        ttrain.Trainer(task, ttrain.TrainConfig(input_mode="files"), cpu).input_mode()
    with pytest.raises(ValueError, match="would ignore it"):
        ttrain.Trainer(task, ttrain.TrainConfig(input_mode="per_host", input_files="x"),
                       cpu).input_mode()
    with pytest.raises(ValueError, match="does not divide"):
        ttrain.Trainer(task, ttrain.TrainConfig(input_shards=3), cpu)._input_shard_plan()
