"""The port's text tools against the JAX package's: the byte-level BPE
tokenizer (``data/tokenizer.py``) and the corpus packer (``data/corpus.py``).

Every case of the reference's ``TestBPETokenizer`` and
``TestCorpusPacking`` (``tests/test_tokenizer.py``) runs on both
packages' modules: its own assertion holds on the port's, and what the
port produces equals the reference's exactly (token ids, decoded text,
the saved ``vocab.json``/``merges.txt``/``special_tokens.json`` bytes,
the CLI's ``part-*.rio`` bytes, ``VocabMismatchError``'s text).
``write_shards`` leaves nothing behind on failure. Then the text flow:
three ``gpt:train`` steps at tiny width from those shards with
``TFK8S_VOCAB_SIZE``, against the reference Trainer on the same shards
from the same parameters (loss and grad norm rtol 1e-4), and greedy
tokens of both decoding to the same text.
"""

import functools
import glob
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfk8s_tpu.data import corpus as jcorpus
from tfk8s_tpu.data import tokenizer as jtok
from tfk8s_tpu.models import gpt as jgpt
from tfk8s_tpu.parallel.mesh import make_mesh
from tfk8s_tpu.parallel.sharding import unbox
from tfk8s_tpu.runtime import train as jtrain
from tfk8s_tpu_torch import bridge
from tfk8s_tpu_torch.data import corpus as tcorpus
from tfk8s_tpu_torch.data import tokenizer as ttok
from tfk8s_tpu_torch.data.example import decode
from tfk8s_tpu_torch.data.recordio import RecordFile
from tfk8s_tpu_torch.models import gpt as tgpt
from tfk8s_tpu_torch.runtime import train as ttrain
from tfk8s_tpu_torch.runtime.checkpoint import Checkpointer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-4
TEXTS = [  # the reference test's corpus
    "the quick brown fox jumps over the lazy dog. " * 30,
    "pack my box with five dozen liquor jugs, judge! " * 30,
    "sphinx of black quartz: judge my vow. " * 30,
]
SIDES = {"port": (ttok, tcorpus), "reference": (jtok, jcorpus)}


def _files(d):
    """Every file under ``d`` as {relative path: bytes}."""
    return {os.path.relpath(p, d): open(p, "rb").read()
            for p in sorted(glob.glob(os.path.join(d, "**", "*"), recursive=True))
            if os.path.isfile(p)}


# -- the reference's cases, each a function of one side's modules ----------
# Each returns what the case observes; its own assertions run on each side.

def _byte_table(tok, corpus, tmp):
    table = tok.bytes_to_unicode()
    assert len(table) == 256 and len(set(table.values())) == 256
    assert table[ord("A")] == "A" and table[0] == chr(256)
    return table


def _roundtrip(text):
    def case(tok, corpus, tmp):
        t = tok.train_bpe(TEXTS, vocab_size=400)
        ids = t.encode(text)
        assert t.decode(ids) == text
        return ids
    return case


def _compresses(tok, corpus, tmp):
    t = tok.train_bpe(TEXTS, vocab_size=500, specials=["<|pad|>"])
    ids = t.encode("the quick brown fox jumps over the lazy dog.")
    assert len(ids) < 20 and t.vocab["<|pad|>"] == 0
    return ids, t.vocab, t.merges


def _save_load(tok, corpus, tmp):
    t = tok.train_bpe(TEXTS, vocab_size=400, specials=["<|pad|>"])
    t.save(str(tmp))
    t2 = tok.BPETokenizer.load(str(tmp))
    probe = "judge my vow, quick fox"
    assert t2.encode(probe) == t.encode(probe) and t2.decode(t2.encode(probe)) == probe
    return _files(str(tmp)), t2.encode(probe)


def _deterministic(tok, corpus, tmp):
    a, b = tok.train_bpe(TEXTS, vocab_size=350), tok.train_bpe(TEXTS, vocab_size=350)
    assert a.merges == b.merges and a.vocab == b.vocab
    return a.merges, a.vocab


def _specials_atomic(tok, corpus, tmp):
    t = tok.train_bpe(TEXTS, vocab_size=400, specials=["<|pad|>", "<|endoftext|>"])
    text = "quick fox<|endoftext|>lazy dog<|pad|>"
    ids = t.encode(text)
    assert ids.count(t.vocab["<|endoftext|>"]) == 1 and ids.count(t.vocab["<|pad|>"]) == 1
    assert t.decode(ids) == text
    return ids


def _specials_survive(tok, corpus, tmp):
    t = tok.train_bpe(TEXTS, vocab_size=400, specials=["<|endoftext|>"])
    t.save(str(tmp))
    t2 = tok.BPETokenizer.load(str(tmp))
    assert t2.specials == ["<|endoftext|>"]
    assert t2.encode("a<|endoftext|>b") == t.encode("a<|endoftext|>b")
    return _files(str(tmp)), t2.encode("a<|endoftext|>b")


def _arbitrary_specials(tok, corpus, tmp):
    t = tok.train_bpe(TEXTS, vocab_size=400, specials=["[PAD]", "[SEP]"])
    t.save(str(tmp))
    t2 = tok.BPETokenizer.load(str(tmp))
    assert t2.specials == ["[PAD]", "[SEP]"]
    probe = "quick[SEP]fox[PAD]"
    assert t2.encode(probe) == t.encode(probe) and t2.encode(probe).count(t2.vocab["[SEP]"]) == 1
    return _files(str(tmp)), t2.encode(probe)


def _empty_manifest(tok, corpus, tmp):
    t = tok.train_bpe(TEXTS, vocab_size=400)
    t.save(str(tmp))
    assert json.loads((tmp / "special_tokens.json").read_text()) == []
    t2 = tok.BPETokenizer.load(str(tmp))
    probe = "the <|endoftext|> literal is just text here"
    assert t2.specials == [] and t2.encode(probe) == t.encode(probe)
    return _files(str(tmp)), t2.encode(probe)


def _vocab_mismatch(tok, corpus, tmp):
    t = tok.train_bpe(TEXTS, vocab_size=400)
    bad = tok.BPETokenizer({k: v for k, v in t.vocab.items() if len(k) < 3}, t.merges)
    with pytest.raises(tok.VocabMismatchError, match="merges") as err:
        bad.encode("the quick brown fox")
    assert isinstance(err.value, KeyError)  # pre-existing handlers keep working
    return str(err.value)


def _cli(tok, corpus, tmp):
    cdir = tmp / "corpus"
    cdir.mkdir()
    for i, t in enumerate(TEXTS):
        (cdir / f"doc{i}.txt").write_text(t)
    out = subprocess.run(
        [sys.executable, "-m", corpus.__name__, "--input", str(cdir / "*.txt"),
         "--out-dir", str(tmp / "shards"), "--seq-len", "33", "--vocab-size", "400",
         "--num-shards", "2", "--tokenizer-dir", str(tmp / "tok")],
        capture_output=True, text=True, cwd=REPO, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    shards = sorted((tmp / "shards").glob("part-*.rio"))
    assert len(shards) == 2
    rows = [decode(r)["input"] for p in shards for r in RecordFile(str(p))]
    assert all(r.shape == (33,) and r.dtype == np.int32 for r in rows)
    text = tok.BPETokenizer.load(str(tmp / "tok")).decode(rows[0])
    assert "the" in text or "judge" in text or "box" in text, text
    return _files(str(tmp / "shards")), _files(str(tmp / "tok")), text


def _stream_order(tok, corpus, tmp):
    t = tok.train_bpe(TEXTS, vocab_size=300, specials=[corpus.PAD, corpus.EOS])
    flat = np.concatenate(list(corpus.pack_rows(t, TEXTS, seq_len=16)))
    want = []
    for text in TEXTS:
        want.extend(t.encode(text) + [t.vocab[corpus.EOS]])
    np.testing.assert_array_equal(flat, np.asarray(want[: len(flat)]))
    return flat.tolist()


CASES = {
    "byte_table_is_the_gpt2_constant": _byte_table,
    **{f"roundtrip_lossless_{i}": _roundtrip(t) for i, t in enumerate([
        "the quick brown fox", "héllo wörld — ünïcode 🙂",
        "tabs\tand\nnewlines  and   spaces", "NEVER-seen Symbols ¤µ 12345!?"])},
    "training_compresses_the_corpus": _compresses,
    "save_load_hf_layout": _save_load,
    "deterministic_training": _deterministic,
    "specials_encode_atomically": _specials_atomic,
    "specials_survive_save_load": _specials_survive,
    "arbitrary_shaped_specials_survive_save_load": _arbitrary_specials,
    "empty_specials_manifest_blocks_phantom_specials": _empty_manifest,
    "vocab_merges_mismatch_names_the_piece": _vocab_mismatch,
    "cli_packs_shards": _cli,
    "rows_cover_stream_order": _stream_order,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_port_gives_the_reference_result(case, tmp_path):
    got = {}
    for side, (tok, corpus) in SIDES.items():
        (tmp_path / side).mkdir()
        got[side] = CASES[case](tok, corpus, tmp_path / side)
    assert got["port"] == got["reference"]


def test_write_shards_leaves_nothing_on_failure(tmp_path):
    """Fewer rows than shards: the same error as the reference's, and no
    partial ``part-*`` file for a later run's glob to pick up."""
    msgs = {}
    for side, (_tok, corpus) in SIDES.items():
        with pytest.raises(ValueError, match="fewer shards") as err:
            corpus.write_shards(iter([np.zeros((8,), np.int32)]), str(tmp_path / side),
                                num_shards=4)
        assert os.listdir(tmp_path / side) == []
        msgs[side] = str(err.value)
    assert msgs["port"] == msgs["reference"]


def test_gpt_train_sizes_the_model_to_the_tokenizer(monkeypatch):
    """``TFK8S_VOCAB_SIZE`` sizes the embedding (the reference's
    ``test_gpt_train_env_carries_vocab_size``)."""
    captured = {}
    monkeypatch.setattr(tgpt, "run_task", lambda task, env, stop, **kw: captured.update(task=task))
    tgpt.train({"TFK8S_DEVICE": "cpu", "TFK8S_MODEL_PRESET": "tiny", "TFK8S_VOCAB_SIZE": "96",
                "TFK8S_SEQ_LEN": "16", "TFK8S_BATCH_SIZE": "4"})
    model = captured["task"].init(torch.Generator().manual_seed(0))
    assert model.state_dict()["embed.tok.weight"].shape[0] == 96


SEQ, BATCH, STEPS = 17, 8, 3


@pytest.fixture(scope="module")
def text_shards(tmp_path_factory):
    """The reference e2e's corpus flow through the port: a tokenizer of
    vocabulary 320, rows of 17, two shards."""
    tmp = tmp_path_factory.mktemp("text")
    tok = tcorpus.get_tokenizer(TEXTS, str(tmp / "tok"), vocab_size=320)
    tcorpus.write_shards(tcorpus.pack_rows(tok, TEXTS, seq_len=SEQ), str(tmp / "shards"),
                         num_shards=2)
    return tok, str(tmp / "shards" / "part-*.rio"), tmp


def test_three_gpt_train_steps_from_text_shards_follow_the_reference(text_shards, monkeypatch):
    tok, pattern, tmp = text_shards
    monkeypatch.setattr(tgpt, "tiny_config",
                        functools.partial(tgpt.tiny_config, dtype=torch.float32))
    tcfg = tgpt.tiny_config(vocab_size=tok.vocab_size)
    jcfg = jgpt.tiny_config(dtype=jnp.float32, vocab_size=tok.vocab_size)
    # the port's initial parameters: a step-0 checkpoint the entrypoint
    # resumes, and the reference's tree
    ttask = tgpt.make_task(tcfg, seq_len=SEQ, batch_size=BATCH)
    state = ttrain.Trainer(ttask, ttrain.TrainConfig(), torch.device("cpu")).init_state()
    ckpt = str(tmp / "ckpt")
    Checkpointer(ckpt).save(0, state.state_dict(), wait=True)
    params = jax.tree_util.tree_map(jnp.asarray,
                                    bridge.state_dict_to_params(state.model.state_dict(), tcfg))

    jtr = jtrain.Trainer(jgpt.make_task(jcfg, seq_len=SEQ, batch_size=BATCH),
                         jtrain.TrainConfig(steps=STEPS, learning_rate=3e-3, log_every=1,
                                            input_mode="files", input_files=pattern),
                         make_mesh(data=1))
    jstate = jax.device_put(jtrain.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                              opt_state=jtr.optimizer.init(params)),
                            jtr.state_shardings)
    jstate, want = jtr.fit(state=jstate)
    got = tgpt.train({
        "TFK8S_DEVICE": "cpu", "TFK8S_MODEL_PRESET": "tiny", "TFK8S_VOCAB_SIZE":
        str(tok.vocab_size), "TFK8S_SEQ_LEN": str(SEQ), "TFK8S_BATCH_SIZE": str(BATCH),
        "TFK8S_TRAIN_STEPS": str(STEPS), "TFK8S_LOG_EVERY": "1", "TFK8S_LEARNING_RATE": "3e-3",
        "TFK8S_INPUT_FILES": pattern, "TFK8S_CHECKPOINT_DIR": ckpt, "TFK8S_WORLD_VERSION": "1"})
    assert [h["step"] for h in got] == [h["step"] for h in want] == [1, 2, 3]
    np.testing.assert_allclose([[h["loss"], h["grad_norm"]] for h in got],
                               [[h["loss"], h["grad_norm"]] for h in want], rtol=RTOL)

    # greedy continuations of the trained models decode to the same text
    model = tgpt.GPTLM(tcfg)
    model.load_state_dict(Checkpointer(ckpt).restore()["model"])
    prompt = [tok.encode("the quick brown")]
    ours = tgpt.greedy_generate(tcfg, model.eval(), torch.tensor(prompt), 8)[0].tolist()
    theirs = np.asarray(jgpt.generate(jcfg, unbox(jstate.params), jnp.asarray(prompt, jnp.int32),
                                      num_tokens=8))[0].tolist()
    assert ours == theirs
    assert tok.decode(ours) == jtok.BPETokenizer.load(str(tmp / "tok")).decode(theirs)
    assert len(tok.decode(ours)) > 0
