"""The port's slot-per-batch KV-cache generation against the JAX package's.

The same numpy-seeded prompts and the bridged parameters of one flax init
(tiny config, float32, on the CPU) go through the reference's
``prefill_cache``/``generate``/``greedy_generate``/``beam_generate`` and
the port's. The decode cache matches leaf by leaf (atol 1e-5) and the
logits within 1e-4; the batched prefill seeds the cache a token-at-a-time
prefill writes (the first layer bit for bit, every layer within 1e-5) and
both give the same tokens, bit for bit; greedy, sampled (the same key
through ``key_data``), EOS-stopped and beam tokens are exact, beam scores
within 1e-5, including a case built so that beams tie.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfk8s_tpu.models import gpt as jgpt
from tfk8s_tpu.models.bert import BertWithHead as JBertWithHead
from tfk8s_tpu.parallel.sharding import unbox
from tfk8s_tpu_torch import bridge
from tfk8s_tpu_torch.models import gpt as tgpt
from tfk8s_tpu_torch.models.transformer import decode_attention

CACHE_ATOL, LOGIT_ATOL, SCORE_ATOL = 1e-5, 1e-4, 1e-5
MAX_LEN = 64


def _jcfg(**kw):
    return jgpt.tiny_config(dtype=jnp.float32, max_len=MAX_LEN, **kw)


def _tcfg(**kw):
    return tgpt.tiny_config(dtype=torch.float32, max_len=MAX_LEN, **kw)


def _params(seed=0):
    params = unbox(jgpt.make_task(cfg=_jcfg(), seq_len=8, batch_size=1).init(jax.random.key(seed)))
    return jax.tree_util.tree_map(np.asarray, params)


def _port_model(params):
    cfg = _tcfg()
    model = tgpt.GPTLM(cfg)
    model.load_state_dict(bridge.params_to_state_dict(params, cfg))
    return model.eval()


@pytest.fixture(scope="module")
def pair():
    params = _params()
    return params, _port_model(params)


def _prompt(b, plen, seed):
    return np.random.default_rng(seed).integers(1, 64, (b, plen)).astype(np.int32)


def _jax_step(cfg, params, cache, tok, pos):
    logits, mut = JBertWithHead(cfg, causal=True, decode=True).apply(
        {"params": params, "cache": cache}, jnp.asarray(tok)[:, None],
        pos_offset=jnp.asarray(pos, jnp.int32), mutable=["cache"])
    return np.asarray(logits[:, 0]), mut["cache"]


def _assert_cache_close(jcache, tcache):
    ours = bridge.cache_from_torch(tcache)
    for i in range(len(tcache.keys)):
        a, b = jcache[f"layer{i}"]["attn"], ours[f"layer{i}"]["attn"]
        for leaf in ("cached_key", "cached_value"):
            np.testing.assert_allclose(b[leaf], np.asarray(a[leaf]), atol=CACHE_ATOL)
        assert int(b["cache_index"]) == int(np.asarray(a["cache_index"]))


def test_prefill_and_decode_steps_match_the_reference(pair):
    """The prefilled cache and prompt logits, then three decode steps from
    it: each step's logits and the cache after it."""
    params, model = pair
    jcfg, tcfg = _jcfg(decode_cache_len=16), _tcfg(decode_cache_len=16)
    prompt = _prompt(2, 10, seed=7)
    jlogits, jcache = jgpt.prefill_cache(jcfg, params, jnp.asarray(prompt))
    tlogits, tcache = tgpt.prefill_cache(tcfg, model, torch.from_numpy(prompt))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=LOGIT_ATOL)
    _assert_cache_close(jcache, tcache)
    decoder = tgpt.mode_view(model, decode=True)
    tok = np.asarray(jlogits[:, -1]).argmax(-1).astype(np.int32)
    for step in range(3):
        pos = 10 + step
        jl, jcache = _jax_step(jcfg, params, jcache, tok, pos)
        with torch.no_grad():
            tl, tcache = decoder(torch.from_numpy(tok)[:, None], cache=tcache,
                                 pos_offset=tcache.index)
        np.testing.assert_allclose(tl[:, 0].numpy(), jl, atol=LOGIT_ATOL)
        _assert_cache_close(jcache, tcache)
        tok = jl.argmax(-1).astype(np.int32)


def test_decode_from_a_bridged_reference_cache(pair):
    """A cache the reference prefilled, bridged into the port, decodes to
    the reference's next logits."""
    params, model = pair
    jcfg, tcfg = _jcfg(decode_cache_len=12), _tcfg(decode_cache_len=12)
    prompt = _prompt(3, 6, seed=8)
    _, jcache = jgpt.prefill_cache(jcfg, params, jnp.asarray(prompt))
    tcache = bridge.cache_to_torch(jax.tree_util.tree_map(np.asarray, jcache), tcfg)
    tok = prompt[:, -1]
    jl, _ = _jax_step(jcfg, params, jcache, tok, 6)
    with torch.no_grad():
        tl, _ = tgpt.mode_view(model, decode=True)(
            torch.from_numpy(tok)[:, None], cache=tcache, pos_offset=tcache.index)
    np.testing.assert_allclose(tl[:, 0].numpy(), jl, atol=LOGIT_ATOL)


def test_decode_steps_match_the_full_forward(pair):
    """Token-at-a-time decode from a clean cache gives the full causal
    forward's logits at every position."""
    _, model = pair
    tcfg = _tcfg(decode_cache_len=16)
    ids = torch.from_numpy(_prompt(2, 13, seed=9))
    with torch.no_grad():
        full = model(ids)
        cache, decoder = tgpt.init_cache(tcfg, 2), tgpt.mode_view(model, decode=True)
        steps = []
        for i in range(13):
            logits, cache = decoder(ids[:, i:i + 1], cache=cache, pos_offset=cache.index)
            steps.append(logits[:, 0])
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full.numpy(), atol=LOGIT_ATOL)


def test_batched_prefill_seeds_the_token_at_a_time_cache(pair):
    """The first layer's K/V are projections of the same embeddings, so
    the two prefills write them bit for bit; a later layer's inputs pass
    through attention, which sums over another number of keys in each
    path, so its K/V agree within the reference's own bound (1e-5,
    ``tests/test_gpt.py::test_prefill_cache_seeds_exact_decode_state``)."""
    _, model = pair
    tcfg = _tcfg(decode_cache_len=20)
    ids = torch.from_numpy(_prompt(3, 11, seed=10))
    _, fast = tgpt.prefill_cache(tcfg, model, ids)
    slow, decoder = tgpt.init_cache(tcfg, 3), tgpt.mode_view(model, decode=True)
    with torch.no_grad():
        for i in range(11):
            _, slow = decoder(ids[:, i:i + 1], cache=slow, pos_offset=slow.index)
    assert int(fast.index) == int(slow.index) == 11
    assert torch.equal(fast.keys[0], slow.keys[0]) and torch.equal(fast.values[0], slow.values[0])
    for a, b in zip(fast.keys + fast.values, slow.keys + slow.values):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=CACHE_ATOL)


SAMPLED = {"temperature": 0.9, "top_k": 8, "top_p": 0.9}
GENERATE_CASES = {
    "greedy": {},
    "greedy_scan_prefill": {"batched_prefill": False},
    "sampled_top_k_top_p": {"rng": 4, **SAMPLED},
    "sampled_temperature_only": {"rng": 5, "temperature": 1.3},
    "sampled_scan_prefill": {"rng": 4, "batched_prefill": False, **SAMPLED},
    "zero_temperature_is_greedy": {"rng": 4, "temperature": 0.0},
}


@pytest.mark.parametrize("case", sorted(GENERATE_CASES))
def test_generate_tokens_equal_the_reference(pair, case):
    params, model = pair
    kw = dict(GENERATE_CASES[case])
    prompt = _prompt(3, 11, seed=11)
    jkw, tkw = dict(kw), dict(kw)
    if "rng" in kw:
        key = jax.random.key(kw["rng"])
        jkw["rng"] = key
        tkw["rng"] = np.asarray(jax.random.key_data(key))
    want = np.asarray(jgpt.generate(_jcfg(), params, jnp.asarray(prompt), 9, **jkw))
    got = tgpt.generate(_tcfg(), model, torch.from_numpy(prompt), 9, **tkw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_batched_and_scan_prefill_give_the_same_tokens(pair):
    _, model = pair
    prompt = torch.from_numpy(_prompt(2, 9, seed=12))
    for kw in ({}, {"rng": 7, **SAMPLED}):
        fast = tgpt.generate(_tcfg(), model, prompt, 8, **kw)
        slow = tgpt.generate(_tcfg(), model, prompt, 8, batched_prefill=False, **kw)
        assert torch.equal(fast, slow), kw


def test_eos_stops_each_row_and_pads_as_the_reference(pair):
    """``eos_id`` is a token the greedy stream emits mid-way: every row
    pads after its first EOS, and the tokens equal the reference's, greedy
    and sampled."""
    params, model = pair
    prompt = _prompt(3, 7, seed=13)
    greedy = tgpt.generate(_tcfg(), model, torch.from_numpy(prompt), 12).numpy()
    eos = int(greedy[0, 4])
    key = jax.random.key(3)
    for jkw, tkw in (({}, {}), ({"rng": key, **SAMPLED},
                                {"rng": np.asarray(jax.random.key_data(key)), **SAMPLED})):
        want = np.asarray(jgpt.generate(_jcfg(), params, jnp.asarray(prompt), 12,
                                        eos_id=eos, pad_id=0, **jkw))
        got = tgpt.generate(_tcfg(), model, torch.from_numpy(prompt), 12, eos_id=eos,
                            **tkw).numpy()
        np.testing.assert_array_equal(got, want)
    for row in got:
        hits = np.flatnonzero(row == eos)
        if hits.size:
            assert (row[hits[0] + 1:] == 0).all()
    with pytest.raises(ValueError, match="batched_prefill"):
        tgpt.generate(_tcfg(), model, torch.from_numpy(prompt), 4, eos_id=eos,
                      batched_prefill=False)


def test_greedy_generate_equals_the_reference(pair):
    params, model = pair
    prompt = _prompt(2, 5, seed=14)
    want = np.asarray(jgpt.greedy_generate(_jcfg(), params, jnp.asarray(prompt), 10))
    got = tgpt.greedy_generate(_tcfg(), model, torch.from_numpy(prompt), 10)
    np.testing.assert_array_equal(got.numpy(), want)


def _beam_pair(params, model, prompt, n, beams):
    want_s, want_sc = jgpt.beam_generate(_jcfg(), params, jnp.asarray(prompt), n,
                                         num_beams=beams, return_all=True)
    got_s, got_sc = tgpt.beam_generate(_tcfg(), model, torch.from_numpy(prompt), n,
                                       num_beams=beams, return_all=True)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_allclose(got_sc.numpy(), np.asarray(want_sc), atol=SCORE_ATOL)
    return got_s, got_sc


def test_beam_generate_equals_the_reference(pair):
    params, model = pair
    prompt = _prompt(4, 6, seed=6)
    seqs, scores = _beam_pair(params, model, prompt, 6, 4)
    assert seqs.shape == (4, 4, 6) and scores.shape == (4, 4)
    best = tgpt.beam_generate(_tcfg(), model, torch.from_numpy(prompt), 6, num_beams=4)
    assert torch.equal(best, seqs[:, 0])
    greedy = tgpt.greedy_generate(_tcfg(), model, torch.from_numpy(prompt), 6)
    assert torch.equal(tgpt.beam_generate(_tcfg(), model, torch.from_numpy(prompt), 6,
                                          num_beams=1), greedy)


def test_beam_ties_break_toward_the_lower_index_as_the_reference():
    """Token u's embedding is set to token t's, where t is row 0's greedy
    first token: the tied head then scores t and u exactly alike at every
    step, so beams tie within a step and across parents. ``jax.lax.top_k``
    breaks ties toward the lower index; so must the port."""
    params = _params(seed=2)
    prompt = _prompt(2, 5, seed=15)
    model = _port_model(params)
    t = int(tgpt.greedy_generate(_tcfg(), model, torch.from_numpy(prompt), 1)[0, 0])
    u = next(x for x in range(63, 0, -1) if x != t and x not in prompt)
    emb = params["embed"]["tok"]["embedding"].copy()
    emb[u] = emb[t]
    params["embed"]["tok"]["embedding"] = emb
    model = _port_model(params)
    seqs, scores = _beam_pair(params, model, prompt, 5, 4)
    first = seqs[0, :, 0].tolist()
    assert t in first and u in first
    assert scores[0, first.index(t)] == scores[0, first.index(u)]


def test_decode_mode_refuses_what_the_reference_refuses(pair):
    _, model = pair
    tcfg = _tcfg(decode_cache_len=8)
    cache, decoder = tgpt.init_cache(tcfg, 2), tgpt.mode_view(model, decode=True)
    ids = torch.ones((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="one token per call"):
        decoder(ids, cache=cache, pos_offset=cache.index)
    with pytest.raises(ValueError, match="padding masks"):
        decoder(ids[:, :1], mask=torch.ones((2, 8), dtype=torch.bool), cache=cache,
                pos_offset=cache.index)
    with pytest.raises(ValueError, match="decode cache"):
        decoder(ids[:, :1])
    with pytest.raises(ValueError, match="max_len"):
        tgpt.generate(_tcfg(), model, ids, MAX_LEN)
    with pytest.raises(ValueError, match="decode_cache_len"):
        tgpt.generate(tcfg, model, ids, 6)


def test_a_step_past_the_buffer_reads_nan():
    """The reference's overflow guard: past the buffer the write lands on
    the last position and the output is NaN."""
    q = torch.randn(1, 1, 2, 4)
    kv = (torch.zeros(1, 3, 2, 4), torch.zeros(1, 3, 2, 4))
    inside = decode_attention(q, q, q, kv, torch.tensor(2, dtype=torch.int32))
    assert torch.isfinite(inside).all()
    past = decode_attention(q, q, q, kv, torch.tensor(3, dtype=torch.int32))
    assert torch.isnan(past).all()
    assert torch.equal(kv[0][0, 2], q[0, 0])


def test_cache_bridge_round_trips(pair):
    _, model = pair
    tcfg = _tcfg(decode_cache_len=9)
    _, cache = tgpt.prefill_cache(tcfg, model, torch.from_numpy(_prompt(2, 4, seed=16)))
    back = bridge.cache_to_torch(bridge.cache_from_torch(cache), tcfg)
    assert int(back.index) == 4
    for a, b in zip(cache.keys + cache.values, back.keys + back.values):
        assert torch.equal(a, b)
    tree = bridge.cache_from_torch(cache)
    tree["layer1"]["attn"]["cache_index"] = np.asarray(5, np.int32)
    with pytest.raises(ValueError, match="disagree"):
        bridge.cache_to_torch(tree, tcfg)


def test_prefill_takes_the_attention_the_policy_picks(pair, monkeypatch):
    """``prefill_cache`` runs its forward through ``select_attn_fn``: with
    ``attention_impl="flash"`` the flash entry (its plain version on the
    CPU). The first layer's K/V do not depend on it; later layers' within
    1e-5, as the two attentions round apart."""
    _, model = pair
    from tfk8s_tpu_torch.ops import flash_attention as fa

    calls = []
    real = fa.flash_attention

    def counting(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(tgpt, "select_attn_fn",
                        lambda cfg, n, dev: counting if cfg.attention_impl == "flash" else None)
    ids = torch.from_numpy(_prompt(2, 8, seed=17))
    flash_cfg = dataclasses.replace(_tcfg(decode_cache_len=10), attention_impl="flash")
    lf, cf = tgpt.prefill_cache(flash_cfg, model, ids)
    lp, cp = tgpt.prefill_cache(_tcfg(decode_cache_len=10), model, ids)
    assert len(calls) == model.cfg.num_layers
    np.testing.assert_allclose(lf.numpy(), lp.numpy(), atol=1e-5)
    assert torch.equal(cf.keys[0], cp.keys[0]) and torch.equal(cf.values[0], cp.values[0])
    for a, b in zip(cf.keys + cf.values, cp.keys + cp.values):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=CACHE_ATOL)
