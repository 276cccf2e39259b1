"""The port's block-paged decode against the JAX package's, on the same
parameters.

The reference's GPT is initialised in JAX, its parameters go through
``tfk8s_tpu_torch.bridge`` into the port's model, and the same numpy
packed states and batches go to both: the packed decode, prefill and
verify steps must pick exactly the same tokens (greedy and sampled), the
page pools must agree to atol 1e-5 and ``_paged_apply``'s logits to atol
1e-4 (tiny config, float32). Then the four behaviours of the paged
attention branch (trash page 0, overflow writes to trash, NaN past the
table, the full-extent gather) and the reference's device pins: mixed-
length paged greedy decode equals ``gpt.generate``, chunked prefill
equals single-shot, inactive rows write only the trash page.
"""

import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfk8s_tpu.models import gpt as jgpt
from tfk8s_tpu.parallel.sharding import unbox
from tfk8s_tpu_torch import bridge
from tfk8s_tpu_torch.models import gpt as tgpt
from tfk8s_tpu_torch.models import transformer as ttr

POOL_ATOL = 1e-5
LOGIT_ATOL = 1e-4
PS, PAGES = 4, 40


@pytest.fixture(scope="module")
def bridged():
    """(jax cfg, torch cfg, flax params, port model), tiny float32 paged."""
    jcfg0 = jgpt.tiny_config(dtype=jnp.float32)
    params = unbox(jgpt.make_task(cfg=jcfg0, seq_len=8, batch_size=1)
                   .init(jax.random.key(0)))
    params = jax.tree_util.tree_map(np.asarray, params)
    tcfg0 = tgpt.tiny_config(dtype=torch.float32)
    model = tgpt.GPTLM(dc.replace(tcfg0, kv_page_size=PS, kv_max_pages=PAGES))
    model.load_state_dict(bridge.params_to_state_dict(params, tcfg0))
    model.eval()
    return jcfg0, tcfg0, params, model


def _paged(bridged, ps=PS, pages=PAGES):
    jcfg0, tcfg0, params, model = bridged
    jcfg = dc.replace(jcfg0, kv_page_size=ps, kv_max_pages=pages)
    tcfg = dc.replace(tcfg0, kv_page_size=ps, kv_max_pages=pages)
    if (ps, pages) != (PS, PAGES):
        model = tgpt.GPTLM(tcfg)
        model.load_state_dict(bridge.params_to_state_dict(params, tcfg0))
        model.eval()
    return jcfg, tcfg, params, model


def _leaves_close(jpages, tpages, atol=POOL_ATOL, skip_rows=0):
    jl = jax.tree_util.tree_leaves(jpages)
    tl = tgpt.page_leaves(tpages)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(np.asarray(a)[skip_rows:], b.numpy()[skip_rows:],
                                   atol=atol, rtol=0)


def _sampling(rows, seed):
    """Per-row knobs mixing greedy, temperature, top_k and top_p."""
    rng = np.random.default_rng(seed)
    samp_f = np.zeros((rows, 2), np.float32)
    samp_i = np.zeros((rows, 2), np.int32)
    for r in range(rows):
        kind = r % 4
        samp_f[r] = (0.0 if kind == 0 else [0.7, 1.3, 0.9][kind - 1],
                     [1.0, 1.0, 0.8, 0.95][kind])
        samp_i[r] = ([0, 12, 0, 5][kind], int(rng.integers(0, 2 ** 31 - 1)))
    return samp_f, samp_i


def _prefill_batch(tcfg, rows, chunk, seed, n_live):
    """A packed [rows, C + 1 + mpp] prefill batch: n_live rows, each with
    its own pages, idle rows all zero."""
    mpp = tcfg.pages_per_slot()
    rng = np.random.default_rng(seed)
    batch = np.zeros((rows, chunk + 1 + mpp), np.int32)
    for r in range(n_live):
        n = int(rng.integers(1, chunk + 1))
        batch[r, :n] = rng.integers(1, tcfg.vocab_size, n)
        batch[r, chunk] = 0
        batch[r, chunk + 1:chunk + 1 + 4] = np.arange(1 + 4 * r, 5 + 4 * r)
    return batch


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_prefill_step_packed_matches_reference(bridged, sampled):
    jcfg, tcfg, params, model = _paged(bridged)
    batch = _prefill_batch(tcfg, rows=4, chunk=8, seed=1, n_live=3)
    samp = _sampling(4, seed=2) if sampled else None
    jp = jgpt.clean_pages(jcfg)
    jpicks, jp = jgpt.prefill_step_packed(jcfg, params, jp, batch, sampling=samp)
    tp = tgpt.clean_pages(tcfg)
    tsamp = None if samp is None else tuple(torch.from_numpy(s) for s in samp)
    tpicks, tp = tgpt.prefill_step_packed(tcfg, model, tp, torch.from_numpy(batch),
                                          sampling=tsamp)
    np.testing.assert_array_equal(np.asarray(jpicks), tpicks.numpy())
    _leaves_close(jp, tp)


def _decoded_state(tcfg, jpicks, batch, chunk):
    mpp = tcfg.pages_per_slot()
    state = np.zeros((batch.shape[0], 2 + mpp), np.int32)
    for r in range(batch.shape[0]):
        if batch[r, chunk + 1]:
            state[r, 0] = np.asarray(jpicks)[r, chunk - 1]
            state[r, 1] = chunk
            state[r, 2:] = batch[r, chunk + 1:]
    return state


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_decode_step_packed_matches_reference(bridged, sampled):
    """Five packed decode steps from the same prefilled pools: the same
    emitted tokens and next states every step, pools within 1e-5."""
    jcfg, tcfg, params, model = _paged(bridged)
    chunk = 8
    batch = _prefill_batch(tcfg, rows=4, chunk=chunk, seed=3, n_live=3)
    jp = jgpt.clean_pages(jcfg)
    jpicks, jp = jgpt.prefill_step_packed(jcfg, params, jp, batch)
    tp = bridge.pages_to_torch(jax.tree_util.tree_map(np.asarray, jp), tcfg)
    state = _decoded_state(tcfg, jpicks, batch, chunk)
    samp = _sampling(4, seed=4) if sampled else None
    tsamp = None if samp is None else tuple(torch.from_numpy(s) for s in samp)
    jstep = jax.jit(lambda p, s: jgpt.decode_step_packed(jcfg, params, p, s, sampling=samp))
    jstate, tstate = state, torch.from_numpy(state)
    for _ in range(5):
        jn, jstate, jp = jstep(jp, jstate)
        tn, tstate, tp = tgpt.decode_step_packed(tcfg, model, tp, tstate, sampling=tsamp)
        np.testing.assert_array_equal(np.asarray(jn), tn.numpy())
        np.testing.assert_array_equal(np.asarray(jstate), tstate.numpy())
    _leaves_close(jp, tp)


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_verify_step_packed_matches_reference(bridged, sampled):
    jcfg, tcfg, params, model = _paged(bridged)
    chunk = 8
    batch = _prefill_batch(tcfg, rows=4, chunk=chunk, seed=5, n_live=4)
    jp = jgpt.clean_pages(jcfg)
    jpicks, jp = jgpt.prefill_step_packed(jcfg, params, jp, batch)
    tp = bridge.pages_to_torch(jax.tree_util.tree_map(np.asarray, jp), tcfg)
    state = _decoded_state(tcfg, jpicks, batch, chunk)
    drafts = np.random.default_rng(6).integers(1, tcfg.vocab_size, (4, 3)).astype(np.int32)
    samp = _sampling(4, seed=7) if sampled else None
    tsamp = None if samp is None else tuple(torch.from_numpy(s) for s in samp)
    jv, jp = jgpt.verify_step_packed(jcfg, params, jp, state, drafts, sampling=samp)
    tv, tp = tgpt.verify_step_packed(tcfg, model, tp, torch.from_numpy(state),
                                     torch.from_numpy(drafts), sampling=tsamp)
    assert tv.shape == (4, 4)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    _leaves_close(jp, tp)


def test_paged_apply_logits_match_reference(bridged):
    """Rows at different positions with partly filled pages: float32
    logits within 1e-4, the written pools within 1e-5."""
    jcfg, tcfg, params, model = _paged(bridged)
    mpp = tcfg.pages_per_slot()
    rng = np.random.default_rng(8)
    tokens = rng.integers(1, tcfg.vocab_size, (3, 5)).astype(np.int32)
    positions = np.array([0, 6, 13], np.int32)
    tables = np.zeros((3, mpp), np.int32)
    for r in range(3):
        tables[r, :5] = np.arange(1 + 5 * r, 6 + 5 * r)
    jp = jgpt.clean_pages(jcfg)
    jl, jp = jgpt._paged_apply(jcfg, params, jp, tokens, tables, positions)
    tp = tgpt.clean_pages(tcfg)
    with torch.no_grad():
        tl, tp = tgpt._paged_apply(tcfg, model, tp, torch.from_numpy(tokens),
                                   torch.from_numpy(tables), torch.from_numpy(positions))
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(np.asarray(jl), tl.numpy(), atol=LOGIT_ATOL, rtol=0)
    _leaves_close(jp, tp)


def test_prefill_into_slots_matches_the_reference(bridged):
    """The reference's chunked-prefill name: one request's ``[1, C]``
    slice written into its pages at its position."""
    jcfg, tcfg, params, model = _paged(bridged)
    chunk = np.random.default_rng(9).integers(1, tcfg.vocab_size, (1, 6)).astype(np.int32)
    table = np.zeros((1, tcfg.pages_per_slot()), np.int32)
    table[0, :4] = [3, 7, 2, 9]
    position = np.array([5], np.int32)
    jl, jp = jgpt.prefill_into_slots(jcfg, params, jgpt.clean_pages(jcfg), chunk, table, position)
    with torch.no_grad():
        tl, tp = tgpt.prefill_into_slots(tcfg, model, tgpt.clean_pages(tcfg),
                                         torch.from_numpy(chunk), torch.from_numpy(table),
                                         torch.from_numpy(position))
    np.testing.assert_allclose(np.asarray(jl), tl.numpy(), atol=LOGIT_ATOL, rtol=0)
    _leaves_close(jp, tp)


def test_pool_leaves_follow_the_reference_tree_order(bridged):
    """``page_leaves`` flattens the pools in flax's sorted-key order
    (layer0, layer1, layer10, layer11, layer2, ...)."""
    _jcfg, tcfg, _params, _model = _paged(bridged)
    twelve = dc.replace(tcfg, num_layers=12)
    jtree = {f"layer{i}": {"attn": {"k_pages": np.full(1, 2 * i), "v_pages": np.full(1, 2 * i + 1)}}
             for i in range(12)}
    pools = [(torch.full((1,), 2 * i), torch.full((1,), 2 * i + 1)) for i in range(12)]
    want = [int(a[0]) for a in jax.tree_util.tree_leaves(jtree)]
    assert [int(t[0]) for t in tgpt.page_leaves(pools)] == want
    assert tgpt.leaf_layers(twelve.num_layers)[:5] == [0, 1, 10, 11, 2]


def test_page_bridge_round_trips(bridged):
    jcfg, tcfg, params, _model = _paged(bridged)
    batch = _prefill_batch(tcfg, rows=2, chunk=8, seed=9, n_live=2)
    _, jp = jgpt.prefill_step_packed(jcfg, params, jgpt.clean_pages(jcfg), batch)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tp = bridge.pages_to_torch(tree, tcfg)
    back = bridge.pages_from_torch(tp)
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)


# -- the four behaviours of the paged attention branch ------------------------


def test_inactive_rows_write_only_the_trash_page(bridged):
    """An all-zero state row writes page 0 only: every other page is
    untouched, bit for bit (the reference's pin, on the port)."""
    _jcfg, tcfg, _params, model = _paged(bridged, ps=8, pages=8)
    mpp = tcfg.pages_per_slot()
    pages = tgpt.clean_pages(tcfg)
    state = np.zeros((2, 2 + mpp), np.int32)
    state[0, :3] = [3, 2, 1]  # a live row filling page 1
    _, sdev, pages = tgpt.decode_step_packed(tcfg, model, pages, torch.from_numpy(state))
    before = [leaf[tcfg.kv_page_size:].clone() for leaf in tgpt.page_leaves(pages)]
    _, _, pages = tgpt.decode_step_packed(tcfg, model, pages, sdev * 0)
    after = tgpt.page_leaves(pages)
    for a, b in zip(before, after):
        assert torch.equal(a, b[tcfg.kv_page_size:])
    assert all(torch.count_nonzero(b[:tcfg.kv_page_size]) > 0 for b in after)


def test_overflow_writes_trash_and_poisons_only_its_outputs(bridged):
    """A chunk that runs past the page table: its overflowing positions
    write the trash page, never the row's last page, and their outputs
    are NaN while the positions inside the table stay finite; the same
    as the reference, pool for pool outside the trash page."""
    jcfg, tcfg, params, model = _paged(bridged, ps=8, pages=12)
    mpp = tcfg.pages_per_slot()  # 8 pages of 8 cover max_len 64
    table = np.arange(1, mpp + 1, dtype=np.int32)[None, :]
    tokens = np.random.default_rng(10).integers(1, tcfg.vocab_size, (1, 8)).astype(np.int32)
    base = np.array([mpp * 8 - 3], np.int32)  # 3 positions inside, 5 past
    tp = tgpt.clean_pages(tcfg)
    last = slice((mpp) * 8, (mpp + 1) * 8)  # rows of the row's last page
    with torch.no_grad():
        logits, tp = tgpt._paged_apply(tcfg, model, tp, torch.from_numpy(tokens),
                                       torch.from_numpy(table), torch.from_numpy(base))
    assert torch.isfinite(logits[0, :3]).all()
    assert torch.isnan(logits[0, 3:]).all()
    k0 = tp[0][0]
    # the last page holds the 3 in-table positions (offsets 5..7), and
    # nothing else: offsets 0..4 were never written
    assert torch.count_nonzero(k0[last][:5]) == 0
    assert torch.count_nonzero(k0[last][5:]) > 0
    assert torch.count_nonzero(k0[:8]) > 0  # the overflow landed in trash
    jl, jp = jgpt._paged_apply(jcfg, params, jgpt.clean_pages(jcfg), tokens, table, base)
    assert np.array_equal(np.isnan(np.asarray(jl)), torch.isnan(logits).numpy())
    _leaves_close(jp, tp, skip_rows=8)


def test_gather_always_covers_the_full_page_table_extent(bridged, monkeypatch):
    """Attention reads pages_per_slot() * page_size keys per row whatever
    the fill: the footprint the scheduler's page math assumes."""
    _jcfg, tcfg, _params, model = _paged(bridged)
    seen = []
    plain = ttr.dot_product_attention

    def spy(q, k, v, mask=None, causal=False):
        seen.append(k.shape[1])
        return plain(q, k, v, mask=mask, causal=causal)

    monkeypatch.setattr(ttr, "dot_product_attention", spy)
    mpp = tcfg.pages_per_slot()
    for fill in (1, 3):
        state = np.zeros((2, 2 + mpp), np.int32)
        state[0, :2 + fill] = [5, 0, *range(1, fill + 1)]
        tgpt.decode_step_packed(tcfg, model, tgpt.clean_pages(tcfg), torch.from_numpy(state))
    assert seen and set(seen) == {mpp * tcfg.kv_page_size}
    for max_len, ps in [(64, 8), (64, 16), (100, 16), (17, 4)]:
        assert tgpt.tiny_config(max_len=max_len, kv_page_size=ps).pages_per_slot() == -(-max_len // ps)


# -- the reference's device pins, on the port ---------------------------------


def test_mixed_length_paged_greedy_decode_matches_generate(bridged):
    """Four prompts of different lengths decode in one slot batch against
    the paged pools and reproduce the reference ``gpt.generate`` greedy
    tokens exactly."""
    jcfg0, _tcfg0, params, _ = bridged
    _jcfg, tcfg, _params, model = _paged(bridged, ps=8, pages=64)
    mpp = tcfg.pages_per_slot()
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, tcfg.vocab_size, size=n).astype(np.int32) for n in (5, 8, 13, 3)]
    gens = [6, 4, 9, 7]
    expected = [
        np.asarray(jgpt.generate(jcfg0, params, jnp.asarray(p)[None], num_tokens=g))[0]
        for p, g in zip(prompts, gens)
    ]
    pages = tgpt.clean_pages(tcfg)
    state = np.zeros((4, 2 + mpp), np.int32)
    outs = [[] for _ in range(4)]
    next_free = 1
    for s, p in enumerate(prompts):
        need = -(-(len(p) + gens[s]) // 8)
        table = np.zeros((1, mpp), np.int32)
        table[0, :need] = range(next_free, next_free + need)
        next_free += need
        batch = np.zeros((1, 16 + 1 + mpp), np.int32)
        batch[0, :len(p)] = p
        batch[0, 17:] = table[0]
        picks, pages = tgpt.prefill_step_packed(tcfg, model, pages, torch.from_numpy(batch))
        first = int(picks[0, len(p) - 1])
        outs[s].append(first)
        state[s] = [first, len(p), *table[0]]
    sdev = torch.from_numpy(state)
    for _ in range(max(gens) - 1):
        emitted, sdev, pages = tgpt.decode_step_packed(tcfg, model, pages, sdev)
        for s, tok in enumerate(emitted.tolist()):
            if len(outs[s]) < gens[s]:
                outs[s].append(tok)
    for s in range(4):
        assert outs[s] == list(expected[s]), f"slot {s} diverged"


def test_chunked_prefill_matches_single_shot(bridged):
    """Two 8-token prefill chunks write the same pages as one 16-token
    prefill and continue with the same tokens, which are the reference
    ``gpt.generate``'s."""
    jcfg0, _tcfg0, params, _ = bridged
    _jcfg, tcfg, _params, model = _paged(bridged, ps=8, pages=16)
    mpp = tcfg.pages_per_slot()
    prompt = np.random.default_rng(5).integers(1, tcfg.vocab_size, size=16).astype(np.int32)
    g = 5
    expected = np.asarray(jgpt.generate(jcfg0, params, jnp.asarray(prompt)[None], num_tokens=g))[0]
    table = np.zeros(mpp, np.int32)
    table[:3] = [1, 2, 3]

    def prefill(chunks):
        pages = tgpt.clean_pages(tcfg)
        for base, c in chunks:
            batch = np.zeros((1, len(c) + 1 + mpp), np.int32)
            batch[0, :len(c)] = c
            batch[0, len(c)] = base
            batch[0, len(c) + 1:] = table
            picks, pages = tgpt.prefill_step_packed(tcfg, model, pages, torch.from_numpy(batch))
        return int(picks[0, -1]), pages

    first_1, pages_1 = prefill([(0, prompt)])
    first_2, pages_2 = prefill([(0, prompt[:8]), (8, prompt[8:])])
    assert first_1 == first_2
    for a, b in zip(tgpt.page_leaves(pages_1), tgpt.page_leaves(pages_2)):
        torch.testing.assert_close(a, b, atol=POOL_ATOL, rtol=0)
    out, state = [first_2], torch.tensor([[first_2, 16, *table]], dtype=torch.int32)
    for _ in range(g - 1):
        emitted, state, pages_2 = tgpt.decode_step_packed(tcfg, model, pages_2, state)
        out.append(int(emitted[0]))
    assert out == list(expected)
