"""The port's DLRM against the JAX package's, on the same parameters.

The reference's ``DLRM`` is initialised in JAX, its tree goes through
``bridge.dlrm_params_to_state_dict`` into the port's model, and the same
numpy batch (``make_batch_fn``, byte for byte) goes to both. The
reference fixes bfloat16 compute (``tfk8s_tpu/models/dlrm.py:43``, ``:95``,
``:97``, ``:106``), so the two sides round at every dense layer, looked-up
row and interaction product; one bfloat16 step at |x| ~ 1 is 2^-8, above
the float32 models' atol 1e-4. They are held to the bf16 model bounds in
force (ROADMAP queue 3, the bf16 ResNet's): logits atol 2e-2, loss atol
1e-2, every gradient within 5e-2 relative L2, with the JAX side compiled
without excess precision so it rounds where eager code does. A three-step
``dlrm:train`` run follows the reference ``Trainer`` (``run_task``'s
loop) within loss atol 1e-2 and grad norm rtol 5e-2. The ``{"tensor":
2}`` gang is in ``test_torch_tensor_parallel.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tfk8s_tpu.models import dlrm as jdlrm
from tfk8s_tpu.parallel.sharding import unbox
from tfk8s_tpu_torch import bridge
from tfk8s_tpu_torch.models import dlrm as tdlrm
from tfk8s_tpu_torch.parallel.collectives import vocab_parallel_lookup

from _torch_parity import assert_trees_equal, flat, numpy_tree, trajectories
import _torch_threads  # noqa: F401  (torch's threads under xdist)

VOCAB, EMBED, DENSE, BATCH = (101, 64, 37), 16, 13, 32
LOGIT_ATOL, LOSS_ATOL, GRAD_REL, NORM_RTOL = 2e-2, 1e-2, 5e-2, 5e-2


@functools.lru_cache(maxsize=None)
def _jax_params(seed=0):
    task = jdlrm.make_task(vocab_sizes=VOCAB, embed_dim=EMBED, batch_size=BATCH)
    return numpy_tree(unbox(jax.jit(task.init)(jax.random.key(seed))))


def _batch(seed):
    return jdlrm.make_batch_fn(VOCAB, DENSE)(np.random.default_rng(seed), BATCH)


@pytest.mark.parametrize("vocab,batch,seed", [(VOCAB, 32, 0), (tdlrm.DEFAULT_VOCAB_SIZES, 64, 3)])
def test_batches_equal_the_reference(vocab, batch, seed):
    want = jdlrm.make_batch_fn(vocab, DENSE)(np.random.default_rng(seed), batch)
    got = tdlrm.make_batch_fn(vocab, DENSE)(np.random.default_rng(seed), batch)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert 0 < got["click"].mean() < 1


def test_bridge_round_trip_and_defaults():
    params = _jax_params(1)
    model = tdlrm.DLRM(VOCAB, embed_dim=EMBED)
    sd = bridge.dlrm_params_to_state_dict(params)
    assert set(model.state_dict()) == set(sd)
    model.load_state_dict(sd)
    assert_trees_equal(bridge.dlrm_state_dict_to_params(model.state_dict()), params)
    j, t = jdlrm.make_task.__defaults__, tdlrm.make_task.__defaults__
    assert t[:4] == j[:4]  # vocab sizes, embed dim, dense features, batch
    want = jdlrm.DLRM(vocab_sizes=VOCAB)
    assert (want.top_layers, want._bottom()) == (tdlrm.DLRM(VOCAB).top.widths,
                                                  tdlrm.DLRM(VOCAB).bottom.widths)


def _jax_step(params, batch):
    """The reference's loss, logit and gradient tree on ``batch``."""
    model = jdlrm.DLRM(vocab_sizes=VOCAB, embed_dim=EMBED, dense_features=DENSE)

    def jloss(p):
        logit = model.apply({"params": p}, batch["dense"], batch["sparse"])
        return jnp.mean(optax.sigmoid_binary_cross_entropy(logit, batch["click"])), logit

    step = jax.jit(jax.value_and_grad(jloss, has_aux=True)).lower(params).compile(
        compiler_options={"xla_allow_excess_precision": False})
    (loss, logit), grads = step(params)
    return float(loss), np.asarray(logit), flat(numpy_tree(grads))


def _port_step(params, batch):
    """The port's logit, loss, metrics and flat gradient on ``batch``."""
    port = tdlrm.DLRM(VOCAB, embed_dim=EMBED, dense_features=DENSE)
    port.load_state_dict(bridge.dlrm_params_to_state_dict(params))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    logit = port(tb["dense"], tb["sparse"])
    loss, metrics = tdlrm.loss_and_metrics(logit, tb["click"])
    loss.backward()
    grads = flat(bridge.dlrm_state_dict_to_params({n: p.grad for n, p in port.named_parameters()}))
    return logit, loss, metrics, grads


def _rel_l2(got, want, names):
    err = sum(float(np.sum((got[n] - want[n]) ** 2)) for n in names)
    return np.sqrt(err / sum(float(np.sum(want[n] ** 2)) for n in names))


def _table_rel_l2(got, want):
    """Each table's own relative L2: the tables take their gradient only
    through the interaction and hold about 0.1% of the whole gradient's
    squared norm, so the global figure cannot see them."""
    return {n: _rel_l2(got, want, [n]) for n in want if n.startswith("table")}


def test_logits_loss_and_grads_match_jax():
    params, batch = _jax_params(2), _batch(2)
    want_loss, want_logit, want = _jax_step(params, batch)
    logit, loss, metrics, got = _port_step(params, batch)
    assert logit.dtype == torch.float32 and logit.shape == (BATCH,)
    np.testing.assert_allclose(logit.detach().numpy(), want_logit, atol=LOGIT_ATOL, rtol=0)
    assert abs(loss.item() - want_loss) <= LOSS_ATOL
    want_acc = np.mean((want_logit > 0) == (batch["click"] > 0.5))
    assert abs(float(metrics["click_accuracy"]) - want_acc) <= 2 / BATCH
    assert got.keys() == want.keys()
    assert _rel_l2(got, want, want) <= GRAD_REL, _rel_l2(got, want, want)
    # every weight matrix and every table on its own (a bias is a sum over
    # the batch that can cancel: top/fc2/bias, one scalar, reads 5.5e-2)
    leaves = {n: _rel_l2(got, want, [n]) for n in want if not n.endswith("bias")}
    assert len([n for n in leaves if n.startswith("table")]) == len(VOCAB)
    assert max(leaves.values()) <= GRAD_REL, leaves
    assert all(np.any(g != 0) for g in got.values())  # no vacuous zero gradient


def _scaled_lookup(table, ids, lo, group):
    # planted: the looked-up rows' gradient 1.1 times what it should be
    rows = vocab_parallel_lookup(table, ids, lo, group)
    return rows * 1.1 - rows.detach() * 0.1


def _one_sided_einsum(eq, a, b):
    # planted: the interaction's gradient reaches only its left operand
    return _einsum(eq, a, b.detach()) if eq == "bne,bme->bnm" else _einsum(eq, a, b)


_einsum = torch.einsum


@pytest.mark.parametrize("fault", ["table_grad_x1.1", "one_sided_interaction"])
def test_planted_table_gradient_fault_exceeds_the_bound(fault, monkeypatch):
    """A table gradient scaled by 1.1, or an interaction backward that
    skips one operand, must exceed GRAD_REL on some table. The global
    relative L2 stays under it (3.6e-3 and 3.5e-2): the dense layers
    dominate the norm, hence the per-table check above."""
    if fault == "table_grad_x1.1":
        monkeypatch.setattr(tdlrm, "vocab_parallel_lookup", _scaled_lookup)
    else:
        monkeypatch.setattr(torch, "einsum", _one_sided_einsum)
    params, batch = _jax_params(2), _batch(2)
    _, _, want = _jax_step(params, batch)
    _, _, _, got = _port_step(params, batch)
    tables = _table_rel_l2(got, want)
    assert min(tables.values()) > GRAD_REL if fault == "table_grad_x1.1" else \
        max(tables.values()) > GRAD_REL, tables


def test_three_steps_follow_the_reference(tmp_path):
    env = {"TFK8S_DEVICE": "cpu", "TFK8S_LEARNING_RATE": "1e-3", "TFK8S_BATCH_SIZE": str(BATCH),
           "TFK8S_VOCAB_SIZES": ",".join(map(str, VOCAB)), "TFK8S_EMBED_DIM": str(EMBED)}
    kw = dict(vocab_sizes=VOCAB, embed_dim=EMBED, batch_size=BATCH)
    want, got = trajectories(jdlrm.make_task(**kw), tdlrm.make_task(**kw),
                             bridge.dlrm_state_dict_to_params, tdlrm.train, env,
                             str(tmp_path / "ckpt"))
    want, got = np.array(want), np.array(got)
    np.testing.assert_allclose(got[:, 0], want[:, 0], atol=LOSS_ATOL, rtol=0)
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=NORM_RTOL)
    assert got[-1, 0] < got[0, 0]
