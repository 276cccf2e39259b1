"""Shared helpers of the port's family parity tests
(``test_torch_bert.py``, ``test_torch_vit.py``, ``test_torch_t5.py``).

``trajectories`` runs the reference ``Trainer`` on a one-device mesh for a
few steps and the port's ``train(env)`` entrypoint from the same initial
parameters: the port's, bridged to the reference's tree (a flax init
would cost seconds of compile on the CPU). The port's run resumes a
step-0 checkpoint of its initial state (parameters and an untouched
optimizer), so it goes through the entrypoint's env contract, task and
trainer; both draw the same ``default_rng(seed + step)`` batch stream.

The test modules cache the reference's initial parameters per (config,
seed) (``functools.lru_cache``): a flax init's compile costs seconds on
the CPU, and the tests only read them.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tfk8s_tpu.parallel.mesh import make_mesh
from tfk8s_tpu.runtime import train as jtrain
from tfk8s_tpu_torch.runtime import train as ttrain
from tfk8s_tpu_torch.runtime.checkpoint import Checkpointer


def flat(tree, prefix=""):
    """A nested dict as ``{"a/b/c": array}``."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_trees_close(got, want, atol):
    got, want = flat(got), flat(want)
    assert got.keys() == want.keys()
    for name, arr in want.items():
        np.testing.assert_allclose(got[name], arr, atol=atol, err_msg=name)


def assert_trees_equal(got, want):
    got, want = flat(got), flat(want)
    assert got.keys() == want.keys()
    for name, arr in want.items():
        assert got[name].shape == arr.shape, name
        np.testing.assert_array_equal(got[name], arr, err_msg=name)


def trajectories(jtask, ttask, to_params, train, env, ckpt_dir, steps=3,
                 keys=("loss", "grad_norm")):
    """(``keys`` per step of the reference Trainer, the same of the port's
    ``train(env)``), from the port's initial parameters
    (``ttask.init``) bridged to the reference's tree by ``to_params``.
    ``ttask`` builds the model the entrypoint builds."""
    trainer = ttrain.Trainer(ttask, ttrain.TrainConfig(), torch.device("cpu"))
    state = trainer.init_state()
    Checkpointer(ckpt_dir).save(0, state.state_dict(), wait=True)
    params = jax.tree_util.tree_map(jnp.asarray, to_params(state.model.state_dict()))

    lr = float(env["TFK8S_LEARNING_RATE"])
    jtr = jtrain.Trainer(jtask, jtrain.TrainConfig(steps=steps, learning_rate=lr, log_every=1),
                         make_mesh(data=1))
    # placed as the Trainer places its own, so its step compiles once
    jstate = jax.device_put(jtrain.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                              opt_state=jtr.optimizer.init(params)),
                            jtr.state_shardings)
    _, jh = jtr.fit(state=jstate)
    th = train(dict(env, TFK8S_TRAIN_STEPS=str(steps), TFK8S_LOG_EVERY="1",
                    TFK8S_CHECKPOINT_DIR=ckpt_dir, TFK8S_WORLD_VERSION="1"))
    assert [h["step"] for h in th] == [h["step"] for h in jh] == list(range(1, steps + 1))
    return ([tuple(h[k] for k in keys) for h in jh], [tuple(h[k] for k in keys) for h in th])
