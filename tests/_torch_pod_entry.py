"""Entry points the pod-rank tests run (``tests/test_torch_pod_ranks.py``).

No JAX here: a pod's rank processes import this module to resolve the
entry point they were started on. Each is a family's ``train`` at its
tiny preset in float32 (the presets are bfloat16, like the reference's,
and a spawned pod is held to one process at rtol 1e-5), wrapped as a
family's entry point is (``pod_ranks.entrypoint``), so a pod whose mesh
is larger than its processes runs its ranks on it.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Any, Dict, Optional

import torch

from tfk8s_tpu_torch.models import bert, gpt, t5
from tfk8s_tpu_torch.runtime import pod_ranks
from tfk8s_tpu_torch.runtime import train as ttrain


@contextlib.contextmanager
def float32(*modules):
    saved = [(m, m.tiny_config) for m in modules]
    for m, preset in saved:
        m.tiny_config = functools.partial(preset, dtype=torch.float32)
    try:
        yield
    finally:
        for m, preset in saved:
            m.tiny_config = preset


@pod_ranks.entrypoint
def t5_f32(env: Dict[str, str], stop: Optional[Any] = None):
    with float32(t5):
        return t5.train(env, stop)


@pod_ranks.entrypoint
def gpt_f32(env: Dict[str, str], stop: Optional[Any] = None):
    with float32(gpt, bert):
        return gpt.train(env, stop)


@pod_ranks.entrypoint
def gpt_failing(env: Dict[str, str], stop: Optional[Any] = None):
    """:func:`gpt_f32`, whose local rank 1 raises at its first step."""
    if env.get("TFK8S_LOCAL_RANK") == "1":
        def planted(self, state, batch):
            raise RuntimeError(f"planted failure at step {state.step + 1}")

        ttrain.Trainer.train_step = planted
    return gpt_f32(env, stop)


@pod_ranks.entrypoint
def gpt_drained_by_rank1(env: Dict[str, str], stop: Optional[Any] = None):
    """:func:`gpt_f32`, whose local rank 1 alone takes a reclaim notice
    once it has run two steps: the ranks must agree to drain there."""
    if env.get("TFK8S_LOCAL_RANK") == "1":
        step = ttrain.Trainer.train_step

        def noticed(self, state, batch):
            metrics = step(self, state, batch)
            if state.step == 2:
                stop.request_drain()
            return metrics

        ttrain.Trainer.train_step = noticed
    return gpt_f32(env, stop)
