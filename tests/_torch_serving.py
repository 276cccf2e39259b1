"""Shared helpers of the port's serving-layer tests
(``test_torch_kv_tier.py``, ``test_torch_disagg.py``,
``test_torch_kv_directory.py``, ``test_torch_decode_loop.py``,
``test_torch_fault_containment.py``).

Both backends' decode loops load the same parameters: the reference's
flax init of the tiny GPT in float32 (cached once a process), bridged to
a ``state_dict`` for the port. So a port executor and a JAX executor of
the same geometry generate the same greedy tokens, and the tests hold
them to each other exactly. Wherever the reference's gateway sees a port
replica it sees it as the node agent's table holds it:
:func:`agent` wraps it in ``AgentReplica`` over the reference's serving
module.
"""

from __future__ import annotations

import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tfk8s_tpu.api.types import (
    BatchingPolicy,
    DisaggregationPolicy,
    ObjectMeta,
    TPUServe,
    TPUServeSpec,
)
from tfk8s_tpu.client import FakeClientset
from tfk8s_tpu.gateway.server import GatewayServer
from tfk8s_tpu.models import gpt as jgpt
from tfk8s_tpu.parallel.sharding import unbox
from tfk8s_tpu.runtime import server as jserver
from tfk8s_tpu.utils.logging import Metrics as JMetrics
from tfk8s_tpu_torch import bridge
from tfk8s_tpu_torch.models import gpt as tgpt
from tfk8s_tpu_torch.runtime import server as tserver
from tfk8s_tpu_torch.runtime.agent_replica import AgentReplica
from tfk8s_tpu_torch.utils.logging import Metrics as TMetrics

from conftest import wait_for

PAGE, VERSION = 8, "seed:0"
# the reference tests' decoder: 4 slots, page 8, 64 pages, chunk 16
GEOMETRY = dict(slots=4, page_size=PAGE, max_pages=64, gen_tokens=8, size="tiny",
                prefill_chunk=16)


def tokens(n, seed=0, hi=64):
    return np.random.default_rng(seed).integers(1, hi, size=n).astype(np.int32)


@functools.lru_cache(maxsize=None)
def params():
    """(float32 tiny config, the reference's initial parameters as numpy);
    the init runs jitted: one compile costs less than dispatching its ops
    one at a time."""
    jcfg = jgpt.tiny_config(dtype=jnp.float32)
    init = jax.jit(jgpt.make_task(cfg=jcfg, seq_len=8, batch_size=1).init)
    return jcfg, jax.tree_util.tree_map(np.asarray, unbox(init(jax.random.key(0))))


@functools.lru_cache(maxsize=None)
def _state_dict():
    jcfg, tree = params()
    return bridge.params_to_state_dict(tree, tgpt.tiny_config(dtype=torch.float32))


def port_decoder(cls=None, **geometry):
    """A loaded port ``PagedGptDecoder`` (or subclass ``cls``) on the CPU
    over the bridged parameters; ``geometry`` overrides :data:`GEOMETRY`."""
    cls = cls or tserver.PagedGptDecoder
    dec = cls(VERSION, cfg=tgpt.tiny_config(dtype=torch.float32), device="cpu",
              params=_state_dict(), **{**GEOMETRY, **geometry})
    dec.load()
    return dec


def jax_decoder(**geometry):
    """The reference's ``PagedGptDecoder`` over the same parameters."""
    jcfg, tree = params()
    dec = jserver.PagedGptDecoder(VERSION, cfg=jcfg, params=tree, **{**GEOMETRY, **geometry})
    dec.load()
    return dec


class ThrottledDecoder(tserver.PagedGptDecoder):
    """Decode steps slowed to a fixed floor (the tiny model steps in well
    under a millisecond), so admission, retirement and a chaos hook
    interleave deterministically as seen from another thread."""

    step_sleep_s = 0.004

    def decode(self, state, samp=None):
        time.sleep(self.step_sleep_s)
        return super().decode(state, samp)


def port_exec(decoder=None, geometry=None, queue_limit=32, start=True, **kw):
    """A port ``DecodeLoopExecutor`` over ``decoder`` (a new one of
    ``geometry`` by default), with its own metrics."""
    decoder = decoder or port_decoder(**(geometry or {}))
    kw.setdefault("metrics", TMetrics())
    ex = tserver.DecodeLoopExecutor(decoder, queue_limit=queue_limit, **kw)
    return ex.start() if start else ex


def jax_exec(decoder=None, geometry=None, queue_limit=32, **kw):
    decoder = decoder or jax_decoder(**(geometry or {}))
    kw.setdefault("metrics", JMetrics())
    return jserver.DecodeLoopExecutor(decoder, queue_limit=queue_limit, **kw).start()


def agent(ex):
    """``ex`` as the node agent's serving table holds a port replica."""
    return AgentReplica(ex, jserver)


def greedy(ex, payload, timeout=60):
    return ex.submit(dict(payload), timeout=timeout)["tokens"]


def wait_until(pred, timeout=30.0):
    """``pred`` polled every millisecond (a throttled step is 4 ms)."""
    return wait_for(pred, timeout=timeout, interval=0.001)


# -- the reference's gateway over seeded phase tables ------------------------


def start_gateway():
    """A real ``GatewayServer`` on a socket over a fake clientset:
    (clientset, server, metrics)."""
    cs, metrics = FakeClientset(), JMetrics()
    server = GatewayServer(cs, port=0, metrics=metrics)
    server.serve_background()
    return cs, server, metrics


def stop_gateway(server):
    server.shutdown()
    server.server_close()


def serve_state(cs, server, name, prefill_keys, decode_keys, kv_tier=None):
    """A disaggregated gpt TPUServe whose phase tables are seeded directly
    (no kubelet), as the reference's ``make_disagg_state`` and
    ``make_kvtier_state`` do: the replicas are whatever the gateway's
    ``lookup_replica`` resolves the keys to. ``kv_tier`` (a
    ``KVTierPolicy``) turns on the cache directory."""
    cs.tpuserves().create(TPUServe(
        metadata=ObjectMeta(name=name),
        spec=TPUServeSpec(
            task="gpt", checkpoint=VERSION,
            batching=BatchingPolicy(max_batch_size=4, batch_timeout_ms=2.0, queue_limit=64,
                                    page_size=PAGE, max_pages=64),
            disaggregation=DisaggregationPolicy(prefill_replicas=len(prefill_keys),
                                                decode_replicas=len(decode_keys)),
            kv_tier=kv_tier,
        ),
    ))
    state = server.state_for("default", name)
    assert state.disagg
    for i, key in enumerate(prefill_keys):
        state.prefill.observe(key, float(i) * 0.01)
    for i, key in enumerate(decode_keys):
        state.decode.observe(key, float(i) * 0.01)
    return state

