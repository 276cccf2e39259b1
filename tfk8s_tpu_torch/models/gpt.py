"""GPT-style decoder-only causal LM, ported from the JAX package's
``models/gpt.py``: the shared stack with ``causal=True`` and a tied head,
next-token cross-entropy over shifted targets, the same hermetic chain
data, and the ``gpt:train`` TPUJob entrypoint
(``tfk8s_tpu_torch.models.gpt:train``).

``train`` keeps the reference's env contract and runs on one device: the
card unless ``TFK8S_DEVICE=cpu``. With ``TFK8S_ATTENTION_IMPL=flash`` (or
"auto" on the card at ``TFK8S_SEQ_LEN`` >= 1024) attention goes through
the port's CUDA flash kernels, forward and backward. Generation and
serving are ROADMAP items 1.4 and 1.6.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tfk8s_tpu_torch.models.bert import BertWithHead, make_chain_tokens
from tfk8s_tpu_torch.models.transformer import (
    TransformerConfig,
    init_params,
    select_attn_fn,
)
from tfk8s_tpu_torch.runtime.launcher import select_device
from tfk8s_tpu_torch.runtime.train import TrainTask, run_task


def GPTLM(cfg: TransformerConfig, attn_fn: Optional[Callable] = None) -> BertWithHead:
    """Decoder-only causal LM: the shared ``BertWithHead`` stack with
    ``causal=True``."""
    return BertWithHead(cfg, attn_fn=attn_fn, causal=True)


def base_config(**overrides) -> TransformerConfig:
    """GPT-2-small shape: 12 layers / 768 hidden / 12 heads / 3072 mlp."""
    kw = dict(
        vocab_size=32000, embed_dim=768, num_heads=12, head_dim=64,
        mlp_dim=3072, num_layers=12, max_len=1024,
    )
    kw.update(overrides)
    return TransformerConfig(**kw)


def tiny_config(**overrides) -> TransformerConfig:
    """Test-scale config (runs in seconds on the CPU)."""
    kw = dict(
        vocab_size=64, embed_dim=32, num_heads=4, head_dim=8,
        mlp_dim=64, num_layers=2, max_len=64,
    )
    kw.update(overrides)
    return TransformerConfig(**kw)


def mid_config(**overrides) -> TransformerConfig:
    """Serving-bench scale (the reference's ``mid_config``)."""
    kw = dict(
        vocab_size=256, embed_dim=128, num_heads=4, head_dim=32,
        mlp_dim=512, num_layers=4, max_len=256,
    )
    kw.update(overrides)
    return TransformerConfig(**kw)


def make_batch_fn(vocab: int, seq_len: int):
    def make_batch(rng: np.random.Generator, batch_size: int) -> Dict[str, np.ndarray]:
        toks = make_chain_tokens(rng, batch_size, seq_len, vocab)
        return {"input": toks.astype(np.int32)}

    return make_batch


def lm_loss_and_metrics(
    logits: torch.Tensor, ids: torch.Tensor
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token objective: position i predicts token i+1 (the final
    position has no target and is dropped)."""
    shift_logits = logits[:, :-1]
    shift_targets = ids[:, 1:].long()
    loss = F.cross_entropy(
        shift_logits.reshape(-1, shift_logits.shape[-1]), shift_targets.reshape(-1)
    )
    acc = (shift_logits.argmax(-1) == shift_targets).float().mean()
    return loss, {"next_token_accuracy": acc}


def make_task(
    cfg: Optional[TransformerConfig] = None,
    seq_len: int = 128,
    batch_size: int = 64,
    targets: Optional[Dict[str, float]] = None,
    attn_fn: Optional[Callable] = None,
) -> TrainTask:
    cfg = cfg or base_config()
    seq_len = min(seq_len, cfg.max_len)

    def init(generator: torch.Generator):
        return init_params(GPTLM(cfg, attn_fn=attn_fn), generator)

    def loss_fn(model, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        return lm_loss_and_metrics(model(batch["input"]), batch["input"])

    return TrainTask(
        name="gpt-lm",
        init=init,
        loss_fn=loss_fn,
        make_batch=make_batch_fn(cfg.vocab_size, seq_len),
        batch_size=batch_size,
        targets=targets or {},
    )


def task_for_mesh(
    device: torch.device,
    cfg: Optional[TransformerConfig] = None,
    **task_kw,
) -> TrainTask:
    """Build the task with the attention impl its device calls for. The
    port runs on one device, so the reference's mesh is just the device
    here (``transformer.select_attn_fn``)."""
    cfg = cfg or base_config()
    seq_len = min(task_kw.get("seq_len", 128), cfg.max_len)
    attn_fn = select_attn_fn(cfg, seq_len, device)
    return make_task(cfg=cfg, attn_fn=attn_fn, **task_kw)


def train(env: Dict[str, str], stop: Optional[Any] = None) -> List[Dict[str, float]]:
    """TPUJob entrypoint: ``tfk8s_tpu_torch.models.gpt:train``.
    ``TFK8S_MODEL_PRESET=tiny`` selects the test-scale config;
    ``TFK8S_ATTENTION_IMPL`` pins an attention impl. Returns the logged
    metrics history (the last entry is the final metrics)."""
    env = dict(env)
    env.setdefault("TFK8S_TRAIN_STEPS", "100")
    env.setdefault("TFK8S_LEARNING_RATE", "1e-4")
    seq = int(env.get("TFK8S_SEQ_LEN", "128"))
    batch = int(env.get("TFK8S_BATCH_SIZE", "64"))
    preset = tiny_config if env.get("TFK8S_MODEL_PRESET") == "tiny" else base_config
    cfg_kw = dict(
        num_experts=int(env.get("TFK8S_NUM_EXPERTS", "0")),
        moe_top_k=int(env.get("TFK8S_MOE_TOP_K", "1")),
        attention_impl=env.get("TFK8S_ATTENTION_IMPL", "auto"),
    )
    if env.get("TFK8S_VOCAB_SIZE"):
        cfg_kw["vocab_size"] = int(env["TFK8S_VOCAB_SIZE"])
    cfg = preset(**cfg_kw)
    device = select_device(env)
    task = task_for_mesh(device, cfg=cfg, seq_len=seq, batch_size=batch)
    return run_task(task, env, stop, device=device)
