#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/H100 port (``tfk8s_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package. Phases, each of which
must pass:

1. the card: ``nvidia-smi`` name and power limit;
2. build: ``nvcc`` compiles every kernel source of the port from the
   checkout (``tfk8s_tpu_torch/ops/_build.py``), timed, with the ptxas
   register and spill report of the kernels the slice launches;
3. kernels: each flash-attention kernel (forward, dq, dk/dv) against its
   plain PyTorch version on the same card inputs: the slice's shape in
   bfloat16 (atol 2e-2 + rtol 2^-7) and small float32 cases (a key mask with a fully
   masked row, causal with lq < lk, ragged lengths; atol 1e-5 outputs,
   1e-4 gradients), each with its time, the plain version's time, its
   bound and the ``scaled_dot_product_attention`` yardstick (timed here
   only; the port never calls it);
4. reference: a small float32 GPT on the card through the kernels
   against the same model on the CPU through the plain versions (loss
   and every gradient to atol 1e-4), and the base-width bfloat16 model's
   loss through the kernels against plain attention (atol 2e-2);
5. train: ``tfk8s_tpu_torch.models.gpt.train(env)``, the ``gpt:train``
   entrypoint, at the GPT-2-small base preset (seq 1024, batch 8,
   ``TFK8S_ATTENTION_IMPL=flash``) for a few steps with a checkpoint:
   finite losses, each kernel launched 12 times a step, the checkpoint
   committed at the last step. The launch counts are zeroed just before
   and read just after this run.

Then it prints the ``kernels`` JSON line and, last, the ``ok`` line. It
exits non-zero, printing no result, when a phase fails, when no card is
visible, or when the port's package is not beside it.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
import traceback

DEVICE = "cuda"
TRAIN_STEPS = 10
# the gpt:train run: GPT-2-small base preset, seq 1024, batch 8, flash
TRAIN_ENV = {
    "TFK8S_SEQ_LEN": "1024", "TFK8S_BATCH_SIZE": "8", "TFK8S_ATTENTION_IMPL": "flash",
    "TFK8S_TRAIN_STEPS": str(TRAIN_STEPS), "TFK8S_LOG_EVERY": "1",
    "TFK8S_LEARNING_RATE": "3e-4", "TFK8S_SEED": "0",
}
SLICE = dict(b=8, l=1024, h=12, d=64)  # its attention: 12 heads of 64
BASE_CHECK = dict(preset="base_config", seq=1024, batch=2)  # bf16 reference check
# bf16 outputs: atol 2e-2 plus one bf16 rounding step (2^-7 of the value),
# since gradients reach magnitudes where one step exceeds 2e-2
BF16_ATOL, BF16_RTOL = 2e-2, 2.0 ** -7
F32_OUT_ATOL, F32_GRAD_ATOL = 1e-5, 1e-4
# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and FLOP/s by type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
REPLACES = {
    "flash_fwd": "tfk8s_tpu/ops/flash_attention.py:149",
    "flash_bwd_dq": "tfk8s_tpu/ops/flash_attention.py:233",
    "flash_bwd_dkv": "tfk8s_tpu/ops/flash_attention.py:290",
}
SOURCE = "tfk8s_tpu_torch/ops/csrc/flash_attention.cu"


def log(msg: str) -> None:
    print(msg, flush=True)


def _time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events)."""
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


class Case:
    """One attention problem on the card: inputs, visibility, and the
    work each kernel must do on them."""

    def __init__(self, name, b, lq, lk, h, d, dtype, causal=False, lengths=None, seed=0):
        import torch

        self.name, self.causal = name, causal
        self.dtype_name = str(dtype).replace("torch.", "")
        gen = torch.Generator(device=DEVICE).manual_seed(seed)

        def normal(*shape):
            return torch.randn(*shape, generator=gen, device=DEVICE).to(dtype)

        self.q = (normal(b, lq, h, d).float() / math.sqrt(d)).to(dtype)  # pre-scaled
        self.k, self.v, self.do = normal(b, lk, h, d), normal(b, lk, h, d), normal(b, lq, h, d)
        self.mask = None
        if lengths is not None:
            pos = torch.arange(lk, device=DEVICE)
            self.mask = pos[None, :] < torch.tensor(lengths, device=DEVICE)[:, None]
        vis = torch.ones(lq, lk, dtype=torch.bool, device=DEVICE)
        if causal:
            vis = vis.tril(lk - lq)
        vis = vis[None, None].expand(b, 1, lq, lk)
        if self.mask is not None:
            vis = vis & self.mask[:, None, None, :]
        self.visible = vis  # [b, 1, lq, lk], for the library yardstick
        # (query, key) pairs this data needs, per head
        self.pairs = int(vis.sum().item()) * h
        self.elt = self.q.element_size()
        self.n_q, self.n_k = b * lq * h * d, b * lk * h * d
        self.n_lse = b * h * lq
        self.d = d

    def bound_ms(self, kernel: str):
        """Least time on the card: the larger of bytes over the memory
        rate and FLOPs over the peak rate for the inputs' type."""
        e, qn, kn, lse = self.elt, self.n_q, self.n_k, 4 * self.n_lse
        if kernel == "flash_fwd":
            nbytes = e * (qn + 2 * kn + qn) + lse        # q, k, v in; o, lse out
            flops = 4 * self.pairs * self.d              # QK^T, PV
        elif kernel == "flash_bwd_dq":
            nbytes = e * (qn + 2 * kn + 2 * qn + qn) + lse  # q k v do o lse in; dq out
            flops = 6 * self.pairs * self.d              # QK^T, dO V^T, dS K
        else:
            nbytes = e * (qn + 2 * kn + 2 * qn + 2 * kn) + lse  # ...; dk, dv out
            flops = 8 * self.pairs * self.d              # QK^T, dO V^T, P^T dO, dS^T Q
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[self.dtype_name] * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _library(case: Case):
    """``scaled_dot_product_attention`` on the same problem, [b, h, l, d]
    (the transposes are made once, outside the timed calls)."""
    import torch
    import torch.nn.functional as F

    q, k, v = (t.transpose(1, 2).contiguous().requires_grad_() for t in (case.q, case.k, case.v))
    do = case.do.transpose(1, 2).contiguous()
    dense = case.mask is None and (not case.causal or q.shape[2] == k.shape[2])
    kw = dict(is_causal=case.causal) if dense else dict(attn_mask=case.visible)

    def fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(q, k, v, scale=1.0, **kw)

    out = F.scaled_dot_product_attention(q, k, v, scale=1.0, **kw)

    def bwd():
        return torch.autograd.grad(out, (q, k, v), do, retain_graph=True)

    return fwd, bwd


def check_case(fa, case: Case, iters: int):
    """Each kernel against its plain version on ``case``; returns one
    result dict per kernel."""
    import torch

    bf16 = case.dtype_name == "bfloat16"
    out_tol = BF16_ATOL if bf16 else F32_OUT_ATOL
    grad_tol = BF16_ATOL if bf16 else F32_GRAD_ATOL
    rtol = BF16_RTOL if bf16 else 0.0
    q, k, v, do, mask, causal = case.q, case.k, case.v, case.do, case.mask, case.causal

    o_k, lse_k = fa.flash_fwd_cuda(q, k, v, mask, causal)
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, mask, causal)
    dq_k = fa.flash_bwd_dq_cuda(q, k, v, do, o_k, lse_k, mask, causal)
    dq_p = fa.flash_bwd_dq_plain(q, k, v, do, o_k, lse_k, mask, causal)
    dk_k, dv_k = fa.flash_bwd_dkv_cuda(q, k, v, do, o_k, lse_k, mask, causal)
    dk_p, dv_p = fa.flash_bwd_dkv_plain(q, k, v, do, o_k, lse_k, mask, causal)
    torch.cuda.synchronize()

    def err(pairs, atol):
        """(max |kernel - plain|, whether every element is within
        atol + rtol * |plain|)"""
        worst, ok = 0.0, True
        for a, b in pairs:
            diff = (a.float() - b.float()).abs()
            worst = max(worst, float(diff.max()))
            ok = ok and bool((diff <= atol + rtol * b.float().abs()).all())
        return worst, ok

    live = lse_p > -1e29
    errs = {
        "flash_fwd": err([(o_k, o_p), (lse_k[live], lse_p[live])], out_tol),
        "flash_bwd_dq": err([(dq_k, dq_p)], grad_tol),
        "flash_bwd_dkv": err([(dk_k, dk_p), (dv_k, dv_p)], grad_tol),
    }
    tols = {"flash_fwd": out_tol, "flash_bwd_dq": grad_tol, "flash_bwd_dkv": grad_tol}
    for name, t in (("o", o_k), ("dq", dq_k), ("dk", dk_k), ("dv", dv_k)):
        if not torch.isfinite(t).all():
            raise AssertionError(f"{case.name}: kernel {name} is not finite")
    if mask is not None and (~mask).all(dim=1).any():
        dead = (~mask).all(dim=1)
        for name, t in (("o", o_k), ("dq", dq_k)):
            if t[dead].abs().max() != 0:
                raise AssertionError(f"{case.name}: fully masked row gives nonzero {name}")

    lib_fwd, lib_bwd = _library(case)
    runs = {
        "flash_fwd": (lambda: fa.flash_fwd_cuda(q, k, v, mask, causal),
                      lambda: fa.flash_fwd_plain(q, k, v, mask, causal), lib_fwd),
        "flash_bwd_dq": (lambda: fa.flash_bwd_dq_cuda(q, k, v, do, o_k, lse_k, mask, causal),
                         lambda: fa.flash_bwd_dq_plain(q, k, v, do, o_k, lse_k, mask, causal),
                         lib_bwd),
        "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv_cuda(q, k, v, do, o_k, lse_k, mask, causal),
                          lambda: fa.flash_bwd_dkv_plain(q, k, v, do, o_k, lse_k, mask, causal),
                          lib_bwd),
    }
    results = []
    for name, (kern, plain, lib) in runs.items():
        bound, by = case.bound_ms(name)
        r = {
            "case": case.name, "kernel": name, "dtype": case.dtype_name,
            "max_abs_err": errs[name][0], "atol": tols[name], "rtol": rtol,
            "ms": _time_ms(kern, iters), "plain_ms": _time_ms(plain, max(iters // 4, 1)),
            "bound_ms": bound, "bound_by": by, "library_ms": _time_ms(lib, iters),
        }
        log(f"  {json.dumps(r)}")
        if not errs[name][1]:
            raise AssertionError(f"{case.name}/{name}: beyond atol {tols[name]} rtol {rtol}")
        results.append(r)
    return results


def phase_card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def phase_build(_build):
    seconds, logs = _build.build_all(verbose=True)
    log(f"build: {seconds:.1f} s for {list(_build.SOURCES)}")
    # ptxas report of the kernels the slice launches (bf16, head_dim 64)
    # and every instantiation that spills registers
    entry = None
    for line in "\n".join(logs.values()).splitlines():
        m = re.search(r"entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            continue
        if entry is None or not ("registers" in line or "spill" in line):
            continue
        spills = re.search(r"[1-9]\d* bytes spill", line) is not None
        if "__nv_bfloat16Li64E" in entry or spills:
            name = re.search(r"tfk8s_\w+?_kernel", entry)
            inst = re.search(r"I(f|13__nv_bfloat16)Li(\d+)E", entry)
            tag = f"{name.group(0) if name else entry}"
            if inst:
                tag += f"<{'bf16' if inst.group(1) != 'f' else 'f32'}, d={inst.group(2)}>"
            log(f"  ptxas {tag}: {line.split(':', 1)[-1].strip()}")


def phase_kernels(fa, torch):
    s = SLICE
    cases = [
        Case("slice_bf16_causal", s["b"], s["l"], s["l"], s["h"], s["d"], torch.bfloat16,
             causal=True, seed=1),
        Case("f32_key_mask_dead_row", 2, 96, 96, 3, 64, torch.float32,
             lengths=[70, 0], seed=2),
        Case("f32_causal_lq_lt_lk", 2, 77, 130, 3, 64, torch.float32, causal=True, seed=3),
        Case("f32_ragged_causal_mask", 3, 200, 200, 2, 64, torch.float32, causal=True,
             lengths=[200, 131, 5], seed=4),
        Case("bf16_ragged_d128", 2, 150, 150, 2, 128, torch.bfloat16, causal=True, seed=5),
    ]
    slice_results = None
    for i, case in enumerate(cases):
        log(f"case {case.name}:")
        res = check_case(fa, case, iters=20 if i == 0 else 5)
        if i == 0:
            slice_results = res
    return slice_results


def phase_reference(torch, gpt, fa):
    """Small f32 GPT: kernels on the card vs plain versions on the CPU;
    base-width bf16 loss: kernels vs plain attention on the card."""
    import copy

    import numpy as np

    cfg = gpt.mid_config(dtype=torch.float32)
    task = gpt.make_task(cfg, seq_len=64, batch_size=2, attn_fn=fa.flash_attention)
    cpu = task.init(torch.Generator().manual_seed(0))
    card = copy.deepcopy(cpu).to(DEVICE)
    ids = torch.from_numpy(task.make_batch(np.random.default_rng(0), 2)["input"])
    losses, grads = [], []
    for model, dev in ((cpu, "cpu"), (card, DEVICE)):
        x = ids.to(dev)
        loss, _ = gpt.lm_loss_and_metrics(model(x), x)
        loss.backward()
        losses.append(loss.item())
        grads.append({n: p.grad.cpu() for n, p in model.named_parameters()})
    g_err = max(float((grads[0][n] - grads[1][n]).abs().max()) for n in grads[0])
    l_err = abs(losses[0] - losses[1])
    log(f"reference f32 mid: loss cpu {losses[0]:.6f} card {losses[1]:.6f} "
        f"err {l_err:.2e}, max grad err {g_err:.2e} (atol {F32_GRAD_ATOL})")
    if not (l_err <= F32_GRAD_ATOL and g_err <= F32_GRAD_ATOL):
        raise AssertionError("card kernels disagree with the CPU plain path")

    cfg = getattr(gpt, BASE_CHECK["preset"])()
    seq, batch = BASE_CHECK["seq"], BASE_CHECK["batch"]
    base = gpt.make_task(cfg, seq_len=seq, batch_size=batch).init(torch.Generator().manual_seed(1))
    base = base.to(DEVICE)
    ids = torch.from_numpy(
        gpt.make_batch_fn(cfg.vocab_size, seq)(np.random.default_rng(1), batch)["input"]
    ).to(DEVICE)
    out = {}
    with torch.no_grad():
        for impl, fn in (("full", None), ("flash", fa.flash_attention)):
            for layer in base.layers:
                layer.attn.attn_fn = fn
            logits = base(ids)
            if not torch.isfinite(logits).all() or logits.shape != (batch, seq, cfg.vocab_size):
                raise AssertionError(f"base {impl}: bad logits {tuple(logits.shape)}")
            out[impl] = gpt.lm_loss_and_metrics(logits, ids)[0].item()
    err = abs(out["full"] - out["flash"])
    log(f"reference bf16 base: loss full {out['full']:.6f} flash {out['flash']:.6f} "
        f"err {err:.2e} (atol {BF16_ATOL})")
    if not err <= BF16_ATOL:
        raise AssertionError("base-width flash loss disagrees with plain attention")


def phase_train(torch, gpt, fa, ckpt_dir):
    from tfk8s_tpu_torch.runtime.checkpoint import Checkpointer

    env = dict(TRAIN_ENV, TFK8S_CHECKPOINT_DIR=ckpt_dir)
    tiny = env.get("TFK8S_MODEL_PRESET") == "tiny"
    layers = (gpt.tiny_config() if tiny else gpt.base_config()).num_layers
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    t0 = time.perf_counter()
    history = gpt.train(env)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses = [h["loss"] for h in history]
    # history[i] has steps_per_s = step_i / (t_i - t0): steady-state step
    # time from the first and last entries leaves the first step out
    t_first = history[0]["step"] / history[0]["steps_per_s"]
    t_last = history[-1]["step"] / history[-1]["steps_per_s"]
    step_s = (t_last - t_first) / (history[-1]["step"] - history[0]["step"])
    tokens = int(env["TFK8S_BATCH_SIZE"]) * int(env["TFK8S_SEQ_LEN"])
    summary = {
        "steps": TRAIN_STEPS, "wall_s": wall, "first_step_s": t_first,
        "step_ms": step_s * 1e3, "tokens_per_s": tokens / step_s,
        "peak_mem_gib": peak_gib, "first_loss": losses[0], "last_loss": losses[-1],
        "launches": launches,
    }
    log(f"train: {json.dumps(summary)}")
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"losses not finite: {losses}")
    for name in fa.KERNELS:  # one launch per layer and step
        if launches[name] != layers * TRAIN_STEPS:
            raise AssertionError(f"{name} launched {launches[name]} times, "
                                 f"want {layers * TRAIN_STEPS}")
    latest = Checkpointer(ckpt_dir).latest_step()
    log(f"checkpoint: latest_step {latest}")
    if latest != TRAIN_STEPS:
        raise AssertionError(f"latest committed step {latest}, want {TRAIN_STEPS}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "tfk8s_tpu_torch")):
        print("chip_smoke: the tfk8s_tpu_torch package is not beside this script",
              file=sys.stderr)
        return 2
    from tfk8s_tpu_torch.models import gpt
    from tfk8s_tpu_torch.ops import _build
    from tfk8s_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    ckpt_dir = os.path.join(root, "build", "chip_smoke_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    failed, slice_results, launches = [], None, None
    card_line = None
    phases = [
        ("card", phase_card),
        ("build", lambda: phase_build(_build)),
        ("kernels", lambda: phase_kernels(fa, torch)),
        ("reference", lambda: phase_reference(torch, gpt, fa)),
        ("train", lambda: phase_train(torch, gpt, fa, ckpt_dir)),
    ]
    for name, run in phases:
        log(f"== {name}")
        t0 = time.perf_counter()
        try:
            value = run()
            torch.cuda.synchronize()
        except Exception:  # noqa: BLE001 — every phase reports, then the run fails
            traceback.print_exc()
            failed.append(name)
            if name == "build":
                break  # nothing after it can launch a kernel
            continue
        finally:
            log(f"== {name}: {time.perf_counter() - t0:.1f} s")
        if name == "card":
            card_line = value
            log(f"card: {card_line}")
        elif name == "kernels":
            slice_results = value
        elif name == "train":
            launches = value
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    kernels = []
    for r in slice_results:
        kernels.append({
            "name": r["kernel"], "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[r["kernel"]], "launches": launches[r["kernel"]],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    print(card_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
