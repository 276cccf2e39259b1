#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/H100 port (``tfk8s_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package. Phases, each of which
must pass:

1. the card: ``nvidia-smi`` name and power limit;
2. build: ``nvcc`` compiles every kernel source of the port from the
   checkout (``tfk8s_tpu_torch/ops/_build.py``), timed, with the ptxas
   register and spill report of the tensor-core flash kernels and the
   one-read GroupNorm kernels (none may spill) and the block copy;
3. kernels: each kernel against its plain PyTorch version on the same
   card inputs, each with its time, the plain version's time, its bound
   and a one-call PyTorch yardstick (timed here only; the port never
   calls it):
   - flash attention: in bfloat16 the tensor-core forward, the D
     pre-pass, the tensor-core dq and dk/dv, and the whole backward
     (pre-pass + dq + dk/dv, as training runs it), at the GPT slice's
     shape, a ragged d=128 case and a masked d=32 case (atol 2e-2 + rtol
     2^-7; D and lse * log2(e) atol 1e-5); in float32 the CUDA-core
     forward, dq and dk/dv on small cases (a key mask with a fully masked
     row, causal with lq < lk, ragged lengths; atol 1e-5 outputs, 1e-4
     gradients); the slice's FLOPs at d=128 with half the heads; each with
     its achieved TFLOP/s; yardstick ``scaled_dot_product_attention``
     (its backward for dq, dk/dv and the whole backward: no PyTorch call
     computes dq alone); at the slice's shape also each row's device time
     and its yardstick's from a ``torch.profiler`` trace, which leave out
     the host time that CUDA events over back-to-back calls of a short
     kernel or of an autograd call include;
   - GroupNorm forward and backward, float32 and bfloat16, through the
     one-read kernels at the two largest ResNet-50 norm sites
     [256,112,112,64] (ReLU) and [256,56,56,256], the widest
     [256,7,7,2048] (ReLU) and ResNet-50 at width 128's [64,7,7,4096]
     (ReLU), and through the two-read kernels at [16,256,256,32] in one
     group, each launch counted under the path the layout rule gives it;
     float32 atol 1e-5 outputs, 1e-4 dx, bfloat16 atol 2e-2 + rtol 2^-7,
     dscale and dbias atol 1e-2 + rtol 1e-3; device times from the
     profiler beside CUDA-event times; yardstick ``F.group_norm`` (+
     ``relu``) on the channels-last NCHW view and its autograd backward;
     then every ResNet-50 norm site's shape once
     (``tfk8s_tpu_torch/tools/gn_sweep.py``), for the per-step GroupNorm
     device and event times against the bounds;
   - the block copy at [8192, 8192] float32, bit-exact; yardstick
     ``Tensor.copy_``;
4. reference: a small float32 GPT on the card through the kernels
   against the same model on the CPU through the plain versions (loss
   and every gradient to atol 1e-4), and the base-width bfloat16 model's
   forward and backward through the kernels against plain attention:
   loss atol 2e-2, the key/value projections' gradients within
   BASE_GRAD_REL_L2 relative L2 and the query projection's within
   BASE_Q_GRAD_REL_L2, bounds that a planted dk/dv fault and a planted dq
   fault (D taken as zero) must exceed;
5. resnet reference: a small float32 ResNet-50 (width 8) on the card
   through the GroupNorm kernels against the same model on the CPU through
   the plain versions (loss atol 1e-4, gradients 1e-3 relative L2; every
   one of the 53 norms through the one-read kernels), and
   ResNet-50 at full width on one input, kernel GroupNorm against plain
   GroupNorm: in float32, logits within 1e-4 of the largest logit; in
   bfloat16 within 2%, where a sound variant of the plain GroupNorm must
   pass that bound and planted faults must fail it;
6. train: ``tfk8s_tpu_torch.models.gpt.train(env)``, the ``gpt:train``
   entrypoint, at the GPT-2-small base preset (seq 1024, batch 8,
   ``TFK8S_ATTENTION_IMPL=flash``) for a few steps with a checkpoint:
   finite losses, the tensor-core forward, D pre-pass, dq and dk/dv each
   launched 12 times a step and the CUDA-core float32 kernels never, the
   checkpoint committed at the last step;
7. resnet train: ``tfk8s_tpu_torch.models.resnet.train(env)``, the
   ``resnet:train`` entrypoint, at ResNet-50 (depth 50, width 64, batch
   256, image 224, 1000 classes, bfloat16) for a few steps with a
   checkpoint: finite losses, each one-read GroupNorm kernel launched 53
   times a step and the two-read kernels never, the checkpoint
   committed; step time, images/s, first step, peak memory, input wait
   and input-starved steps;
8. roofline: ``tfk8s_tpu_torch.tools.roofline.run_all()`` at full size
   (matmul, streams, the block-copy kernel, ResNet-50 forward, GN-ablated
   step and full step), one JSON line; the copy kernel must launch.

The launch counts are zeroed just before each path (phases 6, 7, 8) and
read just after it. Then it prints the card line, the ``kernels`` JSON
line and, last, the ``ok`` line. It exits non-zero, printing no result,
when a phase fails, when no card is visible, or when the port's package is
not beside it. ``--only PHASE[,PHASE]`` runs just those phases (and the
card and build) and prints no result: a development aid.
"""

from __future__ import annotations

import argparse
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
# H100 SXM peak FLOP/s by type (NVIDIA data sheet, dense); the memory
# rate and both timers are gn_sweep's (HBM_BYTES_PER_S, events_ms,
# device_ms), imported where they are used
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# bf16 base-width GPT, flash vs plain attention: the relative L2 distance
# of the key and value projections' gradients (they come from dk and dv
# alone). Measured 8.2e-3; a dk/dv with D = rowsum(dO * O) taken as zero
# measured 1.24 and must exceed the bound.
BASE_GRAD_REL_L2 = 5e-2
# the same for the query projection's gradients, which come from dq alone:
# measured 1.50e-2; a dq fed D = 0 measured 5.67 and must exceed the bound
BASE_Q_GRAD_REL_L2 = 5e-2
# kernel -> (source in the repo, the TPU kernel it replaces); the kernels
# of the GPT training path, which runs bfloat16
KERNEL_INFO = {
    "flash_fwd_wgmma": ("tfk8s_tpu_torch/ops/csrc/flash_attention_sm90.cu",
                        "tfk8s_tpu/ops/flash_attention.py:149"),
    "flash_bwd_dq_wgmma": ("tfk8s_tpu_torch/ops/csrc/flash_attention_sm90.cu",
                           "tfk8s_tpu/ops/flash_attention.py:233"),
    "flash_bwd_dsum": ("tfk8s_tpu_torch/ops/csrc/flash_attention_sm90.cu",
                       "tfk8s_tpu/ops/flash_attention.py:317"),
    "flash_bwd_dkv_wgmma": ("tfk8s_tpu_torch/ops/csrc/flash_attention_sm90.cu",
                            "tfk8s_tpu/ops/flash_attention.py:290"),
    "group_norm_fwd": ("tfk8s_tpu_torch/ops/csrc/group_norm.cu",
                       "tfk8s_tpu/ops/group_norm.py:68"),
    "group_norm_bwd": ("tfk8s_tpu_torch/ops/csrc/group_norm.cu",
                       "tfk8s_tpu/ops/group_norm.py:137"),
    # the two-read path, for shapes whose slab does not fit a cluster
    "group_norm_fwd_2pass": ("tfk8s_tpu_torch/ops/csrc/group_norm.cu",
                             "tfk8s_tpu/ops/group_norm.py:68"),
    "group_norm_bwd_2pass": ("tfk8s_tpu_torch/ops/csrc/group_norm.cu",
                             "tfk8s_tpu/ops/group_norm.py:137"),
    "block_copy": ("tfk8s_tpu_torch/ops/csrc/block_copy.cu", "tools/roofline.py:124"),
}
# the resnet:train run: ResNet-50 at its published widths
RESNET_STEPS = 6
RESNET_ENV = {
    "TFK8S_RESNET_DEPTH": "50", "TFK8S_RESNET_WIDTH": "64", "TFK8S_BATCH_SIZE": "256",
    "TFK8S_IMAGE_SIZE": "224", "TFK8S_NUM_CLASSES": "1000",
    "TFK8S_TRAIN_STEPS": str(RESNET_STEPS), "TFK8S_LOG_EVERY": "1",
    "TFK8S_LEARNING_RATE": "1e-3", "TFK8S_SEED": "0",
}
RESNET_GN_SITES = 53  # stem + 16 bottlenecks x 3 + 4 projections
# ResNet-50 at full width, kernel vs plain GroupNorm on one input, as a
# share of the largest logit. float32 (TF32 off): the two differ only in
# the order of float32 sums, so 1e-4. bfloat16: the two round the same
# float32 norm outputs to bfloat16 and may land one step apart; 50 layers
# whose residual branches carry random unit-scale norms amplify such flips
# (0.50-0.56% of the logit scale measured), so 2%. A sound variant of the
# plain GroupNorm (float64 statistics, 0.54%) must stay within the bound and
# planted faults must exceed it (statistics without a quarter of the
# positions 3.8%, channels in the wrong group 52%), so the bound sits
# between a sound reading and a faulty one. An eps or one-pass-variance
# fault (0.58-0.66%) is below bfloat16 noise here: the card tests hold those.
RESNET50_F32_LOGIT_RTOL = 1e-4
RESNET50_BF16_LOGIT_RTOL = 2e-2
RESNET50_FAULTS_CAUGHT = ("first_quarter_dropped", "groups_mismapped")
# GroupNorm cases: (name, [B, H, W, C], groups, relu); the line's shape
# first, for the one-read kernels; the last takes the two-read path (one
# group across a 256x256x32 image: 4 MB a sample in bfloat16, beyond 8
# blocks' shared memory) and gives the line its two-read rows
GN_CASES = [
    ("gn_56x56x256", (256, 56, 56, 256), 32, False),
    ("gn_112x112x64_relu", (256, 112, 112, 64), 32, True),
    ("gn_7x7x2048_relu", (256, 7, 7, 2048), 32, True),
    ("gn_7x7x4096_relu", (64, 7, 7, 4096), 32, True),  # ResNet-50 at width 128
    ("gn_256x256x32_g1", (16, 256, 256, 32), 1, False),
]
COPY_SHAPE = (8192, 8192)


def log(msg: str) -> None:
    print(msg, flush=True)


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
        from tfk8s_tpu_torch.ops.flash_attention import DSUM_PAD

        self.n_pad = b * h * (-(-lq // DSUM_PAD) * DSUM_PAD)  # the D pre-pass's padded rows
        self.d = d

    def work(self, kernel: str):
        """(bytes, FLOPs) the kernel's function needs on these inputs:
        each input read once, each output written once."""
        e, qn, kn, lse, pad = self.elt, self.n_q, self.n_k, 4 * self.n_lse, 4 * self.n_pad
        if kernel.startswith("flash_fwd"):
            return e * (qn + 2 * kn + qn) + lse, 4 * self.pairs * self.d  # q k v in; o lse out
        if kernel == "flash_bwd_dq_wgmma":
            # q k v do, D and lse2 from the pre-pass in; dq out; QK^T, dO V^T, dS K
            return e * (2 * qn + 2 * kn + qn) + 2 * pad, 6 * self.pairs * self.d
        if kernel == "flash_bwd_dq_simt":  # reads o and lse itself
            return e * (qn + 2 * kn + 2 * qn + qn) + lse, 6 * self.pairs * self.d
        if kernel == "flash_bwd":
            # the whole backward: q do o, k v, lse in; dq, dk dv out; the
            # five products QK^T, dO V^T, P^T dO, dS K, dS^T Q
            return e * (4 * qn + 4 * kn) + lse, 10 * self.pairs * self.d
        if kernel == "flash_bwd_dsum":
            return e * 2 * qn + lse + 2 * pad, 2 * qn  # do o lse in; D, lse2 out
        if kernel == "flash_bwd_dkv_wgmma":
            # q k v do, D and lse2 from the pre-pass in; dk dv out
            return e * (2 * qn + 4 * kn) + 2 * pad, 8 * self.pairs * self.d
        # the CUDA-core dk/dv reads o and lse itself
        return e * (qn + 2 * kn + 2 * qn + 2 * kn) + lse, 8 * self.pairs * self.d

    def bound_ms(self, kernel: str):
        """Least time on the card: the larger of bytes over the memory
        rate and FLOPs over the peak rate for the inputs' type."""
        from tfk8s_tpu_torch.tools.gn_sweep import HBM_BYTES_PER_S

        nbytes, flops = self.work(kernel)
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


def _err(pairs, atol, rtol=0.0):
    """(max |kernel - plain|, whether every element is within
    atol + rtol * |plain|)"""
    worst, ok = 0.0, True
    for a, b in pairs:
        diff = (a.float() - b.float()).abs()
        worst = max(worst, float(diff.max()))
        ok = ok and bool((diff <= atol + rtol * b.float().abs()).all())
    return worst, ok


def check_case(fa, case: Case, iters: int, profile: bool = False):
    """Each kernel against its plain version on ``case``; returns one
    result dict per kernel and, in bfloat16, one for the whole backward
    (pre-pass, dq and dk/dv against SDPA's backward). bfloat16 runs the
    tensor-core kernels, float32 the CUDA-core ones. ``profile`` adds each
    row's device time from a profiler trace."""
    import torch

    from tfk8s_tpu_torch.tools.gn_sweep import device_ms, events_ms

    bf16 = case.dtype_name == "bfloat16"
    out_tol = BF16_ATOL if bf16 else F32_OUT_ATOL
    grad_tol = BF16_ATOL if bf16 else F32_GRAD_ATOL
    rtol = BF16_RTOL if bf16 else 0.0
    q, k, v, do, mask, causal = case.q, case.k, case.v, case.do, case.mask, case.causal
    fwd, dq, dkv = (("flash_fwd_wgmma", "flash_bwd_dq_wgmma", "flash_bwd_dkv_wgmma") if bf16
                    else ("flash_fwd_simt", "flash_bwd_dq_simt", "flash_bwd_dkv_simt"))

    fa.reset_launches()
    o_k, lse_k = fa.flash_fwd_cuda(q, k, v, mask, causal)
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, mask, causal)
    # the backward as training runs it: in bfloat16 one pre-pass feeds dq and dk/dv
    dq_k, dk_k, dv_k = fa.flash_bwd_cuda(q, k, v, do, o_k, lse_k, mask, causal)
    dq_p, dk_p, dv_p = fa.flash_bwd_plain(q, k, v, do, o_k, lse_k, mask, causal)
    torch.cuda.synchronize()
    want = {fwd: 1, dq: 1, dkv: 1, "flash_bwd_dsum": int(bf16)}
    if dict(fa.LAUNCHES) != {**dict.fromkeys(fa.KERNELS, 0), **want}:
        raise AssertionError(f"{case.name}: launches {dict(fa.LAUNCHES)}, want {want}")

    live = lse_p > -1e29
    errs = {
        fwd: _err([(o_k, o_p), (lse_k[live], lse_p[live])], out_tol, rtol),
        dq: _err([(dq_k, dq_p)], grad_tol, rtol),
        dkv: _err([(dk_k, dk_p), (dv_k, dv_p)], grad_tol, rtol),
    }
    tols = {fwd: out_tol, dq: grad_tol, dkv: grad_tol}
    if not torch.equal(lse_k > -1e29, live):
        raise AssertionError(f"{case.name}: the kernel's fully masked rows differ")
    for name, t in (("o", o_k), ("dq", dq_k), ("dk", dk_k), ("dv", dv_k)):
        if not torch.isfinite(t).all():
            raise AssertionError(f"{case.name}: kernel {name} is not finite")
    if mask is not None and (~mask).all(dim=1).any():
        dead = (~mask).all(dim=1)
        for name, t in (("o", o_k), ("dq", dq_k), ("dk", dk_k), ("dv", dv_k)):
            if t[dead].abs().max() != 0:
                raise AssertionError(f"{case.name}: fully masked row gives nonzero {name}")

    lib_fwd, lib_bwd = _library(case)
    runs = {
        fwd: (lambda: fa.flash_fwd_cuda(q, k, v, mask, causal),
              lambda: fa.flash_fwd_plain(q, k, v, mask, causal), lib_fwd),
    }

    def dq_plain():
        return fa.flash_bwd_dq_plain(q, k, v, do, o_k, lse_k, mask, causal)

    def dkv_plain():
        return fa.flash_bwd_dkv_plain(q, k, v, do, o_k, lse_k, mask, causal)

    if bf16:
        # the pre-pass, dq and dk/dv, each alone, then the whole backward
        ds_k, l2_k = fa.flash_bwd_dsum_cuda(do, o_k, lse_k)
        ds_p, l2_p = fa.flash_bwd_dsum_plain(do, o_k, lse_k)
        torch.cuda.synchronize()
        fin = torch.isfinite(l2_p)
        errs["flash_bwd_dsum"] = _err([(ds_k, ds_p), (l2_k[fin], l2_p[fin])], F32_OUT_ATOL, 1e-6)
        if not torch.equal(torch.isfinite(l2_k), fin):
            errs["flash_bwd_dsum"] = (float("inf"), False)
        tols["flash_bwd_dsum"] = F32_OUT_ATOL
        runs["flash_bwd_dsum"] = (lambda: fa.flash_bwd_dsum_cuda(do, o_k, lse_k),
                                  lambda: fa.flash_bwd_dsum_plain(do, o_k, lse_k), None)
        runs[dq] = (lambda: fa.flash_bwd_dq_wgmma_cuda(q, k, v, do, ds_k, l2_k, mask, causal),
                    dq_plain, lib_bwd)
        runs[dkv] = (lambda: fa.flash_bwd_dkv_wgmma_cuda(q, k, v, do, ds_k, l2_k, mask, causal),
                     dkv_plain, lib_bwd)
        errs["flash_bwd"] = (max(errs[dq][0], errs[dkv][0]), errs[dq][1] and errs[dkv][1])
        tols["flash_bwd"] = grad_tol
        runs["flash_bwd"] = (lambda: fa.flash_bwd_cuda(q, k, v, do, o_k, lse_k, mask, causal),
                             lambda: fa.flash_bwd_plain(q, k, v, do, o_k, lse_k, mask, causal),
                             lib_bwd)
    else:
        runs[dq] = (lambda: fa.flash_bwd_dq_cuda(q, k, v, do, o_k, lse_k, mask, causal),
                    dq_plain, lib_bwd)
        runs[dkv] = (lambda: fa.flash_bwd_dkv_cuda(q, k, v, do, o_k, lse_k, mask, causal),
                     dkv_plain, lib_bwd)
    results = []
    for name, (kern, plain, lib) in runs.items():
        bound, by = case.bound_ms(name)
        ms = events_ms(kern, iters)
        r = {
            "case": case.name, "kernel": name, "dtype": case.dtype_name,
            "max_abs_err": errs[name][0], "atol": tols[name], "rtol": rtol,
            "ms": ms, "plain_ms": events_ms(plain, max(iters // 4, 1)),
            "bound_ms": bound, "bound_by": by, "tflops": case.work(name)[1] / ms * 1e-9,
            "library_ms": None if lib is None else events_ms(lib, iters),
        }
        if profile:
            r["device_ms"] = device_ms(kern, iters)
            r["library_device_ms"] = None if lib is None else device_ms(lib, iters)
        log(f"  {json.dumps(r)}")
        if not errs[name][1]:
            raise AssertionError(f"{case.name}/{name}: beyond atol {tols[name]} rtol {rtol}")
        results.append(r)
    return results


def _gn_inputs(shape, dtype, seed):
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    x = (torch.randn(shape, generator=gen, device=DEVICE) * 2 + 0.5).to(dtype)
    dy = torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
    scale = torch.randn(shape[-1], generator=gen, device=DEVICE)
    bias = torch.randn(shape[-1], generator=gen, device=DEVICE)
    return x, dy, scale, bias


def check_group_norm(gn, torch, name, shape, groups, relu, dtype, iters):
    """Both GroupNorm kernels against their plain versions on one case,
    each under the name of the path (one read or two) that the kernels'
    layout rule gives the shape; each row with its device time and
    ``F.group_norm``'s."""
    import torch.nn.functional as F

    from tfk8s_tpu_torch.tools.gn_sweep import bound_ms, device_ms, events_ms

    x, dy, scale, bias = _gn_inputs(shape, dtype, seed=len(name))
    bf16 = dtype == torch.bfloat16
    atol_y, atol_dx = (2e-2, 2e-2) if bf16 else (F32_OUT_ATOL, F32_GRAD_ATOL)
    rtol = BF16_RTOL if bf16 else 0.0
    fwd_name, bwd_name = (gn.kernel_name(shape, groups, dtype, bwd) for bwd in (False, True))
    gn.reset_launches()
    y_k, m_k, r_k = gn.group_norm_fwd_cuda(x, scale, bias, groups, relu=relu)
    y_p, m_p, r_p = gn.group_norm_fwd_plain(x, scale, bias, groups, relu=relu)
    # both backwards from the kernel's statistics, so the ReLU masks agree
    dx_k, ds_k, db_k = gn.group_norm_bwd_cuda(dy, x, scale, bias, m_k, r_k, groups, relu)
    dx_p, ds_p, db_p = gn.group_norm_bwd_plain(dy, x, scale, bias, m_k, r_k, groups, relu)
    torch.cuda.synchronize()
    want = {**dict.fromkeys(gn.KERNELS, 0), fwd_name: 1, bwd_name: 1}
    if dict(gn.LAUNCHES) != want:
        raise AssertionError(f"{name}: group-norm launches {dict(gn.LAUNCHES)}, want {want}")
    for t in (y_k, dx_k, ds_k, db_k):
        if not torch.isfinite(t).all():
            raise AssertionError(f"{name}: a group-norm kernel output is not finite")
    e_fwd = _err([(y_k, y_p)], atol_y, rtol)
    e_stats = _err([(m_k, m_p), (r_k, r_p)], F32_OUT_ATOL, 1e-5)
    e_dx = _err([(dx_k, dx_p)], atol_dx, rtol)
    e_par = _err([(ds_k, ds_p), (db_k, db_p)], 1e-2, 1e-3)

    # the library yardstick: F.group_norm (+ relu) on the channels-last
    # NCHW view, and its autograd backward
    xc = x.permute(0, 3, 1, 2).detach().requires_grad_()
    w_l = scale.to(dtype).requires_grad_()
    b_l = bias.to(dtype).requires_grad_()
    dyc = dy.permute(0, 3, 1, 2)

    def lib_fwd():
        with torch.no_grad():
            out = F.group_norm(xc, groups, w_l, b_l, eps=1e-6)
            return F.relu(out) if relu else out

    out_l = F.group_norm(xc, groups, w_l, b_l, eps=1e-6)
    out_l = F.relu(out_l) if relu else out_l

    def lib_bwd():
        return torch.autograd.grad(out_l, (xc, w_l, b_l), dyc, retain_graph=True)

    n, elt = x.numel(), x.element_size()
    runs = {
        fwd_name: (
            lambda: gn.group_norm_fwd_cuda(x, scale, bias, groups, relu=relu),
            lambda: gn.group_norm_fwd_plain(x, scale, bias, groups, relu=relu),
            lib_fwd, max(e_fwd[0], e_stats[0]), e_fwd[1] and e_stats[1],
            bound_ms(n, elt, False)),
        bwd_name: (
            lambda: gn.group_norm_bwd_cuda(dy, x, scale, bias, m_k, r_k, groups, relu),
            lambda: gn.group_norm_bwd_plain(dy, x, scale, bias, m_k, r_k, groups, relu),
            lib_bwd, max(e_dx[0], e_par[0]), e_dx[1] and e_par[1],
            bound_ms(n, elt, True)),
    }
    results = []
    for kname, (kern, plain, lib, worst, ok, bound) in runs.items():
        r = {
            "case": f"{name}_{str(dtype).replace('torch.', '')}", "kernel": kname,
            "shape": list(shape), "max_abs_err": worst, "ms": events_ms(kern, iters),
            "plain_ms": events_ms(plain, max(iters // 4, 1)), "bound_ms": bound,
            "bound_by": "bytes", "library_ms": events_ms(lib, iters),
            "device_ms": device_ms(kern, iters), "library_device_ms": device_ms(lib, iters),
        }
        log(f"  {json.dumps(r)}")
        if not ok:
            raise AssertionError(f"{r['case']}/{kname}: kernel disagrees with its plain version")
        results.append(r)
    return results


def gn_step_sweep():
    """Each GroupNorm kernel at every ResNet-50 norm site's shape (bfloat16,
    batch 256): its device time (profiler) and event time a site, and
    their sums a training step against the bounds, from
    ``tfk8s_tpu_torch/tools/gn_sweep.py``."""
    from tfk8s_tpu_torch.tools import gn_sweep

    out = gn_sweep.sweep(log=lambda line: log(f"  {line}"))
    if out["sites"] != RESNET_GN_SITES:
        raise AssertionError(f"{out['sites']} norm sites, want {RESNET_GN_SITES}")
    log(f"gn per ResNet-50 step (bf16, batch 256, {out['sites']} sites): "
        f"{json.dumps({k: v for k, v in out.items() if k != 'rows'})}")
    return out


def check_copy(bc, torch, iters):
    """The block copy against ``out.copy_(x)``: bit-exact."""
    from tfk8s_tpu_torch.tools.gn_sweep import HBM_BYTES_PER_S, events_ms

    rows, cols = COPY_SHAPE
    x = torch.randn(rows, cols, device=DEVICE)
    out_k = torch.full_like(x, float("nan"))
    bc.block_copy_cuda(x, out_k)
    out_p = bc.block_copy_plain(x)
    torch.cuda.synchronize()
    exact = torch.equal(out_k, out_p)
    spare = torch.empty_like(x)
    r = {
        "case": "copy_8192x8192_f32", "kernel": "block_copy",
        "max_abs_err": float((out_k - out_p).abs().max()),
        "ms": events_ms(lambda: bc.block_copy_cuda(x, spare), iters),
        "plain_ms": events_ms(lambda: bc.block_copy_plain(x, spare), iters),
        "bound_ms": 2 * x.numel() * 4 / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": events_ms(lambda: spare.copy_(x), iters),
    }
    log(f"  {json.dumps(r)}")
    if not exact:
        raise AssertionError("block copy is not bit-exact")
    return r


# Variants of the plain GroupNorm (``reference_group_norm``) that witness
# the end-to-end bound: "float64_stats" is sound (statistics rounded
# otherwise); each other one plants a fault a GroupNorm kernel could have.
GN_VARIANTS = ("float64_stats", "eps_1e-5", "one_pass_variance", "first_quarter_dropped",
               "groups_mismapped")


def gn_variant(kind: str):
    import torch

    def norm(x, scale, bias, groups, eps=1e-6, relu=False):
        b, h, w, c = x.shape
        xf = x.float().reshape(b, h * w, groups, c // groups)
        if kind == "eps_1e-5":
            eps = 1e-5
        if kind == "first_quarter_dropped":  # one chunk's partials lost in the merge
            xf = xf[:, (h * w) // 4:]
        if kind == "float64_stats":
            xf = xf.double()
        mean = xf.mean(dim=(1, 3))
        if kind == "one_pass_variance":
            var = xf.square().mean(dim=(1, 3)) - mean.square()
        else:
            var = (xf - mean[:, None, :, None]).square().mean(dim=(1, 3))
        mean, rstd = mean.float(), torch.rsqrt(var + eps).float()
        # the group of each channel: c // (C / G), or c mod G when mismapped
        ch = torch.arange(c, device=x.device)
        gidx = ch % groups if kind == "groups_mismapped" else ch // (c // groups)
        y = (x.float() - mean[:, None, None, gidx]) * rstd[:, None, None, gidx]
        y = y * scale.float() + bias.float()
        return (y.clamp_min(0.0) if relu else y).to(x.dtype)

    return norm


def phase_card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def phase_build(_build):
    """Build every source; report ptxas's registers and spills for every
    tensor-core flash instantiation, the one-read GroupNorm kernels, the
    block copy and every instantiation that spills. A tensor-core or
    one-read GroupNorm instantiation that spills fails."""
    seconds, logs = _build.build_all(verbose=True)
    log(f"build: {seconds:.1f} s for {list(_build.SOURCES)}")
    entry, spilled = None, []
    for line in "\n".join(logs.values()).splitlines():
        m = re.search(r"entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            continue
        if entry is None or not ("registers" in line or "spill" in line):
            continue
        spills = re.search(r"[1-9]\d* bytes spill", line) is not None
        name = re.search(r"tfk8s_\w+?_kernel", entry)
        tag = name.group(0) if name else entry
        wgmma = "wgmma" in tag or "dsum" in tag
        cluster = "cluster" in tag  # the one-read GroupNorm kernels
        head_dim = re.search(r"ILi(\d+)EE", entry)
        if head_dim and (wgmma or "simt" in tag):  # a flash kernel's head dim
            tag += f"<d={head_dim.group(1)}>"
        inst = re.search(r"cluster_kernelI(\w+?)Li(\d+)ELb(\d)E", entry)
        if inst:  # a GroupNorm instantiation: <type, vec, relu>
            dtype = "bf16" if "bfloat16" in inst.group(1) else "f32"
            tag += f"<{dtype},{inst.group(2)},{inst.group(3)}>"
        if wgmma or cluster or "block_copy" in tag or spills:
            log(f"  ptxas {tag}: {line.split(':', 1)[-1].strip()}")
        if spills and (wgmma or cluster):
            spilled.append(tag)
    if spilled:
        raise AssertionError(f"kernels spill: {sorted(set(spilled))}")


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
        Case("bf16_d32_key_mask", 3, 333, 333, 4, 32, torch.bfloat16,
             lengths=[333, 120, 0], seed=6),
        # the slice's FLOPs at d=128 (half the heads, half the scores)
        Case("slice_bf16_causal_d128", s["b"], s["l"], s["l"], s["h"] // 2, 128, torch.bfloat16,
             causal=True, seed=7),
    ]
    line = {}
    for i, case in enumerate(cases):
        log(f"case {case.name}:")
        res = check_case(fa, case, iters=20 if i == 0 else 5, profile=i == 0)
        if i == 0:
            line.update((r["kernel"], r) for r in res)
    from tfk8s_tpu_torch.ops import block_copy as bc
    from tfk8s_tpu_torch.ops import group_norm as gn

    for i, (name, shape, groups, relu) in enumerate(GN_CASES):
        for dtype in (torch.bfloat16, torch.float32):
            log(f"case {name} {dtype}:")
            res = check_group_norm(gn, torch, name, shape, groups, relu, dtype, iters=10)
            if dtype == torch.bfloat16:  # the first case's row of each kernel
                line.update((r["kernel"], r) for r in res if r["kernel"] not in line)
            torch.cuda.empty_cache()
    gn_step_sweep()
    log("case copy:")
    line["block_copy"] = check_copy(bc, torch, iters=20)
    return line


def phase_reference(torch, gpt, fa):
    """Small f32 GPT: kernels on the card vs plain versions on the CPU;
    base-width bf16 loss and gradients: kernels vs plain attention on the
    card, and planted dq and dk/dv faults that the gradient bounds must
    catch."""
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
    real_bwd = fa.flash_bwd

    def planted(which):
        """The backward with D = rowsum(dO * O) taken as zero in dq or in
        dk/dv only: the kernels run on o = 0, so the pre-pass gives D = 0."""
        def bwd(q, k, v, do, o, lse, mask=None, causal=False):
            good = real_bwd(q, k, v, do, o, lse, mask, causal)
            bad = real_bwd(q, k, v, do, torch.zeros_like(o), lse, mask, causal)
            return (bad[0], *good[1:]) if which == "dq" else (good[0], *bad[1:])
        return bwd

    runs = (("full", None, real_bwd), ("flash", fa.flash_attention, real_bwd),
            ("fault_dkv", fa.flash_attention, planted("dkv")),
            ("fault_dq", fa.flash_attention, planted("dq")))
    losses, grads = {}, {}
    for impl, fn, bwd in runs:
        for layer in base.layers:
            layer.attn.attn_fn = fn
        base.zero_grad(set_to_none=True)
        fa.flash_bwd = bwd
        try:
            logits = base(ids)
            if not torch.isfinite(logits).all() or logits.shape != (batch, seq, cfg.vocab_size):
                raise AssertionError(f"base {impl}: bad logits {tuple(logits.shape)}")
            loss = gpt.lm_loss_and_metrics(logits, ids)[0]
            loss.backward()
        finally:
            fa.flash_bwd = real_bwd
        losses[impl] = loss.item()
        grads[impl] = {n: p.grad.float() for n, p in base.named_parameters()}

    def rel_l2(impl, names):
        num = sum(float((grads[impl][n] - grads["full"][n]).square().sum()) for n in names)
        return math.sqrt(num / sum(float(grads["full"][n].square().sum()) for n in names))

    # the bounds hold the key and value projections, whose gradients come
    # from dk and dv alone, and the query projection, whose gradients come
    # from dq alone; all parameters together are reported beside
    kv_names = [n for n in grads["full"] if re.search(r"attn\.(k|v)\.", n)]
    q_names = [n for n in grads["full"] if re.search(r"attn\.q\.", n)]
    if not kv_names or not q_names:
        raise AssertionError("no query, key or value projection parameters found")
    impls = ("flash", "fault_dkv", "fault_dq")
    err = abs(losses["full"] - losses["flash"])
    rel_kv = {impl: rel_l2(impl, kv_names) for impl in impls}
    rel_q = {impl: rel_l2(impl, q_names) for impl in impls}
    every = {impl: rel_l2(impl, list(grads["full"])) for impl in impls}
    log(f"reference bf16 base: loss full {losses['full']:.6f} flash {losses['flash']:.6f} "
        f"err {err:.2e} (atol {BF16_ATOL}); grads rel L2 vs full, flash / planted dk/dv "
        f"fault (D = 0) / planted dq fault (D = 0): k/v projections ({len(kv_names)} "
        f"tensors) {rel_kv['flash']:.3e} / {rel_kv['fault_dkv']:.3e} / "
        f"{rel_kv['fault_dq']:.3e} (bound {BASE_GRAD_REL_L2}); q projection "
        f"({len(q_names)} tensors) {rel_q['flash']:.3e} / {rel_q['fault_dkv']:.3e} / "
        f"{rel_q['fault_dq']:.3e} (bound {BASE_Q_GRAD_REL_L2}); every parameter "
        f"{every['flash']:.3e} / {every['fault_dkv']:.3e} / {every['fault_dq']:.3e}")
    if not err <= BF16_ATOL:
        raise AssertionError("base-width flash loss disagrees with plain attention")
    if not (rel_kv["flash"] <= BASE_GRAD_REL_L2 and rel_q["flash"] <= BASE_Q_GRAD_REL_L2):
        raise AssertionError("base-width flash gradients disagree with plain attention")
    if not rel_kv["fault_dkv"] > BASE_GRAD_REL_L2:
        raise AssertionError("the planted dk/dv fault passes the k/v gradient bound")
    if not rel_q["fault_dq"] > BASE_Q_GRAD_REL_L2:
        raise AssertionError("the planted dq fault passes the q gradient bound")
    for layer in base.layers:
        layer.attn.attn_fn = None
    del base, grads


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
    # bf16 training: each tensor-core kernel once per layer and step (one
    # pre-pass feeds dq and dk/dv); the float32 CUDA-core kernels never
    want = {**dict.fromkeys(fa.SIMT_KERNELS, 0),
            **dict.fromkeys(fa.TENSOR_CORE_KERNELS, layers * TRAIN_STEPS)}
    if launches != want:
        raise AssertionError(f"flash launches {launches}, want {want}")
    latest = Checkpointer(ckpt_dir).latest_step()
    log(f"checkpoint: latest_step {latest}")
    if latest != TRAIN_STEPS:
        raise AssertionError(f"latest committed step {latest}, want {TRAIN_STEPS}")
    return launches


def phase_resnet_reference(torch, resnet, gn):
    """Small float32 ResNet-50: GroupNorm kernels on the card vs plain
    versions on the CPU; ResNet-50 at full width in float32 and in
    bfloat16: kernel GroupNorm vs plain GroupNorm on the card, same input,
    and in bfloat16 the variants of ``gn_variant`` against the bound."""
    import copy

    import numpy as np

    from tfk8s_tpu_torch.ops.group_norm import reference_group_norm

    def randomized(width, classes, seed, dtype):
        """ResNet-50 with a random classifier and last-norm scales (both
        zero at init, which would leave most gradients zero)."""
        model = resnet.init_params(resnet.ResNet(50, classes, width, dtype),
                                   torch.Generator().manual_seed(seed))
        gen = torch.Generator().manual_seed(seed + 1)
        with torch.no_grad():
            model.classifier.weight.normal_(0.0, 0.1, generator=gen)
            for name in model.block_names:
                getattr(model, name).norm3.weight.normal_(0.0, 1.0, generator=gen)
        return model

    # float32 compute throughout (TF32 is off for the card's convs)
    cpu = randomized(8, 8, 0, torch.float32)
    card = copy.deepcopy(cpu).to(DEVICE)
    batch = resnet.make_batch_fn(8, 64)(np.random.default_rng(0), 4)
    losses, grads = [], []
    for model, dev in ((cpu, "cpu"), (card, DEVICE)):
        gn.reset_launches()
        x = torch.from_numpy(batch["image"]).to(dev)
        y = torch.from_numpy(batch["label"]).to(dev)
        logits = model(x)
        loss, _ = resnet.loss_and_metrics(logits, y)
        loss.backward()
        losses.append(loss.item())
        grads.append({n: p.grad.cpu() for n, p in model.named_parameters()})
    # every site through the one-read kernels, forward and backward
    want = {**dict.fromkeys(gn.TWO_READ_KERNELS, 0),
            **dict.fromkeys(gn.ONE_READ_KERNELS, RESNET_GN_SITES)}
    if dict(gn.LAUNCHES) != want:
        raise AssertionError(f"card pass launched {dict(gn.LAUNCHES)}, want {want}")
    num = sum(float((grads[0][n] - grads[1][n]).square().sum()) for n in grads[0])
    den = sum(float(grads[0][n].square().sum()) for n in grads[0])
    g_rel, l_err = math.sqrt(num / den), abs(losses[0] - losses[1])
    log(f"resnet reference f32 (width 8, image 64): loss cpu {losses[0]:.6f} card "
        f"{losses[1]:.6f} err {l_err:.2e}, grad rel L2 err {g_rel:.2e} (1e-3)")
    if not (l_err <= F32_GRAD_ATOL and g_rel <= 1e-3):
        raise AssertionError("ResNet on the card disagrees with the CPU plain path")

    # ResNet-50 at full width, one input: kernel vs plain GroupNorm in
    # float32, then in bfloat16 beside variants of the plain GroupNorm
    batch = resnet.make_batch_fn(1000, 224)(np.random.default_rng(1), 8)
    x = torch.from_numpy(batch["image"]).to(DEVICE)

    def logits_with(model, norm):
        resnet.fused_group_norm = norm
        try:
            with torch.no_grad():
                out = model(x)
        finally:
            resnet.fused_group_norm = gn.fused_group_norm
        if not torch.isfinite(out).all() or out.shape != (8, 1000):
            raise AssertionError(f"resnet50: bad logits {tuple(out.shape)}")
        return out.float()

    def rel_err(a, b):
        return float((a - b).abs().max()) / float(b.abs().max())

    model = randomized(64, 1000, 2, torch.float32).to(DEVICE)
    e32 = rel_err(logits_with(model, gn.fused_group_norm), logits_with(model, reference_group_norm))
    log(f"resnet reference f32 ResNet-50 (width 64, batch 8): logits max |kernel - plain| "
        f"{e32:.3e} of max |logit| (bound {RESNET50_F32_LOGIT_RTOL})")
    if not e32 <= RESNET50_F32_LOGIT_RTOL:
        raise AssertionError("ResNet-50 f32 logits: kernel GroupNorm disagrees with plain")

    model = randomized(64, 1000, 2, torch.bfloat16).to(DEVICE)
    plain = logits_with(model, reference_group_norm)
    rel = {"kernel": rel_err(logits_with(model, gn.fused_group_norm), plain)}
    for kind in GN_VARIANTS:
        rel[kind] = rel_err(logits_with(model, gn_variant(kind)), plain)
    log(f"resnet reference bf16 ResNet-50 (batch 8): logits max |variant - plain| of max "
        f"|logit| (bound {RESNET50_BF16_LOGIT_RTOL}): {json.dumps(rel)}")
    for kind in ("kernel", "float64_stats"):
        if not rel[kind] <= RESNET50_BF16_LOGIT_RTOL:
            raise AssertionError(f"ResNet-50 bf16 logits: {kind} GroupNorm disagrees with plain")
    for kind in RESNET50_FAULTS_CAUGHT:
        if not rel[kind] > RESNET50_BF16_LOGIT_RTOL:
            raise AssertionError(f"ResNet-50 bf16 logits: the planted fault {kind} passes")


def phase_resnet_train(torch, resnet, gn, ckpt_dir):
    from tfk8s_tpu_torch.runtime import progress
    from tfk8s_tpu_torch.runtime.checkpoint import Checkpointer

    env = dict(RESNET_ENV, TFK8S_CHECKPOINT_DIR=ckpt_dir)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    progress.clear()
    gn.reset_launches()
    t0 = time.perf_counter()
    history = resnet.train(env)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(gn.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    prog = progress.snapshot()
    losses = [h["loss"] for h in history]
    t_first = history[0]["step"] / history[0]["steps_per_s"]
    t_last = history[-1]["step"] / history[-1]["steps_per_s"]
    step_s = (t_last - t_first) / (history[-1]["step"] - history[0]["step"])
    summary = {
        "steps": RESNET_STEPS, "wall_s": wall, "first_step_s": t_first,
        "step_ms": step_s * 1e3, "images_per_s": int(env["TFK8S_BATCH_SIZE"]) / step_s,
        "peak_mem_gib": peak_gib, "first_loss": losses[0], "last_loss": losses[-1],
        "input_wait_seconds": prog.get("input_wait_seconds"),
        "input_starved_steps": prog.get("input_starved_steps"),
        "launches": launches,
    }
    log(f"resnet train: {json.dumps(summary)}")
    if len(losses) != RESNET_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"losses not finite: {losses}")
    # one launch of each one-read kernel per norm site and step, no two-read one
    want = {**dict.fromkeys(gn.TWO_READ_KERNELS, 0),
            **dict.fromkeys(gn.ONE_READ_KERNELS, RESNET_GN_SITES * RESNET_STEPS)}
    if launches != want:
        raise AssertionError(f"group-norm launches {launches}, want {want}")
    latest = Checkpointer(ckpt_dir).latest_step()
    log(f"checkpoint: latest_step {latest}")
    if latest != RESNET_STEPS:
        raise AssertionError(f"latest committed step {latest}, want {RESNET_STEPS}")
    return launches


def phase_roofline(torch, bc):
    from tfk8s_tpu_torch.tools import roofline

    torch.cuda.empty_cache()
    bc.reset_launches()
    out = roofline.run_all(small=False, device=DEVICE)
    launches = dict(bc.LAUNCHES)
    log(json.dumps(out))
    if out.get("degraded_probes"):
        raise AssertionError(f"roofline probes failed: {out['degraded_probes']}")
    if launches["block_copy"] == 0:
        raise AssertionError("the copy probe never launched the block-copy kernel")
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
    ap = argparse.ArgumentParser(description="On-card smoke test of the port.")
    ap.add_argument("--only", default="", help="comma-separated phases (development aid)")
    only = [p for p in ap.parse_args().only.split(",") if p]

    from tfk8s_tpu_torch.models import gpt, resnet
    from tfk8s_tpu_torch.ops import _build
    from tfk8s_tpu_torch.ops import block_copy as bc
    from tfk8s_tpu_torch.ops import flash_attention as fa
    from tfk8s_tpu_torch.ops import group_norm as gn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    ckpt_dir = os.path.join(root, "build", "chip_smoke_ckpt")
    rn_ckpt_dir = os.path.join(root, "build", "chip_smoke_resnet_ckpt")
    for d in (ckpt_dir, rn_ckpt_dir):
        shutil.rmtree(d, ignore_errors=True)
    failed, line, launches = [], None, {}
    card_line = None
    phases = [
        ("card", phase_card),
        ("build", lambda: phase_build(_build)),
        ("kernels", lambda: phase_kernels(fa, torch)),
        ("reference", lambda: phase_reference(torch, gpt, fa)),
        ("resnet_reference", lambda: phase_resnet_reference(torch, resnet, gn)),
        ("train", lambda: phase_train(torch, gpt, fa, ckpt_dir)),
        ("resnet_train", lambda: phase_resnet_train(torch, resnet, gn, rn_ckpt_dir)),
        ("roofline", lambda: phase_roofline(torch, bc)),
    ]
    if only:
        phases = [p for p in phases if p[0] in ("card", "build", *only)]
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
            line = value
        elif name in ("train", "resnet_train", "roofline"):
            launches.update(value)
    for d in (ckpt_dir, rn_ckpt_dir):
        shutil.rmtree(d, ignore_errors=True)
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    if only:
        print(f"chip_smoke: phases {[p[0] for p in phases]} passed (no result with --only)",
              file=sys.stderr)
        return 0
    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        r = line[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            **{key: r[key] for key in ("device_ms", "library_device_ms")
               if r.get(key) is not None},
        })
    print(card_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
