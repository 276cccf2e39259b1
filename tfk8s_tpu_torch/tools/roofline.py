"""Roofline probes of the port: the card's envelope and where a ResNet
training step sits in it, as one JSON line. The counterpart of the
repository's ``tools/roofline.py``.

    python -m tfk8s_tpu_torch.tools.roofline            # on the card
    python -m tfk8s_tpu_torch.tools.roofline --small --device cpu

Probes (the reference's, under the same names where they measure the same
thing):

- ``matmul_tflops``     bf16 [n, n] matmul chain (torch.matmul, as the
                        reference leaves it to XLA);
- ``stream_bf16_gbps``, ``stream_f32_gbps``  an in-place elementwise add
                        over 2^28 values, read and write (torch ops);
- ``copy_gbps``         the port's hand-written row-block copy kernel
                        (``ops/block_copy.py``, CUDA), [8192, 8192] f32:
                        the bandwidth a hand-written kernel sees; the JSON
                        names its source in ``copy_source``;
- ``resnet_fwd_ms``     ResNet-50 batch 256 forward and loss, no grad;
- ``resnet_gn_ablated_step_ms``  a full train step with every GroupNorm
                        replaced by identity (``resnet.ablate_norm``);
- ``resnet_step_ms``    the full train step.

Timing: each probe runs once to warm up, then 3 windows of ``iters``
calls, each ending in ``torch.cuda.synchronize()`` (the host clock around
synchronised windows), and reports the median window over ``iters``.
The step probes stage 4 batches on the device first and cycle through
them, so host batch synthesis is not timed (the reference's
``bench._time_task``). A probe that fails costs its field and is named in
``degraded_probes``; it never prints an invented number. Runs on the card
unless called with ``device="cpu"``; ``small=True`` (``--small``) gives
seconds-scale CPU shapes.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from tfk8s_tpu_torch.models import resnet
from tfk8s_tpu_torch.ops.block_copy import block_copy
from tfk8s_tpu_torch.runtime.launcher import select_device
from tfk8s_tpu_torch.runtime.train import TrainConfig, Trainer

COPY_SOURCE = "tfk8s_tpu_torch/ops/csrc/block_copy.cu"
_WINDOWS = 3
N_STAGE = 4  # batches the step probes stage on the device (bench._time_task's)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _median_window(timed_once: Callable[[], None], windows: int = _WINDOWS):
    """(median, all_window_seconds) of ``windows`` calls to ``timed_once``
    (a no-arg callable that runs AND synchronises one timed region); a
    copy of the reference's ``bench._median_window``."""
    times = []
    for _ in range(windows):
        t0 = time.perf_counter()
        timed_once()
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2], times


def seconds_per_call(fn: Callable[[], object], iters: int, device: torch.device) -> float:
    """Median over 3 synchronised windows of ``iters`` calls, per call,
    after one warm-up call."""
    fn()
    _sync(device)

    def window():
        for _ in range(iters):
            fn()
        _sync(device)

    med, _ = _median_window(window)
    return med / iters


def matmul_tflops(n: int = 8192, iters: int = 40, device="cuda") -> float:
    """bf16 matmul chain ``c <- c @ w``; w's rows sum to 1, so the chain
    stays finite however long it runs."""
    device = torch.device(device)
    w = torch.eye(n, device=device) + 1e-3
    w = (w / (1 + n * 1e-3)).to(torch.bfloat16)
    bufs = [torch.ones(n, n, dtype=torch.bfloat16, device=device),
            torch.empty(n, n, dtype=torch.bfloat16, device=device)]

    def step():
        torch.matmul(bufs[0], w, out=bufs[1])
        bufs.reverse()

    return 2 * n ** 3 / seconds_per_call(step, iters, device) / 1e12


def stream_gbps(dtype_name: str, elems: int = 2 ** 28, iters: int = 64,
                device="cuda") -> float:
    """In-place ``x += 1``: each call reads and writes the buffer once."""
    device = torch.device(device)
    dtype = torch.bfloat16 if dtype_name == "bf16" else torch.float32
    x = torch.ones(elems, dtype=dtype, device=device)
    sec = seconds_per_call(lambda: x.add_(1), iters, device)
    return 2 * x.element_size() * elems / sec / 1e9


def copy_gbps(rows: int = 8192, cols: int = 8192, iters: int = 32, device="cuda") -> float:
    """The block-copy kernel (the plain copy on the CPU); raises if the
    copy is not exact."""
    device = torch.device(device)
    x = torch.arange(rows * cols, dtype=torch.float32, device=device).reshape(rows, cols)
    out = torch.empty_like(x)
    sec = seconds_per_call(lambda: block_copy(x, out), iters, device)
    if not torch.equal(out, x):
        raise RuntimeError("block copy is not exact")
    return 2 * rows * cols * 4 / sec / 1e9


def _resnet_task_kw(small: bool) -> Dict:
    if small:
        return dict(depth=18, num_classes=8, image_size=32, width=8, batch_size=8)
    return dict(depth=50, num_classes=1000, image_size=224, batch_size=256)


def _device_batch(task, device, rng):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in task.make_batch(rng, task.batch_size).items()}


def resnet_fwd_ms(small: bool, iters: int = 40, device="cuda") -> float:
    """Forward and loss only, under ``no_grad``: the step-time share that
    is not backward or update."""
    device = torch.device(device)
    task = resnet.make_task(**_resnet_task_kw(small))
    model = task.init(torch.Generator().manual_seed(0)).to(device)
    batch = _device_batch(task, device, np.random.default_rng(0))

    def fwd():
        with torch.no_grad():
            return task.loss_fn(model, batch)

    return seconds_per_call(fwd, iters, device) * 1e3


def resnet_step_ms(small: bool, ablate_norm: bool = False, steps: Optional[int] = None,
                   device="cuda") -> float:
    """A full train step (forward, backward, AdamW) of the port's
    ``Trainer``, cycling through ``N_STAGE`` batches staged on the device;
    ``ablate_norm`` swaps every GroupNorm for identity."""
    device = torch.device(device)
    steps = steps or (4 if small else 20)
    scope = resnet.ablate_norm() if ablate_norm else contextlib.nullcontext()
    with scope:
        task = resnet.make_task(**_resnet_task_kw(small))
    trainer = Trainer(task, TrainConfig(steps=steps, learning_rate=1e-3), device)
    state = trainer.init_state()
    rng = np.random.default_rng(0)
    staged = [_device_batch(task, device, rng) for _ in range(N_STAGE)]
    i = [0]

    def step():
        trainer.train_step(state, staged[i[0] % N_STAGE])
        i[0] += 1

    return seconds_per_call(step, steps, device) * 1e3


def run_all(small: bool = False, device=None) -> Dict:
    """Every probe, one dict (the full step included)."""
    device = select_device(None, device)
    if small:
        mm_kw = dict(n=256, iters=4)
        st_kw = dict(elems=2 ** 16, iters=4)
        cp_kw = dict(rows=64, cols=96, iters=4)
        fwd_iters = 2
    else:
        mm_kw, st_kw, cp_kw, fwd_iters = {}, {}, {}, 40
    out: Dict = {
        "metric": "roofline",
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "device_kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "n_chips": 1,
        "small": small,
        "copy_source": COPY_SOURCE,
    }
    degraded = []

    def probe(name, fn):
        # a failed probe costs its field and gets a marker, never an
        # invented number or a dead harness
        try:
            out[name] = fn()
        except Exception as exc:  # noqa: BLE001
            print(f"roofline: {name} probe failed: {exc!r}", file=sys.stderr)
            degraded.append(name)

    probe("matmul_tflops", lambda: matmul_tflops(**mm_kw, device=device))
    probe("stream_bf16_gbps", lambda: stream_gbps("bf16", **st_kw, device=device))
    probe("stream_f32_gbps", lambda: stream_gbps("f32", **st_kw, device=device))
    probe("copy_gbps", lambda: copy_gbps(**cp_kw, device=device))
    probe("resnet_fwd_ms", lambda: resnet_fwd_ms(small, fwd_iters, device=device))
    probe("resnet_gn_ablated_step_ms",
          lambda: resnet_step_ms(small, ablate_norm=True, device=device))
    probe("resnet_step_ms", lambda: resnet_step_ms(small, device=device))
    if degraded:
        out["degraded_probes"] = degraded
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--small", action="store_true", help="seconds-scale shapes")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    out = run_all(small=args.small, device=args.device)
    print(json.dumps(out))
    return 1 if out.get("degraded_probes") else 0


if __name__ == "__main__":
    sys.exit(main())
