"""GroupNorm at every ResNet-50 norm site, on the card: each kernel's
device time and event time a site, and their sums over one training step
against the bound.

    python -m tfk8s_tpu_torch.tools.gn_sweep [--step]

The sites are recorded from one meta-device forward of the port's own
ResNet-50 (batch 256, image 224); each distinct (shape, ReLU) runs once in
bfloat16, counted as many times as the model calls it. Device time and
event time are ``device_ms`` and ``events_ms`` below, the port's two
timers (``chip_smoke.py`` and ``kernel_variants.py`` use them too). The
bound counts each input read once and each output written once: x in, y
out forward; dy, x in, dx out backward.

It calls only the wrappers ``group_norm_fwd_cuda`` and
``group_norm_bwd_cuda``, so this one file also runs inside an earlier tree
of the port, for a comparison of two trees in one call on one card.
``--step`` adds the staged ResNet-50 train step and its GN-ablated twin
(``tools/roofline.py``). One JSON line a site, one for the sums, one for
the step.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Callable, Dict, List

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
BATCH, IMAGE = 256, 224
ITERS = 10  # calls a timing window


def sites(batch: int = BATCH) -> List:
    """(shape [B, H, W, C], groups, relu) of every GroupNorm call of one
    ResNet-50 forward, recorded on a meta-device pass through the real
    model code."""
    from tfk8s_tpu_torch.models import resnet

    found = []
    real = resnet.fused_group_norm

    def record(x, scale, bias, groups, eps=1e-6, relu=False):
        found.append((tuple(x.shape), groups, relu))
        return torch.empty_like(x)

    resnet.fused_group_norm = record
    try:
        with torch.device("meta"):
            resnet.ResNet(50, 1000, 64)(torch.empty(batch, IMAGE, IMAGE, 3))
    finally:
        resnet.fused_group_norm = real
    return found


def events_ms(fn: Callable[[], object], iters: int) -> float:
    """Mean time of ``fn`` over ``iters`` back-to-back calls, CUDA events
    (after two warm-up calls). Between short kernels it includes the
    host's time to launch the next one."""
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


def device_ms(fn: Callable[[], object], iters: int, windows: int = 3):
    """Device time of one call of ``fn``: the card's activity times in a
    ``torch.profiler`` trace of ``iters`` calls, summed, over ``iters``,
    which leaves out the host's time between launches. Of ``windows``
    traces only those that hold the most activities count, since a trace
    now and then misses kernels and would read low: their median, or None
    when no trace holds device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    traces = []
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        traces.append((len(spans), sum(spans)))
    most = max(n for n, _ in traces)
    kept = sorted(us for n, us in traces if n == most and us > 0)
    return kept[len(kept) // 2] / iters * 1e-3 if kept else None


def bound_ms(numel: int, elt: int, backward: bool) -> float:
    """Bytes over the memory rate (the [B, G] statistics and [C]
    parameters are negligible next to the activations)."""
    return (3 if backward else 2) * numel * elt / HBM_BYTES_PER_S * 1e3


def sweep(log: Callable[[str], None] = print) -> Dict:
    """Both kernels at every distinct site; returns the per-site rows and
    their sums a step (each site counted as often as the model calls it)."""
    from tfk8s_tpu_torch.ops import group_norm as gn

    found = sites()
    counts: Dict = {}
    for site in found:
        counts[site] = counts.get(site, 0) + 1
    rows = []
    tot = dict.fromkeys(("fwd_device_ms", "bwd_device_ms", "fwd_events_ms", "bwd_events_ms",
                         "fwd_bound_ms", "bwd_bound_ms"), 0.0)
    for (shape, groups, relu), count in counts.items():
        gen = torch.Generator(device="cuda").manual_seed(7)
        x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).to(torch.bfloat16)
        dy = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        scale = torch.randn(shape[-1], generator=gen, device="cuda")
        bias = torch.randn(shape[-1], generator=gen, device="cuda")
        _, m, r = gn.group_norm_fwd_cuda(x, scale, bias, groups, relu=relu)

        def fwd():
            return gn.group_norm_fwd_cuda(x, scale, bias, groups, relu=relu)

        def bwd():
            return gn.group_norm_bwd_cuda(dy, x, scale, bias, m, r, groups, relu)

        row = {"shape": list(shape), "groups": groups, "relu": relu, "count": count,
               "fwd_device_ms": device_ms(fwd, ITERS), "bwd_device_ms": device_ms(bwd, ITERS),
               "fwd_events_ms": events_ms(fwd, ITERS), "bwd_events_ms": events_ms(bwd, ITERS),
               "fwd_bound_ms": bound_ms(x.numel(), 2, False),
               "bwd_bound_ms": bound_ms(x.numel(), 2, True)}
        for key in tot:
            tot[key] += count * (row[key] if row[key] is not None else float("nan"))
        rows.append(row)
        log(json.dumps({"gn_site": row}))
        del x, dy
    out = {"sites": len(found), "distinct": len(rows), "dtype": "bfloat16", "batch": BATCH,
           **tot, "rows": rows}
    log(json.dumps({"gn_step": {k: v for k, v in out.items() if k != "rows"}}))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--step", action="store_true", help="also time the staged ResNet-50 step")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gn_sweep: no CUDA device visible", file=sys.stderr)
        return 2
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    sweep()
    if args.step:
        from tfk8s_tpu_torch.tools import roofline

        torch.backends.cudnn.allow_tf32 = False
        print(json.dumps({"resnet_step": {
            "resnet_step_ms": roofline.resnet_step_ms(False),
            "resnet_gn_ablated_step_ms": roofline.resnet_step_ms(False, ablate_norm=True)}}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
