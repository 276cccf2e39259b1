"""What the tensor axis's float32 wire costs: GPT-2-small on ``{"tensor":
n}``, one process a card over NCCL, as JSON lines from rank 0.

    python -m tfk8s_tpu_torch.tools.tensor_wire             # on n = 4 cards
    python -m tfk8s_tpu_torch.tools.tensor_wire --procs 2 --device cpu --small

``tensor_parallel`` moves every row split's sum, every column split's
input gradient and every gathered block as float32 (``_wire``), twice
the bytes of the bfloat16 activations. Probes:

- ``peer``: whether each card reads every other card's memory directly
  (``torch.cuda.can_device_access_peer``), and the NCCL settings in the
  environment that steer its transport;
- ``all_reduce``: one row split's sum, ``[batch, seq, embed]``, as
  float32 and as bfloat16: median ms of ``iters`` synced calls and the
  bus rate (``2 (n - 1) / n`` times the bytes over the time, the ring's
  traffic a card);
- ``step``: the train step on a batch staged on the card, with the sums
  and gathers moved as float32 (the port's) and as bfloat16 (``_wire``
  the identity; a measurement only, its numbers are not one process's):
  median wall ms of ``iters`` synced steps, and from a profiler trace of
  one more the device time of the NCCL kernels, of the rest, the union
  of both, and the NCCL kernels' count.

The CPU (gloo) runs the float32 wire only: gloo takes no 16-bit tensor.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import statistics
import time
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

NCCL_ENV = ("NCCL_P2P_DISABLE", "NCCL_P2P_LEVEL", "NCCL_SHM_DISABLE", "NCCL_NVLS_ENABLE",
            "NCCL_PROTO", "NCCL_ALGO", "CUDA_VISIBLE_DEVICES")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _median_ms(fn, iters: int, device: torch.device) -> float:
    fn()
    _sync(device)
    times = []
    for _ in range(iters):
        dist.barrier()
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _device_split(prof) -> Dict[str, float]:
    """Device ms of the NCCL kernels and of the rest (sums of their
    durations), the union of all device activity, and the NCCL count."""
    spans, nccl_ms, rest_ms, n = [], 0.0, 0.0, 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dur = (e.time_range.end - e.time_range.start) * 1e-3
        spans.append((e.time_range.start, e.time_range.end))
        if "nccl" in e.name.lower():
            nccl_ms, n = nccl_ms + dur, n + 1
        else:
            rest_ms += dur
    busy, cur = 0.0, None
    for start, end in sorted(spans):
        if cur is None or start > cur[1]:
            busy += 0 if cur is None else cur[1] - cur[0]
            cur = [start, end]
        else:
            cur[1] = max(cur[1], end)
    busy += 0 if cur is None else cur[1] - cur[0]
    return {"nccl_device_ms": nccl_ms, "other_device_ms": rest_ms,
            "busy_device_ms": busy * 1e-3, "nccl_kernels": n}


def _step(args, mesh, device, wire: str) -> Dict[str, float]:
    from torch.profiler import ProfilerActivity, profile

    from tfk8s_tpu_torch.models import gpt
    from tfk8s_tpu_torch.parallel import tensor_parallel
    from tfk8s_tpu_torch.parallel.data_parallel import DataParallel
    from tfk8s_tpu_torch.runtime.train import TrainConfig, Trainer

    cfg = (gpt.tiny_config if args.small else gpt.base_config)()
    task = gpt.task_for_mesh(mesh, cfg=cfg, seq_len=args.seq, batch_size=args.batch)
    trainer = Trainer(task, TrainConfig(steps=10 ** 6, learning_rate=1e-4), device,
                      DataParallel(mesh, device))
    state = trainer.init_state()
    staged = trainer.to_device(task.make_batch(np.random.default_rng(0), task.batch_size))
    f32_wire = tensor_parallel._wire
    if wire == "bfloat16":
        tensor_parallel._wire = lambda x: x
    try:
        ms = _median_ms(lambda: trainer.train_step(state, staged), args.iters, device)
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                               if device.type == "cuda" else [])
        dist.barrier()
        with profile(activities=activities) as prof:
            trainer.train_step(state, staged)
            _sync(device)
    finally:
        tensor_parallel._wire = f32_wire
    return {"probe": "step", "wire": wire, "step_ms": ms, **_device_split(prof)}


def worker(rank: int, args, port: int) -> None:
    from tfk8s_tpu_torch.runtime.train import join_mesh

    env = {"TFK8S_DISTRIBUTED": "1", "TFK8S_NUM_PROCESSES": str(args.procs),
           "TFK8S_PROCESS_ID": str(rank), "TFK8S_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
           "TFK8S_MESH": json.dumps({"tensor": args.procs})}
    if args.device == "cpu":
        env["TFK8S_DEVICE"] = "cpu"
    _ctx, device, mesh = join_mesh(env)
    out: List[Dict] = []
    if device.type == "cuda":
        out.append({"probe": "peer", "card": torch.cuda.get_device_name(device),
                    "access": {f"{rank}->{j}": torch.cuda.can_device_access_peer(rank, j)
                               for j in range(args.procs) if j != rank},
                    "env": {k: os.environ[k] for k in NCCL_ENV if k in os.environ}})
    dtypes = (torch.float32, torch.bfloat16) if device.type == "cuda" else (torch.float32,)
    width = 32 if args.small else 768
    for dtype in dtypes:
        x = torch.randn(args.batch, args.seq, width, device=device).to(dtype)
        ms = _median_ms(lambda: dist.all_reduce(x), args.iters, device)
        nbytes = x.numel() * x.element_size()
        out.append({"probe": "all_reduce", "dtype": str(dtype).replace("torch.", ""),
                    "bytes": nbytes, "ms": ms,
                    "bus_gbps": 2 * (args.procs - 1) / args.procs * nbytes / ms * 1e-6})
    for wire in ("float32", "bfloat16") if device.type == "cuda" else ("float32",):
        out.append(_step(args, mesh, device, wire))
    if rank == 0:
        for line in out:
            print(json.dumps({"procs": args.procs, "seq": args.seq, "batch": args.batch,
                              **line}), flush=True)
    dist.barrier()
    dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=4, help="ranks, one card each")
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--small", action="store_true", help="GPT's tiny config, seconds on a CPU")
    args = ap.parse_args(argv)
    if args.device == "cuda" and torch.cuda.device_count() < args.procs:
        raise SystemExit(f"tensor_wire: {torch.cuda.device_count()} cards, "
                         f"--procs {args.procs} needs one each")
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    torch.multiprocessing.spawn(worker, args=(args, port), nprocs=args.procs, join=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
