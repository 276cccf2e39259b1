"""The training loop on one device: TrainTask -> eager PyTorch steps,
ported from the JAX package's ``runtime/train.py``.

What is kept from the reference:
- the env contract of ``run_task`` (steps, learning rate, schedule,
  warmup, gradient accumulation, logging, checkpoint cadence, seed);
- AdamW with optax ``adamw`` semantics (b1 0.9, b2 0.999, eps 1e-8,
  decoupled weight decay) whose learning rate is the schedule read at the
  optimizer's count before the update, so warmup's first step has lr 0;
- the replicated batch stream ``np.random.default_rng(seed + step)``, one
  host batch per step, synthesized ahead on a prefetch thread;
- metrics fetched from the device only at log boundaries, progress
  reports, convergence targets, checkpoint/resume, and the drain on a
  reclaim notice (``stop.drain_requested``) ending in ``PodDrained``;
- under a node agent (``runtime/node_agent``): progress reaches pod
  status through the agent's sink, a drain raises the agent's
  ``PodDrained`` (so the pod ends Drained), the first step's time is also
  reported as ``compile_seconds``, and ``run_task`` continues
  ``TFK8S_TRACEPARENT`` with ``trainer.run``, ``trainer.startup`` and
  ``trainer.first_step`` spans.

Not ported yet, raising ``NotImplementedError`` when asked for: multi-
process, per-host and record-file input (ROADMAP item 1.5), the scanned
multi-step dispatch (``TFK8S_SCAN_STEPS``) and profiling (item 1.11).
"""

from __future__ import annotations

import dataclasses
import math
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from tfk8s_tpu_torch.obs.trace import TRACEPARENT_ENV, get_tracer
from tfk8s_tpu_torch.runtime import node_agent, progress
from tfk8s_tpu_torch.runtime.checkpoint import Checkpointer
from tfk8s_tpu_torch.runtime.launcher import ProcessContext, select_device
from tfk8s_tpu_torch.utils.logging import get_logger

log = get_logger("train")

# A step counts as input-starved when the host wait for its batch exceeds
# this fraction of the step's wall time (the reference's alert).
_INPUT_STARVED_FRACTION = 0.2


# what a drained run raises outside a node agent (under one, the agent's
# own class: ``node_agent.pod_drained_class``)
PodDrained = node_agent.PodDrained


@dataclasses.dataclass
class TrainTask:
    """What a model family provides to be trainable.

    ``init(generator)`` builds the model on the CPU with its initial
    parameters drawn from ``generator``; ``loss_fn(model, batch) -> (loss,
    metrics)`` computes the scalar objective on a batch of device tensors;
    ``make_batch(np_rng, batch_size)`` produces one host-side numpy batch."""

    name: str
    init: Callable[[torch.Generator], nn.Module]
    loss_fn: Callable[[nn.Module, Dict[str, torch.Tensor]],
                      Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
    make_batch: Callable[[np.random.Generator, int], Dict[str, np.ndarray]]
    batch_size: int = 32
    # metric name -> target the run should reach (convergence check)
    targets: Dict[str, float] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    learning_rate: float = 1e-3
    weight_decay: float = 0.0
    warmup_steps: int = 0
    log_every: int = 20
    checkpoint_every: int = 0
    checkpoint_dir: str = ""
    seed: int = 0
    resume: bool = False
    # >1 splits each batch into this many microbatches, grads averaged,
    # one optimizer update
    grad_accum_steps: int = 1
    # >1 synthesizes host batches this many steps ahead on a thread
    prefetch: int = 2
    # "constant" | "cosine" | "linear" decay after warmup, over
    # decay_steps (None = the rest of the run) down to min_lr_ratio * lr
    lr_schedule: str = "constant"
    decay_steps: Optional[int] = None
    min_lr_ratio: float = 0.0

    def make_schedule(self) -> Callable[[int], float]:
        """The step -> lr schedule with optax's formulas (constant,
        ``cosine_decay_schedule``, ``linear_schedule``, joined after a
        linear warmup from 0)."""
        peak, warm = self.learning_rate, max(self.warmup_steps, 0)
        decay = self.decay_steps or max(self.steps - warm, 1)
        alpha = self.min_lr_ratio
        if self.lr_schedule == "constant":
            def main(step: int) -> float:
                return peak
        elif self.lr_schedule == "cosine":
            def main(step: int) -> float:
                frac = min(max(step, 0), decay) / decay
                return peak * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * frac)) + alpha)
        elif self.lr_schedule == "linear":
            def main(step: int) -> float:
                frac = 1 - min(max(step, 0), decay) / decay
                return (peak - peak * alpha) * frac + peak * alpha
        else:
            raise ValueError(
                f"unknown lr_schedule {self.lr_schedule!r} "
                "(constant | cosine | linear)"
            )
        if warm <= 0:
            return main

        def schedule(step: int) -> float:
            if step < warm:
                return peak * min(max(step, 0), warm) / warm
            return main(step - warm)

        return schedule


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer

    def state_dict(self) -> Dict[str, Any]:
        return {
            "step": self.step,
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
        }

    def load_state_dict(self, saved: Dict[str, Any]) -> None:
        self.model.load_state_dict(saved["model"])
        self.optimizer.load_state_dict(saved["optimizer"])
        self.step = int(saved["step"])


class _BatchPrefetcher:
    """Bounded producer thread for host batches, in step order, so the rng
    stream matches the synchronous path exactly. The consumer moves each
    batch to the device. Producer exceptions re-raise in the consumer."""

    _DONE = object()

    def __init__(self, make_batch: Callable[[int], Any], start: int, stop_step: int, depth: int):
        self._make = make_batch
        self._q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._exc: Optional[BaseException] = None
        self._range = (start, stop_step)
        self._thread = threading.Thread(target=self._run, daemon=True, name="batch-prefetch")
        self._thread.start()

    def _put(self, item: Any) -> None:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def _run(self) -> None:
        try:
            for step in range(*self._range):
                if self._stop.is_set():
                    return
                self._put(self._make(step))
        except Exception as e:  # noqa: BLE001 — re-raised in the consumer
            self._exc = e
        finally:
            self._put(self._DONE)

    def get(self) -> Any:
        item = self._q.get()
        if item is self._DONE:
            if self._exc is not None:
                raise self._exc
            raise RuntimeError("batch prefetcher exhausted early")
        return item

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)


class Trainer:
    def __init__(self, task: TrainTask, config: TrainConfig, device: torch.device):
        self.task = task
        self.config = config
        self.device = torch.device(device)
        self.schedule = config.make_schedule()
        # set by fit() when a reclaim notice drained the run
        self.drained_at: Optional[int] = None
        accum = max(config.grad_accum_steps, 1)
        if task.batch_size % accum:
            raise ValueError(
                f"grad_accum_steps={accum} does not divide batch_size={task.batch_size}"
            )

    def init_state(self) -> TrainState:
        generator = torch.Generator().manual_seed(self.config.seed)
        model = self.task.init(generator).to(self.device)
        optimizer = torch.optim.AdamW(
            model.parameters(), lr=self.schedule(0), betas=(0.9, 0.999),
            eps=1e-8, weight_decay=self.config.weight_decay,
        )
        return TrainState(step=0, model=model, optimizer=optimizer)

    def to_device(self, host_batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {
            k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device, non_blocking=True)
            for k, v in host_batch.items()
        }

    def train_step(self, state: TrainState, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One optimizer update; returns the step's metrics as device
        tensors (nothing is fetched to the host here)."""
        accum = max(self.config.grad_accum_steps, 1)
        model, opt = state.model, state.optimizer
        opt.zero_grad(set_to_none=True)
        if accum == 1:
            loss, aux = self.task.loss_fn(model, batch)
            loss.backward()
        else:
            # contiguous row chunks: the reference's [accum, B/accum] split
            micro = [dict(zip(batch, parts)) for parts in
                     zip(*(v.chunk(accum, dim=0) for v in batch.values()))]
            loss, aux = torch.zeros((), device=self.device), {}
            for mb in micro:
                loss_i, aux_i = self.task.loss_fn(model, mb)
                (loss_i / accum).backward()
                loss = loss + loss_i.detach().float() / accum
                for k, v in aux_i.items():
                    aux[k] = aux.get(k, 0.0) + v.detach().float() / accum
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        grad_norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g.float()) for g in grads])
        )
        lr = self.schedule(state.step)  # optax reads the pre-update count
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        state.step += 1
        return {"loss": loss.detach(), "grad_norm": grad_norm,
                **{k: v.detach() for k, v in aux.items()}}

    def fit(
        self,
        state: Optional[TrainState] = None,
        stop: Optional[Any] = None,  # threading.Event-like graceful preemption
    ) -> Tuple[TrainState, List[Dict[str, float]]]:
        cfg = self.config
        ckpt = Checkpointer(cfg.checkpoint_dir) if cfg.checkpoint_dir else None
        if state is None:
            state = self.init_state()
            if cfg.resume and ckpt and ckpt.latest_step() is not None:
                state.load_state_dict(ckpt.restore(map_location=self.device))
                log.info("%s: resumed at step %d", self.task.name, state.step)

        history: List[Dict[str, float]] = []
        start_step = state.step
        # the batch stream: owned by the producer (thread or this loop)
        np_rng = np.random.default_rng(cfg.seed + start_step)

        def _make_host_batch(step: int):
            return self.task.make_batch(np_rng, self.task.batch_size)

        prefetcher = (
            _BatchPrefetcher(_make_host_batch, start_step, cfg.steps, cfg.prefetch)
            if cfg.prefetch > 1 else None
        )
        t0 = time.perf_counter()
        last_report = (start_step, t0)
        first_step_s: Optional[float] = None
        input_wait_total, starved_steps = 0.0, 0
        try:
            step = start_step
            while step < cfg.steps:
                if stop is not None and getattr(stop, "is_set", lambda: False)():
                    log.info("%s: stop requested at step %d", self.task.name, step)
                    break
                if stop is not None and getattr(stop, "drain_requested", False):
                    self.drained_at = step
                    log.info("%s: reclaim notice at step %d; draining", self.task.name, step)
                    break
                it_t0 = time.perf_counter()
                host = prefetcher.get() if prefetcher is not None else _make_host_batch(step)
                input_wait = time.perf_counter() - it_t0
                if first_step_s is None:
                    # the first step builds the kernels and warms the
                    # libraries: span it and report it apart, after it
                    # has finished (the reference's one-time start cost,
                    # so also under the key the controller mirrors)
                    with get_tracer().start_span(
                        "trainer.first_step", attributes={"task": self.task.name}
                    ):
                        metrics = self.train_step(state, self.to_device(host))
                        float(metrics["loss"])
                    first_step_s = time.perf_counter() - it_t0
                    progress.report(first_step_seconds=first_step_s,
                                    compile_seconds=first_step_s)
                else:
                    metrics = self.train_step(state, self.to_device(host))
                step = state.step
                it_dt = time.perf_counter() - it_t0
                input_wait_total += input_wait
                if input_wait > _INPUT_STARVED_FRACTION * max(it_dt, 1e-9):
                    starved_steps += 1
                if ckpt and cfg.checkpoint_every and step % cfg.checkpoint_every == 0:
                    ckpt.save(step, state.state_dict())
                elif ckpt:
                    ckpt.maybe_commit()
                if step % cfg.log_every == 0 or step == cfg.steps:
                    # one host transfer for the whole metrics dict
                    keys = sorted(metrics)
                    vals = torch.stack([metrics[k].float() for k in keys]).tolist()
                    m = dict(zip(keys, vals))
                    m["step"] = step
                    now = time.perf_counter()
                    m["steps_per_s"] = (step - start_step) / (now - t0)
                    history.append(m)
                    w_steps = step - last_report[0]
                    w_dt = max(now - last_report[1], 1e-9)
                    last_report = (step, now)
                    rate = w_steps / w_dt
                    progress.report(
                        step=step,
                        steps_per_sec=rate,
                        examples_per_sec=rate * self.task.batch_size,
                        step_seconds=w_dt / w_steps,
                        input_wait_seconds=input_wait_total,
                        input_starved_steps=float(starved_steps),
                    )
                    log.info(
                        "%s step %d: %s", self.task.name, step,
                        {k: round(v, 4) for k, v in m.items()},
                    )
        finally:
            if prefetcher is not None:
                prefetcher.close()
        if ckpt and ckpt.enabled:
            if self.drained_at is not None:
                t_drain = time.perf_counter()
                ckpt.save_async(state.step, state.state_dict())
                ckpt.wait_until_finished()
                drain_s = time.perf_counter() - t_drain
                self.drained_at = state.step
                progress.report(drain_checkpoint_seconds=drain_s, step=state.step)
                log.info(
                    "%s: drain checkpoint step=%d committed in %.3fs",
                    self.task.name, state.step, drain_s,
                )
            else:
                ckpt.save(state.step, state.state_dict(), wait=True)
            ckpt.close()
        return state, history


def _unported_env(env: Dict[str, str]) -> None:
    """Raise for env knobs of the reference that this slice does not run."""
    if env.get("TFK8S_INPUT_FILES"):
        raise NotImplementedError("TFK8S_INPUT_FILES: record-file input is ROADMAP item 1.5")
    if env.get("TFK8S_INPUT_MODE", "replicated") not in ("", "replicated"):
        raise NotImplementedError(
            f"TFK8S_INPUT_MODE={env['TFK8S_INPUT_MODE']!r}: per-host and file "
            "input are ROADMAP item 1.5"
        )
    if int(env.get("TFK8S_SCAN_STEPS", "1")) > 1:
        raise NotImplementedError(
            "TFK8S_SCAN_STEPS: multi-step dispatch (a CUDA graph on the card) is "
            "ROADMAP item 1.11"
        )
    if env.get("TFK8S_PROFILE_DIR"):
        raise NotImplementedError("TFK8S_PROFILE_DIR: profiling is ROADMAP item 1.11")


def config_from_env(env: Dict[str, str], ctx: ProcessContext) -> TrainConfig:
    """The reference's ``run_task`` env contract, for the knobs ported."""
    return TrainConfig(
        steps=int(env.get("TFK8S_TRAIN_STEPS", "100")),
        learning_rate=float(env.get("TFK8S_LEARNING_RATE", "1e-3")),
        log_every=int(env.get("TFK8S_LOG_EVERY", "20")),
        checkpoint_every=int(env.get("TFK8S_CHECKPOINT_EVERY", "0")),
        checkpoint_dir=ctx.checkpoint_dir,
        seed=int(env.get("TFK8S_SEED", "0")),
        resume=ctx.resuming,
        grad_accum_steps=int(env.get("TFK8S_GRAD_ACCUM", "1")),
        warmup_steps=int(env.get("TFK8S_WARMUP_STEPS", "0")),
        lr_schedule=env.get("TFK8S_LR_SCHEDULE", "constant"),
        decay_steps=int(env["TFK8S_DECAY_STEPS"]) if env.get("TFK8S_DECAY_STEPS") else None,
        min_lr_ratio=float(env.get("TFK8S_MIN_LR_RATIO", "0.0")),
    )


def run_task(
    task: TrainTask,
    env: Optional[Dict[str, str]] = None,
    stop: Optional[Any] = None,
    config: Optional[TrainConfig] = None,
    device: Optional[torch.device] = None,
) -> List[Dict[str, float]]:
    """Entrypoint glue: env contract -> device -> (resume ->) fit ->
    metrics history. Raises if the task declares convergence targets and
    misses them — a failed pod is how the control plane learns training
    went wrong — and ``PodDrained`` after a drain (the node agent's class
    when ``stop`` comes from one). Progress goes to the node agent's sink
    and the spans continue ``TFK8S_TRACEPARENT`` (``runtime/node_agent``)."""
    env = dict(env or {})
    with node_agent.attach(stop):
        tracer = get_tracer()
        with tracer.start_span(
            "trainer.run", traceparent=env.get(TRACEPARENT_ENV),
            attributes={"task": task.name},
        ):
            with tracer.start_span("trainer.startup", attributes={"task": task.name}):
                _unported_env(env)
                ctx = ProcessContext.from_env(env)
                ctx.require_single_device()
                device = select_device(env, device)
                config = config or config_from_env(env, ctx)
                trainer = Trainer(task, config, device)
            _state, history = trainer.fit(stop=stop)
    if trainer.drained_at is not None:
        raise node_agent.pod_drained_class(stop)(
            f"{task.name}: drained at step {trainer.drained_at} on reclaim notice"
        )
    final = history[-1] if history else {}
    for metric, target in task.targets.items():
        got = final.get(metric)
        if got is None:
            raise RuntimeError(f"{task.name}: target metric {metric!r} was never reported")
        ok = got <= target if "loss" in metric else got >= target
        if not ok:
            raise RuntimeError(
                f"{task.name}: {metric}={got:.4f} missed target {target} "
                f"after {final.get('step')} steps"
            )
    return history
