"""The training loop: TrainTask -> eager PyTorch steps on one device per
process, ported from the JAX package's ``runtime/train.py``.

What is kept from the reference:
- the env contract of ``run_task`` (steps, learning rate, schedule,
  warmup, gradient accumulation, logging, checkpoint cadence, seed, input
  mode and files);
- AdamW with optax ``adamw`` semantics (b1 0.9, b2 0.999, eps 1e-8,
  decoupled weight decay) whose learning rate is the schedule read at the
  optimizer's count before the update, so warmup's first step has lr 0;
- the input modes (``TFK8S_INPUT_MODE``, auto by the reference's rule):
  ``replicated``, the stream ``np.random.default_rng(seed + step)`` of
  whole batches; ``per_host``, a batch concatenated from ``input_shards``
  shard streams seeded by ``(seed, step, shard)``, each rank building
  only the shards its rows lie in; ``files``, record shards
  (``TFK8S_INPUT_FILES``) read through ``data.dataset.RecordDataset``,
  each pod opening its round-robin share, fast-forwarded to the resume
  step, the first batch held to the task's schema. A pod
  (``TFK8S_POD_RANKS`` ranks, ``runtime/pod_ranks``) is the reference's
  process here: the auto mode, the default shard count and the file
  split follow the pods, and each rank keeps its rows. Host batches are
  synthesized ahead on a prefetch thread;
- what the shards hold (``TFK8S_INPUT_FORMAT``): ``array``, example dicts
  that decode to the task's batch; ``image``, compressed JPEG/PNG image
  records decoded and augmented on a worker pool by
  ``data.images.ImageDataset`` (``TFK8S_DECODE_WORKERS``,
  ``TFK8S_AUG_MIN_SCALE``) into the vision families' ``{"image", "label"}``
  batch at the size the task's own batch declares, and for the Evaluator
  the deterministic eval view of ``TFK8S_EVAL_INPUT_FILES``;
- multi-process parallelism over the mesh's ``data``, ``fsdp``,
  ``expert``, ``sequence`` and ``tensor`` axes
  (``parallel.data_parallel``): each rank trains on its contiguous rows
  of the global batch (by its place on data and fsdp; the ranks of a
  tensor group share theirs) and, on a sequence-sharded mesh, its
  contiguous block of the sequence (``TrainTask.split_sequence``) of the
  same numpy batch; the model a task builds over the mesh holds the
  rank's shares of it (``task_for_mesh``);
  losses and metrics are global means, read back and averaged over the
  ranks only at log boundaries;
- progress reports from each process, convergence targets, checkpoint/
  resume (a checkpoint saved by N processes restores in M), and the drain
  on a reclaim notice (``stop.drain_requested``) ending in ``PodDrained``;
- under a node agent (``runtime/node_agent``): progress reaches pod
  status through the agent's sink, a drain raises the agent's
  ``PodDrained`` (so the pod ends Drained), the first step's time is also
  reported as ``compile_seconds``, and ``run_task`` continues
  ``TFK8S_TRACEPARENT`` with ``trainer.run``, ``trainer.startup`` and
  ``trainer.first_step`` spans;
- ``run_eval``, the Evaluator replica: it scores every new checkpoint on
  held-out batches until the final step's;
- the chunked loop (``TFK8S_SCAN_STEPS``): k host batches taken in
  order, each copied to the device and stepped, with no host fetch
  between the k steps; a chunk
  never crosses a log or checkpoint boundary, and stop and drain are
  honoured between chunks. The trajectory is per-step dispatch's;
- the profile window (``TFK8S_PROFILE_DIR``): a ``torch.profiler`` trace
  of ``profile_steps`` steps after ``profile_skip``, each step one
  ``ProfilerStep#<step>`` span, written as a Chrome trace a rank under
  that directory. Profiling forces one step a dispatch.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob as globlib
import math
import os
import queue
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from tfk8s_tpu_torch.data.dataset import RecordDataset
from tfk8s_tpu_torch.obs.trace import TRACEPARENT_ENV, get_tracer
from tfk8s_tpu_torch.parallel.data_parallel import DataParallel, load_full_state_dicts, state_dicts
from tfk8s_tpu_torch.parallel.mesh import Mesh, build_mesh
from tfk8s_tpu_torch.runtime import node_agent, progress
from tfk8s_tpu_torch.runtime.checkpoint import Checkpointer
from tfk8s_tpu_torch.runtime.launcher import (ProcessContext, initialize_distributed, rank_device,
                                             select_device)
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
    ``make_batch(np_rng, batch_size)`` produces one host-side numpy batch;
    ``split_sequence(batch, index, n)`` gives rank ``index``'s block of it
    on a sequence-sharded mesh of ``n`` (None: the ``n`` contiguous blocks
    of every array's axis 1)."""

    name: str
    init: Callable[[torch.Generator], nn.Module]
    loss_fn: Callable[[nn.Module, Dict[str, torch.Tensor]],
                      Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
    make_batch: Callable[[np.random.Generator, int], Dict[str, np.ndarray]]
    batch_size: int = 32
    # metric name -> target the run should reach (convergence check)
    targets: Dict[str, float] = dataclasses.field(default_factory=dict)
    split_sequence: Optional[Callable[[Dict[str, np.ndarray], int, int],
                                      Dict[str, np.ndarray]]] = None


def keep_sequence(batch: Dict[str, np.ndarray], index: int, n: int
                  ) -> Dict[str, np.ndarray]:
    """A ``split_sequence`` that leaves every sequence rank its rows whole,
    for a model that runs them whole (the pipelined family's stages,
    DLRM's rows with no sequence)."""
    return batch


def split_sequence_axis1(batch: Dict[str, np.ndarray], index: int, n: int
                         ) -> Dict[str, np.ndarray]:
    """Block ``index`` of ``n`` of every array's axis 1 (the sequence)."""
    out = {}
    for k, v in batch.items():
        if v.shape[1] % n:
            raise ValueError(f"{k}: length {v.shape[1]} does not divide over sequence={n}")
        blk = v.shape[1] // n
        out[k] = np.ascontiguousarray(v[:, index * blk:(index + 1) * blk])
    return out


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
    # "replicated" | "per_host" | "files"; None = auto: "files" when
    # input_files is set, else "per_host" with more than one pod
    input_mode: Optional[str] = None
    # logical input shards in per_host mode (None = the pods' blocks of
    # rows: one a pod where the pods hold different rows, the reference's
    # process count); the batch content depends only on (seed, step,
    # input_shards)
    input_shards: Optional[int] = None
    # the rank processes of each pod (TFK8S_POD_RANKS): a pod stands for
    # one of the reference's processes, the host its input is divided by
    pod_ranks: int = 1
    # comma-separated record-file paths/globs (TFK8S_INPUT_FILES)
    input_files: Optional[str] = None
    # what the shards hold (TFK8S_INPUT_FORMAT): "array", example dicts
    # decoding to the task's batch; "image", JPEG/PNG image records decoded
    # and augmented on a worker pool into the vision families' batch, at
    # the image size the task's own example batch declares
    input_format: str = "array"
    # the image-decode pool's width (TFK8S_DECODE_WORKERS; None: auto)
    decode_workers: Optional[int] = None
    # the random-resized crop's area floor (TFK8S_AUG_MIN_SCALE): 0.08 is
    # ImageNet's augmentation; small or synthetic image sets train better
    # around 0.3-0.6 (data/images/transforms.train_transform)
    aug_min_scale: float = 0.08
    # "constant" | "cosine" | "linear" decay after warmup, over
    # decay_steps (None = the rest of the run) down to min_lr_ratio * lr
    lr_schedule: str = "constant"
    decay_steps: Optional[int] = None
    min_lr_ratio: float = 0.0
    # a torch.profiler trace of profile_steps steps after profile_skip,
    # written under profile_dir (empty: no trace)
    profile_dir: str = ""
    profile_skip: int = 3
    profile_steps: int = 5
    # >1: this many steps a dispatch with no host fetch between them,
    # clamped to the next log and checkpoint boundary; forced to 1 while
    # profiling
    scan_steps: int = 1

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
    parallel: Optional[DataParallel] = None

    def state_dict(self) -> Dict[str, Any]:
        """Model and optimizer state keyed by parameter name, whatever
        wraps the model (this rank's shards under FSDP; expert shards
        gathered whole)."""
        return {"step": self.step, **state_dicts(self.model, self.optimizer, self.parallel)}

    def load_state_dict(self, saved: Dict[str, Any]) -> None:
        """Load a whole (unsharded) saved state into this rank's layout."""
        load_full_state_dicts(self.model, self.optimizer, saved, self.parallel)
        self.step = int(saved["step"])


def _expand_input_files(spec: str) -> List[str]:
    """Expand a comma-separated list of record-file paths/globs (the
    TFK8S_INPUT_FILES / TFK8S_EVAL_INPUT_FILES value) into a concrete
    path list; a glob matching nothing fails loudly."""
    paths: List[str] = []
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        if any(c in part for c in "*?["):
            hits = sorted(globlib.glob(part))
            if not hits:
                raise ValueError(f"input pattern matched nothing: {part!r}")
            paths.extend(hits)
        else:
            paths.append(part)
    if not paths:
        raise ValueError(f"input file spec is empty: {spec!r}")
    return paths


class _CheckedFileStream:
    """Iterator over a RecordDataset iterator that holds the FIRST decoded
    batch to the task's batch schema (keys, per-row shapes, dtypes, local
    row count): a records/task mismatch fails with a schema message, not a
    shape error deep inside the model."""

    def __init__(self, it: Iterator, want_example: Dict[str, np.ndarray], local_rows: int,
                 dataset: Optional[RecordDataset] = None):
        self._it = it
        self._want = want_example
        self._rows = local_rows
        self._checked = False
        # its bytes_read feeds the windowed input MB/s progress report
        self.dataset = dataset

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        raw = next(self._it)
        if not self._checked:
            self._checked = True
            if sorted(raw) != sorted(self._want):
                raise ValueError(
                    f"record schema {sorted(raw)} does not match the task's "
                    f"batch schema {sorted(self._want)}"
                )
            for k in sorted(raw):
                ga, wa = np.asarray(raw[k]), np.asarray(self._want[k])
                if ga.shape[1:] != wa.shape[1:] or ga.dtype != wa.dtype:
                    raise ValueError(
                        "record example mismatch: got "
                        f"{ga.dtype}{list(ga.shape[1:])} per row, "
                        f"task expects {wa.dtype}{list(wa.shape[1:])}"
                    )
                if ga.shape[0] != self._rows:
                    raise ValueError(
                        f"dataset produced {ga.shape[0]} rows, expected {self._rows}"
                    )
        return raw

    def close(self) -> None:
        self._it.close()
        if self.dataset is not None:
            # joins an image dataset's decode pool; a no-op for records
            self.dataset.close()


def _image_geometry(want_example: Dict[str, np.ndarray]) -> int:
    """The decode size from a vision task's own example batch: its
    ``image`` leaf must be square ``[*, S, S, 3]``, as the ResNet and ViT
    batches are. A task without one is refused here, naming what it has."""
    leaf = want_example.get("image")
    if leaf is None:
        raise ValueError(
            'input_format="image" needs a task whose batch schema has an '
            f'"image" leaf (the vision families); this task has {sorted(want_example)}'
        )
    shape = np.asarray(leaf).shape
    if len(shape) != 4 or shape[1] != shape[2] or shape[3] != 3:
        raise ValueError(
            f"image input needs a square [B, S, S, 3] image leaf, task "
            f"expects {list(shape)}"
        )
    return int(shape[1])


def _open_image_dataset(paths: List[str], local_rows: int, want_example: Dict[str, np.ndarray],
                        *, train: bool, seed: int = 0, workers: Optional[int] = None,
                        min_scale: float = 0.08, host_index: int = 0, num_hosts: int = 1):
    """The decode-and-augment pipeline (``data.images.ImageDataset``) over
    ``paths``, batches of this process's rows at the geometry the task's
    batch declares."""
    from tfk8s_tpu_torch.data.images import ImageDataset

    return ImageDataset(paths, batch_size=local_rows, image_size=_image_geometry(want_example),
                        train=train, workers=workers, host_index=host_index,
                        num_hosts=num_hosts, seed=seed, min_scale=min_scale)


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

    def depth(self) -> int:
        """Batches staged now: pinned at 0, the producer (not the device)
        is the bottleneck."""
        return self._q.qsize()

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
    def __init__(self, task: TrainTask, config: TrainConfig, device: torch.device,
                 parallel: Optional[DataParallel] = None):
        self.task = task
        self.config = config
        self.device = torch.device(device)
        self.parallel = parallel or DataParallel(None, self.device)
        self.schedule = config.make_schedule()
        # set by fit() when a reclaim notice drained the run
        self.drained_at: Optional[int] = None
        # set by fit() in per_host and multi-process files input:
        # (shard_lo, shard_hi, num_shards) of this process
        self.input_shard_range: Optional[Tuple[int, int, int]] = None
        # this rank's rows of the shards it builds (per_host) and of its
        # pod's file batch (files)
        self._shard_rows: Optional[slice] = None
        self._file_rows: Optional[slice] = None
        accum = max(config.grad_accum_steps, 1)
        if task.batch_size % accum:
            raise ValueError(
                f"grad_accum_steps={accum} does not divide batch_size={task.batch_size}"
            )

    def init_state(self) -> TrainState:
        generator = torch.Generator().manual_seed(self.config.seed)
        model = self.parallel.wrap(self.task.init(generator).to(self.device))
        optimizer = torch.optim.AdamW(
            model.parameters(), lr=self.schedule(0), betas=(0.9, 0.999),
            eps=1e-8, weight_decay=self.config.weight_decay,
        )
        return TrainState(step=0, model=model, optimizer=optimizer, parallel=self.parallel)

    def to_device(self, host_batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {
            k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device, non_blocking=True)
            for k, v in host_batch.items()
        }

    def train_step(self, state: TrainState, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One optimizer update on this rank's rows; returns the step's
        metrics as device tensors, this rank's local means (nothing is
        fetched to the host here)."""
        accum = max(self.config.grad_accum_steps, 1)
        model, opt = state.model, state.optimizer
        opt.zero_grad(set_to_none=True)
        # contiguous row chunks: the reference's [accum, B/accum] split
        micro = [dict(zip(batch, parts)) for parts in
                 zip(*(v.chunk(accum, dim=0) for v in batch.values()))]
        loss, aux = torch.zeros((), device=self.device), {}
        for i, mb in enumerate(micro):
            with self.parallel.no_sync(model, last=i == accum - 1):
                loss_i, aux_i = self.task.loss_fn(model, mb)
                (loss_i / accum).backward()
            loss = loss + loss_i.detach().float() / accum
            for k, v in aux_i.items():
                aux[k] = aux.get(k, 0.0) + v.detach().float() / accum
        self.parallel.reduce_gradients(model)
        grad_norm = self.parallel.grad_norm(model)
        lr = self.schedule(state.step)  # optax reads the pre-update count
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        state.step += 1
        return {"loss": loss, "grad_norm": grad_norm, **aux}

    # -- input ----------------------------------------------------------------

    def pods(self) -> int:
        """The job's pods: its processes in the reference's sense, each
        running ``pod_ranks`` of the world's ranks."""
        world, per = self.parallel.world, max(self.config.pod_ranks, 1)
        if world % per:
            raise ValueError(f"{world} ranks do not divide into pods of {per}")
        return world // per

    def _rows(self) -> Tuple[int, int, int, int]:
        """``(lo, hi, pod_lo, pod_hi)``: the contiguous rows of the global
        batch this rank holds (by its place on the data and fsdp axes) and
        those its pod's ranks hold together, the rows the reference's
        process reads off its devices' sharding."""
        par, per = self.parallel, max(self.config.pod_ranks, 1)
        local = par.local_rows(self.task.batch_size)
        lo = par.batch_rank * local
        first = par.rank - par.rank % per
        blocks = sorted({par.layout.batch_index_of(r) for r in range(first, first + per)}
                        if par.world > 1 else {0})
        if blocks != list(range(blocks[0], blocks[-1] + 1)):
            raise ValueError(
                f"per-host input needs a contiguous local batch range; the pod of "
                f"rank {par.rank} holds batch blocks {blocks}"
            )
        return lo, lo + local, blocks[0] * local, (blocks[-1] + 1) * local

    def _pod_block(self) -> Tuple[int, int]:
        """``(block, blocks)``: this pod's block of the global batch's rows
        and the number of such blocks (pods that hold the same rows, over
        a model axis, share one), as the reference's processes divide
        the files and, by default, the per_host shards."""
        _, _, pod_lo, pod_hi = self._rows()
        return pod_lo // (pod_hi - pod_lo), self.task.batch_size // (pod_hi - pod_lo)

    def input_mode(self) -> str:
        """The reference's rule: ``files`` when input files are given,
        else ``per_host`` with more than one pod (the reference's
        process), else ``replicated``."""
        cfg = self.config
        mode = cfg.input_mode or (
            "files" if cfg.input_files
            else ("per_host" if self.pods() > 1 else "replicated")
        )
        if mode not in ("replicated", "per_host", "files"):
            raise ValueError(f"unknown input_mode {cfg.input_mode!r}")
        if mode == "files" and not cfg.input_files:
            raise ValueError('input_mode="files" needs input_files')
        if cfg.input_files and mode != "files":
            raise ValueError(
                f"input_files is set but input_mode={mode!r} would "
                'ignore it — use input_mode="files" (or unset one)'
            )
        return mode

    def _input_shard_plan(self, num_shards: Optional[int] = None) -> Tuple[int, int, int]:
        """``(shard_lo, shard_hi, num_shards)``: the half-open range of
        input shards this rank builds, those that hold its contiguous rows
        ``[lo, hi)`` of the global batch. As in the reference, the shards
        must not straddle pods (its processes); within a pod a rank builds
        the shards its rows lie in and keeps its rows (``_shard_rows``).
        ``num_shards=None`` uses the config (per_host mode), whose default
        is the pods' row blocks (:meth:`_pod_block`)."""
        cfg, task = self.config, self.task
        num_shards = num_shards or cfg.input_shards or self._pod_block()[1]
        accum = max(cfg.grad_accum_steps, 1)
        if task.batch_size % num_shards:
            raise ValueError(
                f"input_shards={num_shards} does not divide batch_size={task.batch_size}"
            )
        if (task.batch_size // num_shards) % accum:
            raise ValueError(
                f"per-shard batch {task.batch_size // num_shards} must be "
                f"a multiple of grad_accum_steps={accum}"
            )
        lo, hi, pod_lo, pod_hi = self._rows()
        rows_per_shard = task.batch_size // num_shards
        if pod_lo % rows_per_shard or pod_hi % rows_per_shard:
            raise ValueError(
                f"process-local rows [{pod_lo},{pod_hi}) are not aligned to "
                f"{rows_per_shard} rows/shard; pick input_shards such that "
                "shards don't straddle processes"
            )
        shard_lo, shard_hi = lo // rows_per_shard, -(-hi // rows_per_shard)
        start = lo - shard_lo * rows_per_shard
        self._shard_rows = slice(start, start + hi - lo)
        return shard_lo, shard_hi, num_shards

    def _open_input_files(self, start_step: int) -> _CheckedFileStream:
        """The record-shard stream (files mode): this pod's round-robin
        file share (or, with fewer files than pods, a record stripe,
        warned loudly), batches of the pod's rows, of which this rank keeps
        its own (``_file_rows``), the first held to the task's schema,
        fast-forwarded to ``start_step`` (one batch a step) so a resume
        continues the exact record stream."""
        cfg, task = self.config, self.task
        paths = _expand_input_files(cfg.input_files or "")
        # the files divide by the pods' row blocks, as the reference gives
        # them to its processes; the pods (and ranks) of one block, its
        # model axes' ranks, read the same records, and each rank of a
        # pod keeps its rows of the pod's batch
        lo, hi, pod_lo, pod_hi = self._rows()
        pod_rows = pod_hi - pod_lo
        host, hosts = self._pod_block()
        if cfg.input_shards is not None:
            log.warning(
                "%s: input_shards=%d is ignored in input_mode='files' "
                "(file input divides per process: %d); unset it or use "
                "input_mode='per_host'", task.name, cfg.input_shards, hosts,
            )
        if hosts > 1:
            self.input_shard_range = self._input_shard_plan(num_shards=hosts)
        self._file_rows = slice(lo - pod_lo, hi - pod_lo)
        want = task.make_batch(np.random.default_rng(0), 1)
        if cfg.input_format == "image":
            ds = _open_image_dataset(paths, pod_rows, want, train=True, seed=cfg.seed,
                                     workers=cfg.decode_workers, min_scale=cfg.aug_min_scale,
                                     host_index=host, num_hosts=hosts)
        elif cfg.input_format == "array":
            ds = RecordDataset(paths, batch_size=pod_rows, host_index=host,
                               num_hosts=hosts, seed=cfg.seed)
        else:
            raise ValueError(f"unknown input_format {cfg.input_format!r} (array | image)")
        if ds.shard_by == "records" and hosts > 1:
            log.warning(
                "%s: only %d record files for %d processes — falling back "
                "to RECORD striping (every process reads all files; write "
                ">= one file per host to restore per-host file IO)",
                task.name, len(ds.files), hosts,
            )
        backend = getattr(ds, "backend", None)  # the image decode backend
        log.info(
            "%s: %s file input (%s-sharded%s) — process %d/%d reads %d files / "
            "%d records, %d rows/step (this rank's [%d, %d)), resuming at batch %d",
            task.name, cfg.input_format, ds.shard_by, f", {backend} decode" if backend else "",
            host, hosts, len(ds.files), len(ds), pod_rows, lo - pod_lo, hi - pod_lo, start_step,
        )
        # prefetch=0: fit's own prefetcher is the background thread (an
        # image dataset's decode pool still works within each batch)
        it = ds.iterator(prefetch=0, start_batch=start_step)
        return _CheckedFileStream(it, want, pod_rows, dataset=ds)

    def _make_shard_batch(self, step: int, shard_lo: int, shard_hi: int,
                          num_shards: int) -> Dict[str, np.ndarray]:
        """This process's input shards for one step, each from a fresh
        generator seeded by (seed, step, shard): the content depends only
        on those three values, whichever process builds it."""
        shard_size = self.task.batch_size // num_shards
        parts = [
            self.task.make_batch(
                np.random.default_rng(np.random.SeedSequence([self.config.seed, step, s])),
                shard_size,
            )
            for s in range(shard_lo, shard_hi)
        ]
        if len(parts) == 1:
            return parts[0]
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}

    # -- the profile window ---------------------------------------------------

    def _prepare_profile(self) -> torch.profiler.profile:
        """A ``torch.profiler`` trace of the host, and of the card when the
        device is one, with its collection brought up but not recording.
        In a process that traced before, CUPTI comes up again lazily and
        can lose the first kernels after a start, so ``fit`` prepares the
        trace a step ahead of its window (``torch.profiler``'s warmup)."""
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.prepare_trace()
        return profiler

    def _start_profile(self, profiler: torch.profiler.profile) -> None:
        """Start recording, with nothing of earlier steps queued."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.start_trace()

    def _stop_profile(self, profiler: torch.profiler.profile,
                      metrics: Optional[Dict[str, torch.Tensor]], first: int, last: int) -> None:
        """Drain the queued work, stop the trace and write it as this
        rank's Chrome trace of steps ``first + 1 .. last`` under
        ``profile_dir``. With no ``metrics`` (a step raised) nothing is
        drained: after a device fault a fetch would raise again."""
        if metrics is not None:
            float(metrics["loss"])  # one host fetch: the step's work is done
            if self.device.type == "cuda":
                # the loss precedes the optimizer's kernels on the stream
                torch.cuda.synchronize(self.device)
        profiler.stop_trace()
        os.makedirs(self.config.profile_dir, exist_ok=True)
        path = os.path.join(
            self.config.profile_dir,
            f"{self.task.name}-rank{self.parallel.rank}-steps{first + 1}-{last}.pt.trace.json")
        profiler.export_chrome_trace(path)
        log.info("%s: profile trace written to %s", self.task.name, path)

    # -- the loop -------------------------------------------------------------

    def fit(
        self,
        state: Optional[TrainState] = None,
        stop: Optional[Any] = None,  # threading.Event-like graceful preemption
    ) -> Tuple[TrainState, List[Dict[str, float]]]:
        cfg, par = self.config, self.parallel
        ckpt = Checkpointer(cfg.checkpoint_dir) if cfg.checkpoint_dir else None
        if state is None:
            state = self.init_state()
            if cfg.resume and ckpt and ckpt.latest_step() is not None:
                state.load_state_dict(ckpt.restore())
                log.info("%s: resumed at step %d", self.task.name, state.step)

        history: List[Dict[str, float]] = []
        start_step = state.step
        mode = self.input_mode()
        files_iter: Optional[_CheckedFileStream] = None
        if mode == "files":
            files_iter = self._open_input_files(start_step)
        elif mode == "per_host":
            shard_lo, shard_hi, num_shards = self._input_shard_plan()
            self.input_shard_range = (shard_lo, shard_hi, num_shards)
            log.info("%s: per-host input — process %d/%d builds shards [%d, %d) of %d",
                     self.task.name, par.rank, par.world, shard_lo, shard_hi, num_shards)
        else:
            # the replicated stream: owned by the producer (thread or this
            # loop); with several processes each keeps its own rows
            np_rng = np.random.default_rng(cfg.seed + start_step)
            lo, hi, _, _ = self._rows()
            rows = slice(lo, hi)
        split = self.task.split_sequence or split_sequence_axis1

        def _rows_batch(step: int) -> Dict[str, np.ndarray]:
            if files_iter is not None:
                batch, keep = next(files_iter), self._file_rows
            elif mode == "per_host":
                batch = self._make_shard_batch(step, shard_lo, shard_hi, num_shards)
                keep = self._shard_rows
            else:
                batch, keep = self.task.make_batch(np_rng, self.task.batch_size), rows
            if keep == slice(0, len(next(iter(batch.values())))):
                return batch
            return {k: v[keep] for k, v in batch.items()}

        def _make_host_batch(step: int) -> Dict[str, np.ndarray]:
            batch = _rows_batch(step)
            if par.seq_size > 1:
                batch = split(batch, par.seq_index, par.seq_size)
            return batch

        prefetcher = (
            _BatchPrefetcher(_make_host_batch, start_step, cfg.steps, cfg.prefetch)
            if cfg.prefetch > 1 else None
        )

        def _chunk(step: int, k: int) -> Tuple[Dict[str, torch.Tensor], float]:
            """Steps ``step + 1 .. step + k`` on their host batches, taken
            in order, with nothing fetched to the host between the steps;
            (the last step's metrics, the host wait for the batches)."""
            t_in = time.perf_counter()
            hosts = [prefetcher.get() if prefetcher is not None else _make_host_batch(step + i)
                     for i in range(k)]
            input_wait = time.perf_counter() - t_in
            for host in hosts:
                metrics = self.train_step(state, self.to_device(host))
            return metrics, input_wait

        # scan steps a dispatch, never across a log or checkpoint boundary;
        # profiling keeps one step a dispatch, so the trace holds a span a step
        scan = max(cfg.scan_steps, 1)
        if cfg.profile_dir and scan > 1:
            log.info("%s: profiling active — forcing scan_steps=1", self.task.name)
            scan = 1
        prof_start = start_step + cfg.profile_skip if cfg.profile_dir else -1
        prof_stop = prof_start + cfg.profile_steps
        warm_at = max(prof_start - 1, start_step) if cfg.profile_dir else -1
        profiler: Optional[torch.profiler.profile] = None
        recording = False
        metrics: Optional[Dict[str, torch.Tensor]] = None
        t0 = time.perf_counter()
        last_report = (start_step, t0)
        last_bytes = 0
        last_images = 0  # the decoded-image window's anchor (image input)
        first_step_s: Optional[float] = None
        input_wait_total, starved_steps = 0.0, 0
        finished = False
        # with several ranks, a notice one rank sees is every rank's at the
        # same step, so none enters a step whose collectives another left
        signals = dist.new_group(backend="gloo") if stop is not None and par.world > 1 else None
        try:
            step = start_step
            while step < cfg.steps:
                stopping, draining = _signals(stop, signals)
                if stopping:
                    log.info("%s: stop requested at step %d", self.task.name, step)
                    break
                if draining:
                    self.drained_at = step
                    log.info("%s: reclaim notice at step %d; draining", self.task.name, step)
                    break
                if step == warm_at:
                    profiler = self._prepare_profile()
                if step == prof_start:
                    self._start_profile(profiler)
                    recording = True
                k = min(scan, cfg.steps - step, cfg.log_every - step % cfg.log_every)
                if ckpt and cfg.checkpoint_every:
                    k = min(k, cfg.checkpoint_every - step % cfg.checkpoint_every)
                span = (torch.profiler.record_function(f"ProfilerStep#{step + 1}")
                        if recording else contextlib.nullcontext())
                with span:
                    it_t0 = time.perf_counter()
                    if first_step_s is None:
                        # the first dispatch builds the kernels and warms
                        # the libraries: span it and report it apart, after
                        # it has finished (the reference's one-time start
                        # cost, so also under the key the controller mirrors)
                        with get_tracer().start_span(
                            "trainer.first_step", attributes={"task": self.task.name}
                        ):
                            metrics, input_wait = _chunk(step, k)
                            float(metrics["loss"])
                        first_step_s = time.perf_counter() - it_t0
                        progress.report(first_step_seconds=first_step_s,
                                        compile_seconds=first_step_s)
                    else:
                        metrics, input_wait = _chunk(step, k)
                    step = state.step
                    it_dt = time.perf_counter() - it_t0
                    input_wait_total += input_wait
                    if input_wait > _INPUT_STARVED_FRACTION * max(it_dt, 1e-9):
                        starved_steps += k
                    if ckpt and cfg.checkpoint_every and step % cfg.checkpoint_every == 0:
                        ckpt.save(step, state.state_dict(), sharded=par.sharded)
                    elif ckpt:
                        ckpt.maybe_commit()
                    if step % cfg.log_every == 0 or step == cfg.steps:
                        # one host transfer (and one all-reduce) for the
                        # whole metrics dict; grad_norm is global already
                        keys = sorted(metrics)
                        vals = par.reduce_metrics(
                            torch.stack([metrics[k].float() for k in keys]),
                            keep=torch.tensor([k == "grad_norm" for k in keys],
                                              device=self.device),
                        ).tolist()
                        m = dict(zip(keys, vals))
                        m["step"] = step
                        now = time.perf_counter()
                        m["steps_per_s"] = (step - start_step) / (now - t0)
                        history.append(m)
                        w_steps = step - last_report[0]
                        w_dt = max(now - last_report[1], 1e-9)
                        last_report = (step, now)
                        rate = w_steps / w_dt
                        report_kw = dict(
                            step=step,
                            steps_per_sec=rate,
                            examples_per_sec=rate * self.task.batch_size,
                            step_seconds=w_dt / w_steps,
                            input_wait_seconds=input_wait_total,
                            input_starved_steps=float(starved_steps),
                        )
                        if files_iter is not None:
                            b_now = files_iter.dataset.bytes_read
                            report_kw["input_mb_per_sec"] = (b_now - last_bytes) / w_dt / 1e6
                            last_bytes = b_now
                            i_now = getattr(files_iter.dataset, "images_decoded", None)
                            if i_now is not None:
                                # the decode pool's delivered rate, beside
                                # the input MB/s, and fit's prefetch queue
                                # (between decode and device) as the
                                # staged-batch gauge
                                report_kw["decoded_images_per_sec"] = (i_now - last_images) / w_dt
                                last_images = i_now
                                _report_queue_depth(prefetcher)
                        progress.report(**report_kw)
                        log.info(
                            "%s step %d: %s", self.task.name, step,
                            {k: round(v, 4) for k, v in m.items()},
                        )
                if recording and step >= prof_stop:
                    self._stop_profile(profiler, metrics, prof_start, step)
                    profiler, recording = None, False
            finished = True
        finally:
            if prefetcher is not None:
                prefetcher.close()
            if files_iter is not None:
                files_iter.close()
            if recording and finished:  # the run ended inside the window
                self._stop_profile(profiler, metrics, prof_start, state.step)
            elif recording:
                # a step raised: write what was traced, and let the step's
                # own exception be the one that propagates
                try:
                    self._stop_profile(profiler, None, prof_start, state.step)
                except Exception:
                    log.exception("%s: profile trace not written", self.task.name)
            elif profiler is not None:  # it ended before the window: no trace
                profiler.start_trace()
                profiler.stop_trace()
        if ckpt and ckpt.enabled:
            if self.drained_at is not None:
                t_drain = time.perf_counter()
                ckpt.save_async(state.step, state.state_dict(), sharded=par.sharded)
                ckpt.wait_until_finished()
                drain_s = time.perf_counter() - t_drain
                self.drained_at = state.step
                progress.report(drain_checkpoint_seconds=drain_s, step=state.step)
                log.info(
                    "%s: drain checkpoint step=%d committed in %.3fs",
                    self.task.name, state.step, drain_s,
                )
            else:
                ckpt.save(state.step, state.state_dict(), wait=True, sharded=par.sharded)
            ckpt.close()
        return state, history


def _signals(stop: Optional[Any], group) -> Tuple[bool, bool]:
    """``(stop, drain)``: the node agent's stop and reclaim notice, and
    over the ranks' ``group`` (gloo, host tensors: no device sync) either
    one any rank has seen."""
    flags = [bool(stop is not None and getattr(stop, "is_set", lambda: False)()),
             bool(getattr(stop, "drain_requested", False))]
    if group is not None:
        agreed = torch.tensor(flags, dtype=torch.int32)
        dist.all_reduce(agreed, op=dist.ReduceOp.MAX, group=group)
        flags = [bool(f) for f in agreed.tolist()]
    return flags[0], flags[1]


def _report_queue_depth(prefetcher: Optional[_BatchPrefetcher]) -> None:
    """The ``tfk8s_image_decode_queue_depth{mode="train"}`` gauge, where a
    metrics registry is installed (``data.images.set_metrics``)."""
    from tfk8s_tpu_torch.data.images.pipeline import get_metrics

    m = get_metrics()
    if m is not None and prefetcher is not None:
        m.set_gauge("tfk8s_image_decode_queue_depth", float(prefetcher.depth()),
                    labels={"mode": "train"})


def _decode_workers(env: Dict[str, str]) -> Optional[int]:
    return int(env["TFK8S_DECODE_WORKERS"]) if env.get("TFK8S_DECODE_WORKERS") else None


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
        input_mode=env.get("TFK8S_INPUT_MODE") or None,
        input_shards=int(env["TFK8S_INPUT_SHARDS"]) if env.get("TFK8S_INPUT_SHARDS") else None,
        input_files=env.get("TFK8S_INPUT_FILES") or None,
        input_format=env.get("TFK8S_INPUT_FORMAT", "array"),
        decode_workers=_decode_workers(env),
        aug_min_scale=float(env.get("TFK8S_AUG_MIN_SCALE", "0.08")),
        warmup_steps=int(env.get("TFK8S_WARMUP_STEPS", "0")),
        lr_schedule=env.get("TFK8S_LR_SCHEDULE", "constant"),
        decay_steps=int(env["TFK8S_DECAY_STEPS"]) if env.get("TFK8S_DECAY_STEPS") else None,
        min_lr_ratio=float(env.get("TFK8S_MIN_LR_RATIO", "0.0")),
        profile_dir=env.get("TFK8S_PROFILE_DIR", ""),
        scan_steps=int(env.get("TFK8S_SCAN_STEPS", "1")),
        pod_ranks=ctx.local_ranks,
    )


def join_mesh(env: Dict[str, str], device: Optional[torch.device] = None,
              ) -> Tuple[ProcessContext, torch.device, Mesh]:
    """:func:`join_job`, then this rank's :class:`parallel.mesh.Mesh`: what
    an entrypoint builds its task over (the reference's ``build_mesh``,
    slice-major for a multislice job)."""
    ctx, device = join_job(env, device)
    return ctx, device, build_mesh(ctx.mesh, device, ctx.num_slices, ctx.slice_id)


def join_job(env: Dict[str, str], device: Optional[torch.device] = None,
             ) -> Tuple[ProcessContext, torch.device]:
    """Env -> process context, the process group (when the job has one)
    and this rank's device: with several cards on the host, a pod's rank
    ``l`` takes card ``l % cards`` (``launcher.rank_device``), over NCCL
    when each rank has a card of its own and gloo when they share one.
    Without a process group the process trains alone (replicas run as
    threads of one process), on one device."""
    ctx = ProcessContext.from_env(env)
    device = select_device(env, device)
    if initialize_distributed(ctx, env, device=device) and device.type == "cuda":
        device = rank_device(ctx, device)
        torch.cuda.set_device(device)
    return ctx, device


def run_task(
    task: TrainTask,
    env: Optional[Dict[str, str]] = None,
    stop: Optional[Any] = None,
    config: Optional[TrainConfig] = None,
    device: Optional[torch.device] = None,
    mesh: Optional[Mesh] = None,
) -> List[Dict[str, float]]:
    """Entrypoint glue: env contract -> process group, device and mesh
    (:func:`join_mesh`, or the ``mesh`` the caller joined and built the
    task over) -> (resume ->) fit
    -> metrics history. Raises if the task declares
    convergence targets and misses them — a failed pod is how the control
    plane learns training went wrong — and ``PodDrained`` after a drain
    (the node agent's class when ``stop`` comes from one). Progress goes
    to the node agent's sink and the spans continue ``TFK8S_TRACEPARENT``
    (``runtime/node_agent``)."""
    env = dict(env or {})
    with node_agent.attach(stop):
        tracer = get_tracer()
        with tracer.start_span(
            "trainer.run", traceparent=env.get(TRACEPARENT_ENV),
            attributes={"task": task.name},
        ):
            with tracer.start_span("trainer.startup", attributes={"task": task.name}):
                if mesh is None:
                    ctx, device, mesh = join_mesh(env, device)
                else:
                    ctx, device = ProcessContext.from_env(env), mesh.device
                config = config or config_from_env(env, ctx)
                trainer = Trainer(task, config, device, DataParallel(mesh, device))
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


def run_eval(
    task: TrainTask,
    env: Optional[Dict[str, str]] = None,
    stop: Optional[Any] = None,
    device: Optional[torch.device] = None,
) -> Dict[str, float]:
    """The Evaluator replica: poll the job's checkpoint dir, score each NEW
    checkpoint on held-out batches, and return once the final training
    step (``TFK8S_TRAIN_STEPS``) has been scored. Raises if no new
    checkpoint appears within ``TFK8S_EVAL_TIMEOUT`` seconds (the clock
    restarts on every new one): a failed evaluator pod is how the control
    plane learns evaluation is wedged.

    The held-out batches are ``TFK8S_EVAL_BATCHES`` draws of the stream
    ``default_rng(10_000)``, or the first batches of the record shards
    ``TFK8S_EVAL_INPUT_FILES`` read unshuffled, materialised once so every
    checkpoint is scored on the same ones. Metrics are the means over the
    batches of the task's loss and metrics."""
    env = dict(env or {})
    ctx = ProcessContext.from_env(env)
    if not ctx.checkpoint_dir:
        raise RuntimeError(
            f"{task.name}: evaluator needs TFK8S_CHECKPOINT_DIR "
            "(set the tfk8s.dev/checkpoint-dir job annotation)"
        )
    # the evaluator is a rank of the job's process group (the controller's
    # TFK8S_NUM_PROCESSES counts every replica): the gang waits for it. It
    # runs one rank on one device whatever the mesh, and never spawns
    _ctx, device = join_job(env, device)
    final_step = int(env.get("TFK8S_TRAIN_STEPS", "0"))
    timeout = float(env.get("TFK8S_EVAL_TIMEOUT", "300"))
    eval_batches = int(env.get("TFK8S_EVAL_BATCHES", "4"))

    model = task.init(torch.Generator().manual_seed(0)).to(device)
    np_rng = np.random.default_rng(10_000)  # held-out stream
    eval_files = env.get("TFK8S_EVAL_INPUT_FILES")
    if eval_files:
        want = task.make_batch(np.random.default_rng(0), 1)
        if env.get("TFK8S_INPUT_FORMAT", "array") == "image":
            # the deterministic eval view (resize, center crop, unshuffled):
            # every checkpoint is scored on the same pixels
            eval_ds = _open_image_dataset(_expand_input_files(eval_files), task.batch_size,
                                          want, train=False, workers=_decode_workers(env))
        else:
            eval_ds = RecordDataset(_expand_input_files(eval_files),
                                    batch_size=task.batch_size, shuffle=False)
        avail = eval_ds.batches_per_epoch()
        if avail < eval_batches:
            log.info("%s-eval: eval set holds %d batches; clamping "
                     "TFK8S_EVAL_BATCHES from %d", task.name, avail, eval_batches)
            eval_batches = avail
        checked = _CheckedFileStream(eval_ds.batches(0), want, task.batch_size)
        eval_set = [next(checked) for _ in range(eval_batches)]
        eval_ds.close()  # the decode pool is done once the set is held
    # the evaluator only reads checkpoints: it never commits or waits on
    # the gang's barrier
    ckpt = Checkpointer(ctx.checkpoint_dir)

    last_seen = -1
    metrics: Dict[str, float] = {}
    deadline = time.time() + timeout
    while time.time() < deadline:
        if stop is not None and getattr(stop, "is_set", lambda: False)():
            log.info("%s-eval: stop requested", task.name)
            return metrics
        step = ckpt.latest_step()
        if step is not None and step > last_seen:
            model.load_state_dict(ckpt.restore(step, map_location=device)["model"])
            sums: Dict[str, float] = {}
            with torch.no_grad():
                for bi in range(eval_batches):
                    host = eval_set[bi] if eval_files else task.make_batch(np_rng, task.batch_size)
                    loss, aux = task.loss_fn(model, {
                        k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                        for k, v in host.items()
                    })
                    for k, v in {"loss": loss, **aux}.items():
                        sums[k] = sums.get(k, 0.0) + float(v)
            metrics = {k: v / eval_batches for k, v in sums.items()}
            metrics["step"] = float(step)
            log.info("%s-eval step %d: %s", task.name, step,
                     {k: round(v, 4) for k, v in metrics.items()})
            last_seen = step
            if final_step and step >= final_step:
                return metrics
            deadline = time.time() + timeout  # progress -> new window
        time.sleep(0.2)
    raise RuntimeError(
        f"{task.name}: evaluator saw no new checkpoint (step > {last_seen}) "
        f"for {timeout:.0f}s (final step wanted: {final_step})"
    )
