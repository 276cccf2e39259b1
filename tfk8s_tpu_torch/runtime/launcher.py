"""Worker-side launcher: the data plane's entry contract.

Decodes the same ``TFK8S_*`` pod env the JAX package's launcher reads,
joins the job's process group and picks the torch device. The port runs
one rank process per device, on the card unless the caller asks for the
CPU (``TFK8S_DEVICE=cpu``, or a ``device=`` argument); with no card and no
such request it raises rather than quietly running on the CPU.

A pod stands for one of the reference's processes, which drives every
device of its host. Where ``TFK8S_MESH`` spans more devices than the job
has processes, each pod runs :meth:`ProcessContext.pod_ranks` rank
processes (``runtime/pod_ranks``): rank ``l`` of pod ``p`` is global rank
``p * d + l`` of ``n * d``, the reference's process-major device order,
and takes card ``l`` of its host. Such a rank carries its place in the
pod as ``TFK8S_LOCAL_RANK`` and ``TFK8S_POD_RANKS``. A mesh larger than
the processes that they do not divide raises ``ValueError``, naming both
numbers.

``initialize_distributed`` is gated as the reference's is: only with more
than one process AND ``TFK8S_DISTRIBUTED=1`` does it call
``torch.distributed.init_process_group``, so replicas run as threads of
one process never bind ports. Its backend is NCCL where every rank of the
host has a card of its own, gloo where ranks share a card or run on the
CPU (:func:`backend_for`). A mesh axis outside the reference's six
(``MeshConfig.require_ported``) raises ``NotImplementedError``; every axis
runs, in every combination (``parallel/mesh.build_mesh``), and a
multislice job's ``num_slices`` and ``slice_id`` go to ``build_mesh``,
which holds the layout to the reference's slice rule and places the ranks
slice-major.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Union

import torch
import torch.distributed as dist

from tfk8s_tpu_torch.parallel.mesh import MeshConfig
from tfk8s_tpu_torch.utils.logging import get_logger

log = get_logger("launcher")

DEVICE_ENV = "TFK8S_DEVICE"
# a pod's rank processes: this rank's index in its pod, and their number
LOCAL_RANK_ENV = "TFK8S_LOCAL_RANK"
POD_RANKS_ENV = "TFK8S_POD_RANKS"


@dataclasses.dataclass
class ProcessContext:
    """Everything a training process learns from its pod env."""

    job_name: str = "local"
    namespace: str = "default"
    replica_type: str = "Worker"
    replica_index: int = 0
    process_id: int = 0
    num_processes: int = 1
    coordinator_address: str = ""
    accelerator: str = ""
    num_slices: int = 1
    slice_id: str = ""
    host_index: int = 0
    gang_restarts: int = 0
    # bumped by the controller on every gang resize; nonzero means this
    # incarnation must resume from checkpoint
    world_version: int = 0
    checkpoint_dir: str = ""
    # TFK8S_MESH as the controller rendered it (None: data over the ranks)
    mesh: Optional[MeshConfig] = None
    # this rank's index among its pod's ranks (a process started alone on
    # its host: its process id) and their number (TFK8S_LOCAL_RANK,
    # TFK8S_POD_RANKS, set by the pod's spawner)
    local_rank: int = 0
    local_ranks: int = 1

    @classmethod
    def from_env(cls, env: Optional[Dict[str, str]] = None) -> "ProcessContext":
        e = dict(os.environ) if env is None else env
        return cls(
            job_name=e.get("TFK8S_JOB_NAME", "local"),
            namespace=e.get("TFK8S_NAMESPACE", "default"),
            replica_type=e.get("TFK8S_REPLICA_TYPE", "Worker"),
            replica_index=int(e.get("TFK8S_REPLICA_INDEX", "0")),
            process_id=int(e.get("TFK8S_PROCESS_ID", "0")),
            num_processes=int(e.get("TFK8S_NUM_PROCESSES", "1")),
            coordinator_address=e.get("TFK8S_COORDINATOR_ADDRESS", ""),
            accelerator=e.get("TFK8S_ACCELERATOR", ""),
            num_slices=int(e.get("TFK8S_NUM_SLICES", "1")),
            slice_id=e.get("TFK8S_SLICE_ID", ""),
            host_index=int(e.get("TFK8S_HOST_INDEX", "0")),
            gang_restarts=int(e.get("TFK8S_GANG_RESTARTS", "0")),
            world_version=int(e.get("TFK8S_WORLD_VERSION", "0")),
            checkpoint_dir=e.get("TFK8S_CHECKPOINT_DIR", ""),
            mesh=MeshConfig.from_env(e) if e.get("TFK8S_MESH") else None,
            local_rank=int(e.get(LOCAL_RANK_ENV) or e.get("TFK8S_PROCESS_ID", "0")),
            local_ranks=int(e.get(POD_RANKS_ENV, "1")),
        )

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0

    @property
    def resuming(self) -> bool:
        """True on a gang restart OR after an elastic resize — either way
        the process must restore from the last committed checkpoint."""
        return self.gang_restarts > 0 or self.world_version > 0

    def pod_ranks(self) -> int:
        """The rank processes this pod runs: one per device of its share
        of the mesh, ``mesh.size() // num_processes`` (1 with no mesh: one
        rank a process, where the reference's process would take every
        local device; 1 where the mesh is no larger than the processes,
        which count an Evaluator's too). Raises ``ValueError`` when the
        processes do not divide a larger mesh, and for an axis the port
        does not know."""
        if self.mesh is None:
            return 1
        self.mesh.require_ported()
        n = self.mesh.size()
        if n <= self.num_processes:
            return 1
        if n % self.num_processes:
            raise ValueError(
                f"mesh {dict(self.mesh.axes)} needs {n} devices, which "
                f"{self.num_processes} processes do not divide into a pod's ranks"
            )
        return n // self.num_processes


def initialize_distributed(
    ctx: ProcessContext,
    env: Optional[Dict[str, str]] = None,
    backend: Optional[str] = None,
    device: Union[str, torch.device, None] = None,
) -> bool:
    """Join the job's process group; returns whether one is up. A no-op
    unless ``num_processes > 1`` and ``TFK8S_DISTRIBUTED=1`` (replicas
    run as threads of one process must not bind ports), and when a group
    already exists. The backend is ``backend`` if given, else
    :func:`backend_for` the device (``device``, else ``select_device``)."""
    e = dict(os.environ) if env is None else env
    if ctx.num_processes <= 1 or e.get("TFK8S_DISTRIBUTED") != "1":
        return False
    if dist.is_initialized():
        return True
    if backend is None:
        dev = torch.device(device) if device is not None else select_device(e)
        backend = backend_for(dev, ctx.local_ranks)
    log.info(
        "init_process_group(%s, coordinator=%s, world_size=%d, rank=%d)",
        backend, ctx.coordinator_address, ctx.num_processes, ctx.process_id,
    )
    dist.init_process_group(
        backend=backend,
        init_method=f"tcp://{ctx.coordinator_address}",
        rank=ctx.process_id,
        world_size=ctx.num_processes,
    )
    return True


def backend_for(device: Union[str, torch.device], local_ranks: int = 1) -> str:
    """NCCL where each of the host's ``local_ranks`` ranks has a card of
    its own; gloo where they share one (NCCL will not put two ranks on one
    card) and on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and local_ranks <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(ctx: ProcessContext, device: torch.device) -> torch.device:
    """The card a rank takes on its host: ``local_rank % cards`` (a pod's
    ranks take its own cards, whatever its process id); ``device``
    unchanged on the CPU."""
    if device.type != "cuda":
        return device
    return torch.device("cuda", ctx.local_rank % torch.cuda.device_count())


def requested_device(env: Optional[Dict[str, str]] = None,
                     device: Union[str, torch.device, None] = None) -> torch.device:
    """The device a run asks for: ``device`` if given, else
    ``TFK8S_DEVICE`` from ``env``, else the card (no index chosen, and no
    CUDA context made). Raises when no card is there and the caller did
    not ask for the CPU."""
    e = dict(os.environ) if env is None else env
    choice = device if device is not None else e.get(DEVICE_ENV) or "cuda"
    dev = torch.device(choice)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card; set "
                f"{DEVICE_ENV}=cpu (or pass device='cpu') to run on the CPU"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev


def select_device(
    env: Optional[Dict[str, str]] = None,
    device: Union[str, torch.device, None] = None,
) -> torch.device:
    """The device a run uses: :func:`requested_device`, the first card
    where it names no index."""
    dev = requested_device(env, device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
