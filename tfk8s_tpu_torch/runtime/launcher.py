"""Worker-side launcher: the data plane's entry contract.

Decodes the same ``TFK8S_*`` pod env the JAX package's launcher reads,
joins the job's process group and picks the torch device. The port runs
one process per device, on the card unless the caller asks for the CPU
(``TFK8S_DEVICE=cpu``, or a ``device=`` argument); with no card and no
such request it raises rather than quietly running on the CPU.

``initialize_distributed`` is gated as the reference's is: only with more
than one process AND ``TFK8S_DISTRIBUTED=1`` does it call
``torch.distributed.init_process_group`` (NCCL on a card, gloo on the
CPU), so replicas run as threads of one process never bind ports.
More than one device per process (ROADMAP item 1.5) and a mesh axis
outside the reference's six (``MeshConfig.require_ported``) raise
``NotImplementedError``; every axis runs, in every combination
(``parallel/mesh.build_mesh``),
and a multislice job's ``num_slices`` and ``slice_id`` go to
``build_mesh``, which holds the layout to the reference's slice rule and
places the ranks slice-major.
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
        )

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0

    @property
    def resuming(self) -> bool:
        """True on a gang restart OR after an elastic resize — either way
        the process must restore from the last committed checkpoint."""
        return self.gang_restarts > 0 or self.world_version > 0

    def require_single_device(self, processes: int = 1) -> None:
        """Raise for the layouts the port does not run yet: more than one
        device per process (a mesh larger than the ``processes`` that share
        it) and a mesh axis the port does not know."""
        if self.mesh is None:
            return
        self.mesh.require_ported()
        if self.mesh.size() > processes:
            raise NotImplementedError(
                f"TFK8S_MESH {dict(self.mesh.axes)} spans {self.mesh.size()} devices "
                f"over {processes} process(es): more than one device per process is "
                "ROADMAP item 1.5"
            )


def initialize_distributed(
    ctx: ProcessContext,
    env: Optional[Dict[str, str]] = None,
    backend: Optional[str] = None,
    device: Union[str, torch.device, None] = None,
) -> bool:
    """Join the job's process group; returns whether one is up. A no-op
    unless ``num_processes > 1`` and ``TFK8S_DISTRIBUTED=1`` (replicas
    run as threads of one process must not bind ports), and when a group
    already exists. The backend is ``backend`` if given, else NCCL for a
    card and gloo for the CPU (``device``, else ``select_device``)."""
    e = dict(os.environ) if env is None else env
    if ctx.num_processes <= 1 or e.get("TFK8S_DISTRIBUTED") != "1":
        return False
    if dist.is_initialized():
        return True
    if backend is None:
        dev = torch.device(device) if device is not None else select_device(e)
        backend = "nccl" if dev.type == "cuda" else "gloo"
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


def select_device(
    env: Optional[Dict[str, str]] = None,
    device: Union[str, torch.device, None] = None,
) -> torch.device:
    """The device a run uses: ``device`` if given, else ``TFK8S_DEVICE``
    from ``env``, else the first card. Raises when no card is there and
    the caller did not ask for the CPU."""
    e = dict(os.environ) if env is None else env
    choice = device if device is not None else e.get(DEVICE_ENV) or "cuda"
    dev = torch.device(choice)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card; set "
                f"{DEVICE_ENV}=cpu (or pass device='cpu') to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev
