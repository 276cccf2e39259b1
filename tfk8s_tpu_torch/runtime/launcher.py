"""Worker-side launcher: the data plane's entry contract, for one process
on one device.

Decodes the same ``TFK8S_*`` pod env the JAX package's launcher reads and
picks the torch device. The port runs on the card unless the caller asks
for the CPU (``TFK8S_DEVICE=cpu``, or a ``device=`` argument); with no card
and no such request it raises rather than quietly running on the CPU.
Multi-process and multi-device jobs are ROADMAP item 1.5 and raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Dict, Optional, Union

import torch

DEVICE_ENV = "TFK8S_DEVICE"


@dataclasses.dataclass
class ProcessContext:
    """What a training process on one device reads from its pod env (the
    reference's ``TFK8S_*`` contract; the fields the port acts on)."""

    num_processes: int = 1
    num_slices: int = 1
    gang_restarts: int = 0
    # bumped by the controller on every gang resize; nonzero means this
    # incarnation must resume from checkpoint
    world_version: int = 0
    checkpoint_dir: str = ""
    # TFK8S_MESH axes (name -> size), as the controller rendered them
    mesh_axes: Dict[str, int] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_env(cls, env: Optional[Dict[str, str]] = None) -> "ProcessContext":
        e = dict(os.environ) if env is None else env
        return cls(
            num_processes=int(e.get("TFK8S_NUM_PROCESSES", "1")),
            num_slices=int(e.get("TFK8S_NUM_SLICES", "1")),
            gang_restarts=int(e.get("TFK8S_GANG_RESTARTS", "0")),
            world_version=int(e.get("TFK8S_WORLD_VERSION", "0")),
            checkpoint_dir=e.get("TFK8S_CHECKPOINT_DIR", ""),
            mesh_axes={
                str(k): int(v)
                for k, v in dict(json.loads(e.get("TFK8S_MESH") or "{}")).items()
            },
        )

    @property
    def resuming(self) -> bool:
        """True on a gang restart OR after an elastic resize — either way
        the process must restore from the last committed checkpoint."""
        return self.gang_restarts > 0 or self.world_version > 0

    def require_single_device(self) -> None:
        """Raise for the layouts this slice of the port does not run."""
        if self.num_processes > 1 or self.num_slices > 1:
            raise NotImplementedError(
                f"{self.num_processes} processes / {self.num_slices} slices: "
                "multi-process training is ROADMAP item 1.5"
            )
        devices = math.prod(self.mesh_axes.values()) if self.mesh_axes else 1
        if devices > 1:
            raise NotImplementedError(
                f"TFK8S_MESH {self.mesh_axes} spans {devices} devices: "
                "multi-device meshes are ROADMAP item 1.5"
            )


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
