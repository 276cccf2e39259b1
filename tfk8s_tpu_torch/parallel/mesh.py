"""The job's logical mesh, ported from the JAX package's
``parallel/mesh.py``: ``MeshConfig`` keeps the reference's canonically
ordered axes (pipeline, data, fsdp, expert, sequence, tensor) read from
``TFK8S_MESH``, and ``build_device_mesh`` turns the ``data`` and ``fsdp``
axes into a ``torch.distributed`` ``DeviceMesh``.

The port runs one process per device, so the devices a job has are the
ranks of its process group. The tensor, sequence, expert and pipeline
axes are ROADMAP item 1.9 and raise ``NotImplementedError`` above size 1.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

AXIS_DATA = "data"
AXIS_FSDP = "fsdp"
AXIS_EXPERT = "expert"
AXIS_PIPELINE = "pipeline"
AXIS_SEQUENCE = "sequence"
AXIS_TENSOR = "tensor"

# Slowest-varying -> fastest-varying over the device list.
CANONICAL_ORDER: Tuple[str, ...] = (
    AXIS_PIPELINE,
    AXIS_DATA,
    AXIS_FSDP,
    AXIS_EXPERT,
    AXIS_SEQUENCE,
    AXIS_TENSOR,
)
PORTED_AXES = (AXIS_DATA, AXIS_FSDP)


def world_size() -> int:
    """Ranks in the default process group (1 when there is none)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Validated, canonically-ordered logical mesh axes."""

    axes: Tuple[Tuple[str, int], ...]

    @classmethod
    def create(cls, **sizes: int) -> "MeshConfig":
        """``MeshConfig.create(data=4, fsdp=2)``: axes of size 1 are
        dropped; unknown axis names follow the canonical ones, in call
        order."""
        ordered: List[Tuple[str, int]] = []
        for name in CANONICAL_ORDER:
            if name in sizes and sizes[name] > 1:
                ordered.append((name, sizes[name]))
        for name, size in sizes.items():
            if name not in CANONICAL_ORDER and size > 1:
                ordered.append((name, size))
        if not ordered:
            ordered = [(AXIS_DATA, 1)]
        return cls(tuple(ordered))

    @classmethod
    def from_dict(cls, axes: Dict[str, int]) -> "MeshConfig":
        return cls.create(**axes)

    @classmethod
    def from_env(cls, env: Optional[Dict[str, str]] = None) -> "MeshConfig":
        """From ``TFK8S_MESH``; without it, pure data parallelism over the
        job's ranks."""
        env = os.environ if env is None else env
        raw = env.get("TFK8S_MESH", "")
        if raw:
            return cls.from_dict(json.loads(raw))
        return cls.create(data=world_size())

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.axes)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(s for _, s in self.axes)

    def size(self) -> int:
        return math.prod(self.shape)

    def axis_size(self, name: str) -> int:
        for n, s in self.axes:
            if n == name:
                return s
        return 1

    def require_ported(self) -> None:
        """Raise for an axis the port does not shard over yet."""
        other = {n: s for n, s in self.axes if n not in PORTED_AXES}
        if other:
            raise NotImplementedError(
                f"mesh axes {other}: tensor, sequence, expert and pipeline "
                "parallelism are ROADMAP item 1.9"
            )

    def check_devices(self, available: int) -> None:
        """The reference's device-count check, with its text."""
        n = self.size()
        if n > available:
            raise ValueError(
                f"mesh {dict(self.axes)} needs {n} devices; {available} available"
            )


def build_device_mesh(cfg: MeshConfig, device: torch.device):
    """The ``("data", "fsdp")`` ``DeviceMesh`` over the process group, one
    rank per device; None for a one-process job."""
    cfg.require_ported()
    world = world_size()
    cfg.check_devices(world)
    if cfg.size() != world:
        raise ValueError(
            f"mesh {dict(cfg.axes)} spans {cfg.size()} devices; the process "
            f"group has {world} ranks, one device each"
        )
    if world == 1:
        return None
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(
        torch.device(device).type,
        (cfg.axis_size(AXIS_DATA), cfg.axis_size(AXIS_FSDP)),
        mesh_dim_names=(AXIS_DATA, AXIS_FSDP),
    )
