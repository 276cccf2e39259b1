"""The job's logical mesh, ported from the JAX package's
``parallel/mesh.py``: ``MeshConfig`` keeps the reference's canonically
ordered axes (pipeline, data, fsdp, expert, sequence, tensor) read from
``TFK8S_MESH``, and ``build_mesh`` turns them into a :class:`Mesh`: this
rank's coordinates on every axis and one ``torch.distributed`` process
group per axis (and per set of axes a gradient is reduced over), the
counterpart of the reference's ``jax.sharding.Mesh``.

The port runs one process per device, so the devices a job has are the
ranks of its process group, laid out in the reference's canonical order
(later axes vary fastest over the ranks). Every axis is ported, in
every combination the reference accepts; an axis outside
``CANONICAL_ORDER`` raises ``NotImplementedError``. A pipeline group
holds the ranks that share every other coordinate (``rank_at`` gives a
stage's peers), so beside fsdp, expert, sequence or tensor each of a
stage's groups over those axes lies within the stage.

Multislice (``TFK8S_NUM_SLICES`` > 1): ``MeshConfig.slice_axis_split``
keeps the reference's rule that only pipeline, data and fsdp may cross a
slice boundary, and ``build_mesh`` places the ranks slice-major, as the
reference's ``slice_major_devices`` orders devices: every rank's
``TFK8S_SLICE_ID`` is gathered, the slices are taken in the order of
their ids and the ranks of a slice in rank order, so the C-order
reshape puts the slice boundaries on the slowest axes. Without slice ids
the contiguous blocks of ranks are the slices (the reference's emulation
on a pool without ``slice_index``).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

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
# the axes a batch is split over (the reference's ``batch`` logical axis)
BATCH_AXES = (AXIS_DATA, AXIS_FSDP)


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
        """Raise for an axis the port does not shard over: one outside
        ``CANONICAL_ORDER``."""
        other = {n: s for n, s in self.axes if n not in CANONICAL_ORDER}
        if other:
            raise NotImplementedError(
                f"mesh axes {other}: axes outside {list(CANONICAL_ORDER)} are not ported"
            )

    def slice_axis_split(self, num_slices: int) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
        """The reference's ``(dcn_axes, ici_axes)`` of a ``num_slices``-slice
        job: with slice-major placement and the C-order reshape, an axis's
        hops stay within one slice iff its span (the product of the faster
        axes times its own size) divides the devices of a slice. Every
        other axis crosses a slice boundary, and only pipeline, data and
        fsdp may (data may straddle: partly within a slice, partly
        across); tensor, sequence or expert across slices raises the
        reference's ``ValueError``."""
        n = self.size()
        if num_slices <= 1:
            return (), self.names
        if n % num_slices:
            raise ValueError(
                f"mesh {dict(self.axes)} has {n} devices, not divisible "
                f"into {num_slices} slices"
            )
        per_slice = n // num_slices
        dcn: List[str] = []
        ici: List[str] = []
        stride = 1  # product of faster (later) axes
        for name, size in reversed(self.axes):
            span = stride * size
            if size == 1 or per_slice % span == 0:
                ici.append(name)
            else:
                dcn.append(name)
                if name not in (AXIS_PIPELINE, AXIS_DATA, AXIS_FSDP):
                    raise ValueError(
                        f"mesh {dict(self.axes)}: axis {name!r} (size "
                        f"{size}) would span slices (DCN) with "
                        f"{per_slice} devices/slice; only {AXIS_PIPELINE}"
                        f"/{AXIS_DATA}/{AXIS_FSDP} tolerate DCN latency "
                        "— put tensor/sequence/expert parallelism inside "
                        "a slice"
                    )
            stride = span
        return tuple(reversed(dcn)), tuple(reversed(ici))

    def coords(self, r: int) -> Dict[str, int]:
        """Rank ``r``'s index on every axis: the reference's C-order
        reshape of the device list, later axes fastest."""
        out: Dict[str, int] = {}
        for name, size in reversed(self.axes):
            out[name] = r % size
            r //= size
        return {n: out[n] for n in self.names}

    def position(self, coords: Dict[str, int]) -> int:
        """The place in the device order of the coordinates ``coords``
        (the inverse of :meth:`coords`; an axis left out is at 0)."""
        p = 0
        for name, size in self.axes:
            p = p * size + coords.get(name, 0)
        return p

    def ranks_along(self, axes: Sequence[str]) -> List[List[int]]:
        """The blocks of places in the device order that vary over
        ``axes`` only (the other axes fixed), in order of their first
        place: one process group each."""
        blocks: Dict[Tuple[int, ...], List[int]] = {}
        for r in range(self.size()):
            c = self.coords(r)
            key = tuple(c[n] for n in self.names if n not in axes)
            blocks.setdefault(key, []).append(r)
        return list(blocks.values())

    def check_devices(self, available: int) -> None:
        """The reference's device-count check, with its text."""
        n = self.size()
        if n > available:
            raise ValueError(
                f"mesh {dict(self.axes)} needs {n} devices; {available} available"
            )


def group_axes(cfg: MeshConfig) -> List[Tuple[str, ...]]:
    """Every set of the mesh's axes, in the mesh's order, fewest axes
    first: a process group is made for each (each model axis on its own
    for its sums, gathers and sends; the batch axes for the global-batch
    means; the batch and sequence axes together for the gradients and the
    masked token means; any other set a layer reduces over)."""
    names = cfg.names
    return [tuple(names[i] for i in range(len(names)) if m >> i & 1)
            for m in sorted(range(1, 1 << len(names)), key=lambda m: (bin(m).count("1"), m))]


def slice_major_ranks(slice_ids: Sequence[str], num_slices: int) -> List[int]:
    """The ranks in device order for a ``num_slices``-slice job whose rank
    ``r`` sits in slice ``slice_ids[r]``: all of the first slice, then the
    next, the slices in the order of their ids (numeric ids as numbers,
    as the reference sorts ``slice_index``) and the ranks of a slice in
    rank order (the reference's ``slice_major_devices``, which orders a
    slice's devices by id). With no slice ids at all, the
    contiguous blocks of ranks are the slices (the reference's emulation),
    so the order is the ranks'."""
    n = len(slice_ids)
    if num_slices <= 1:
        return list(range(n))
    if n % num_slices:
        raise ValueError(f"{n} devices not divisible into {num_slices} slices")
    per = n // num_slices
    given = [bool(s) for s in slice_ids]
    if not any(given):
        return list(range(n))
    if not all(given):
        raise ValueError(
            "device pool mixes slice-indexed and unindexed devices; "
            "cannot infer a slice layout"
        )
    by_slice: Dict[str, List[int]] = {}
    for r, s in enumerate(slice_ids):
        by_slice.setdefault(s, []).append(r)
    if len(by_slice) != num_slices:
        raise ValueError(
            f"device pool spans {len(by_slice)} physical slices; job "
            f"wants {num_slices}"
        )
    order: List[int] = []
    for s in sorted(by_slice, key=lambda s: (not s.isdigit(), int(s) if s.isdigit() else 0, s)):
        ranks = by_slice[s]
        if len(ranks) != per:
            raise ValueError(
                f"slice {s} has {len(ranks)} devices; need {per} per slice"
            )
        order.extend(ranks)
    return order


@dataclasses.dataclass(eq=False)
class Mesh:
    """The job's mesh as one rank sees it: the config, this rank's device
    and coordinates, and a process group for every set of its axes
    (:func:`group_axes`). ``device_mesh`` is the ``("data", "fsdp")``
    ``DeviceMesh`` FSDP2 shards over (None unless the mesh has only those
    axes and more than one rank). ``order`` is the ranks in device order
    (empty: the ranks' own order)."""

    cfg: MeshConfig
    device: torch.device
    rank: int = 0
    coords: Dict[str, int] = dataclasses.field(default_factory=dict)
    groups: Dict[Tuple[str, ...], object] = dataclasses.field(default_factory=dict)
    device_mesh: object = None
    order: List[int] = dataclasses.field(default_factory=list)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return self.cfg.names

    def size(self, *axes: str) -> int:
        return math.prod(self.cfg.axis_size(a) for a in axes)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, *axes: str):
        """The process group over ``axes`` (this rank's block; an axis the
        mesh lacks, or of size 1, is left out); None when they hold one
        rank."""
        if self.size(*axes) == 1:
            return None
        return self.groups[tuple(n for n in self.cfg.names
                                 if n in axes and self.cfg.axis_size(n) > 1)]

    def rank_at(self, axis: str, index: int) -> int:
        """The global rank at this rank's coordinates but ``index`` on
        ``axis`` (a point-to-point peer)."""
        p = self.cfg.position({**self.coords, axis: index})
        return self.order[p] if self.order else p

    @property
    def batch_index(self) -> int:
        """This rank's block of the global batch (data-major, then fsdp)."""
        return self.index(AXIS_DATA) * self.size(AXIS_FSDP) + self.index(AXIS_FSDP)

    def batch_index_of(self, rank: int) -> int:
        """Rank ``rank``'s block of the global batch."""
        c = self.cfg.coords(self.order.index(rank) if self.order else rank)
        return c.get(AXIS_DATA, 0) * self.size(AXIS_FSDP) + c.get(AXIS_FSDP, 0)

    @property
    def batch_size(self) -> int:
        """The number of blocks the batch is split into."""
        return self.size(*BATCH_AXES)


def build_mesh(cfg: Optional[MeshConfig], device: torch.device, num_slices: int = 1,
               slice_id: str = "") -> Mesh:
    """This rank's :class:`Mesh` over the process group, one rank per
    device (the data axis over every rank when ``cfg`` is None). Every rank
    must call it: the process groups are made collectively. With
    ``num_slices`` > 1 the layout is held to
    :meth:`MeshConfig.slice_axis_split` and the ranks are placed
    slice-major by every rank's ``slice_id`` (:func:`slice_major_ranks`)."""
    cfg = cfg or MeshConfig.create(data=world_size())
    cfg.require_ported()
    world = world_size()
    cfg.check_devices(world)
    if cfg.size() != world:
        raise ValueError(
            f"mesh {dict(cfg.axes)} spans {cfg.size()} devices; the process "
            f"group has {world} ranks, one device each"
        )
    me = rank()
    order: List[int] = []
    if num_slices > 1:
        cfg.slice_axis_split(num_slices)  # the reference's layout check
        ids: List[Optional[str]] = [None] * world
        dist.all_gather_object(ids, slice_id)
        order = slice_major_ranks(ids, num_slices)
        if order == list(range(world)):
            order = []
    position = order.index(me) if order else me
    mesh = Mesh(cfg, torch.device(device), me, cfg.coords(position), order=order)
    if world == 1:
        return mesh
    # every rank makes every group, in the same order (new_group is
    # collective over the world)
    for axes in group_axes(cfg):
        for block in cfg.ranks_along(axes):
            ranks = sorted(order[p] for p in block) if order else block
            g = dist.new_group(ranks)
            if me in ranks:
                mesh.groups[axes] = g
    if dist.get_backend() == "nccl":
        # a communicator joins its ranks at its first call; NCCL's batched
        # point-to-point sends (the pipeline stages' first sends pair two
        # ranks) want it joined already
        for axes in group_axes(cfg):
            dist.all_reduce(torch.zeros(1, device=device), group=mesh.groups[axes])
    if set(cfg.names) <= set(BATCH_AXES):
        from torch.distributed.device_mesh import DeviceMesh

        mesh.device_mesh = DeviceMesh(
            torch.device(device).type,
            torch.tensor(order or range(world)).reshape(
                cfg.axis_size(AXIS_DATA), cfg.axis_size(AXIS_FSDP)),
            mesh_dim_names=(AXIS_DATA, AXIS_FSDP),
        )
    return mesh

