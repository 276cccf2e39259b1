"""Gang scheduling: all-or-nothing admission of a job's replicas onto
whole hosts of the inventory.

A copy of the JAX package's ``trainer/gang.py``. k8s Jobs admit pods
independently (k8s-operator.md:44-49), and a partially scheduled gang just
wedges, so a job's pods are admitted together or not at all. The
inventory is a set of physical slices (here ``h100-N``: N/8 hosts of 8
cards, ``utils/topology.py``) whose host grids are carved into
axis-aligned BOXES of hosts by guillotine splitting; a job asking for a
smaller shape of the same generation (``h100-8`` out of an ``h100-16``)
gets whole hosts of it, and releases return the boxes to the free list.
Placement is host-granular: a pod's ranks take cards 0..d-1 of its host.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Tuple

from tfk8s_tpu_torch.api.types import TPUJob
from tfk8s_tpu_torch.utils import topology as topo
from tfk8s_tpu_torch.utils.logging import get_logger

log = get_logger("gang")


@dataclasses.dataclass(frozen=True)
class Box:
    """Axis-aligned region of a physical slice's host grid."""

    origin: Tuple[int, ...]
    shape: Tuple[int, ...]

    @property
    def hosts(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def fits(self, shape: Tuple[int, ...]) -> bool:
        return all(b >= r for b, r in zip(self.shape, shape))


@dataclasses.dataclass(frozen=True)
class PhysicalSlice:
    """One slice in the cluster inventory."""

    slice_id: str
    info: topo.SliceInfo


@dataclasses.dataclass(frozen=True)
class SliceHandle:
    """A job's allocated region: a contiguous box of hosts within one
    physical slice (possibly the whole slice)."""

    slice_id: str  # physical slice id
    accelerator: str  # the REQUESTED accelerator type
    info: topo.SliceInfo  # the requested slice shape
    physical: Optional[PhysicalSlice] = None
    box: Optional[Box] = None

    def global_host_index(self, local_host: int) -> int:
        """Job-local host index -> physical host index in the slice
        (placement for node selectors). Identity when the handle is not
        a carved sub-slice (cpu/hermetic)."""
        if self.physical is None or self.box is None:
            return local_host
        # local coords within the box, C-order over the box shape
        coords = []
        rem = local_host
        for dim in reversed(self.box.shape):
            coords.append(rem % dim)
            rem //= dim
        coords = tuple(reversed(coords))
        phys_coords = tuple(o + c for o, c in zip(self.box.origin, coords))
        return topo.host_index_of(self.physical.info, phys_coords)


@dataclasses.dataclass
class GangAssignment:
    """Result of admission: which slices a job got, and the host layout.
    ``host_of(process_id)`` maps a job process to (slice_id, job-local
    host index); ``global_host_of`` gives the physical host index for
    placement."""

    job_uid: str
    slices: List[SliceHandle]
    hosts_per_slice: int

    def handle_of(self, process_id: int) -> "SliceHandle":
        """The ONE pid -> slice-handle mapping; every consumer (env
        rendering, node selectors) goes through here."""
        return self.slices[process_id // self.hosts_per_slice]

    def host_of(self, process_id: int) -> tuple:
        s, h = divmod(process_id, self.hosts_per_slice)
        return self.slices[s].slice_id, h

    def global_host_of(self, process_id: int) -> int:
        return self.handle_of(process_id).global_host_index(
            process_id % self.hosts_per_slice
        )

    @property
    def total_hosts(self) -> int:
        return len(self.slices) * self.hosts_per_slice


def _guillotine_split(free: Box, want: Tuple[int, ...]) -> Tuple[Box, List[Box]]:
    """Carve a ``want``-shaped box from ``free``'s origin corner;
    remainder returned as new free boxes (one per dim that was cut)."""
    assert free.fits(want)
    remainders = []
    cur = free
    for d in range(len(want)):
        if cur.shape[d] > want[d]:
            # cut along d: keep [0, want_d), free the rest
            rem_origin = tuple(
                o + (want[d] if i == d else 0) for i, o in enumerate(cur.origin)
            )
            rem_shape = tuple(
                (cur.shape[i] - want[d]) if i == d else (
                    want[i] if i < d else cur.shape[i]
                )
                for i in range(len(want))
            )
            remainders.append(Box(rem_origin, rem_shape))
    carved = Box(cur.origin, tuple(want))
    return carved, remainders


class SliceAllocator:
    """Inventory of physical slices with atomic, topology-aware gang
    admission.

    ``capacity`` maps accelerator type -> number of identical slices the
    cluster owns (e.g. ``{"v5p-32": 4}``). Jobs may request the same
    type or a *smaller* slice shape of the same generation; either way
    the allocation is a contiguous box of host blocks. ``cpu-*``
    accelerators are treated as unlimited local capacity (the hermetic
    backend)."""

    def __init__(self, capacity: Optional[Dict[str, int]] = None):
        self._lock = threading.Lock()
        # physical slice id -> (PhysicalSlice, free boxes)
        self._slices: Dict[str, Tuple[PhysicalSlice, List[Box]]] = {}
        self._assigned: Dict[str, GangAssignment] = {}
        self._cpu_counter = 0
        # bumped on every inventory transition (placement / release) so
        # observers (capacity gauges) can skip recomputing when idle
        self.version = 0
        for acc, n in (capacity or {}).items():
            info = topo.parse_accelerator(acc)
            grid = topo.host_grid_shape(info)
            for i in range(n):
                ps = PhysicalSlice(f"{info.accelerator}/slice-{i}", info)
                self._slices[ps.slice_id] = (
                    ps,
                    [Box((0,) * len(grid), grid)],
                )

    # -- admission ----------------------------------------------------------

    def _find_box(self, want_info: topo.SliceInfo) -> Optional[SliceHandle]:
        """Carve one contiguous box shaped like ``want_info``'s host grid
        from any compatible physical slice. Caller holds the lock."""
        want_grid = topo.host_grid_shape(want_info)
        for ps, free in self._slices.values():
            if ps.info.generation != want_info.generation:
                continue
            if len(topo.host_grid_shape(ps.info)) != len(want_grid):
                continue
            # best fit: smallest free box that fits (least fragmentation)
            candidates = [b for b in free if b.fits(want_grid)]
            if not candidates:
                continue
            best = min(candidates, key=lambda b: b.hosts)
            free.remove(best)
            carved, remainders = _guillotine_split(best, want_grid)
            free.extend(remainders)
            return SliceHandle(
                slice_id=f"{ps.slice_id}@{'x'.join(map(str, carved.origin))}",
                accelerator=want_info.accelerator,
                info=want_info,
                physical=ps,
                box=carved,
            )
        return None

    @staticmethod
    def _cpu_hosts_per_slice(job: TPUJob, want: int) -> int:
        from tfk8s_tpu_torch.api import helpers as _h

        return -(-max(_h.total_replicas(job), 1) // want)  # ceil div

    def _assignment_fits(
        self, ga: GangAssignment, job: TPUJob, info: topo.SliceInfo, want: int
    ) -> bool:
        """Does a held assignment still satisfy the job's CURRENT spec?
        False after a scale / accelerator / num_slices edit — the gang
        must be released and re-admitted (slices are whole-gang units;
        there is no partial grow/shrink on TPU hardware)."""
        if len(ga.slices) != want or ga.slices[0].info != info:
            return False
        if info.generation == "cpu":
            return ga.hosts_per_slice == self._cpu_hosts_per_slice(job, want)
        return ga.hosts_per_slice == info.hosts

    def admit(self, job: TPUJob) -> Optional[GangAssignment]:
        """All-or-nothing: returns an assignment of ``num_slices``
        contiguous sub-slices, or None if capacity is short. Idempotent
        per job uid while the spec's demand is unchanged. A demand edit
        (scale, accelerator, num_slices) re-admits atomically: the held
        boxes are offered back to the pool for the new carve, but if the
        new demand cannot be satisfied the old assignment is RESTORED
        intact — the running gang keeps its hosts (no double-booking
        window) and the caller sees None (gang pending)."""
        uid = job.metadata.uid
        with self._lock:
            info = topo.parse_accelerator(job.spec.tpu.accelerator, job.spec.tpu.topology)
            want = max(job.spec.tpu.num_slices, 1)
            held = self._assigned.get(uid)
            if held is not None and self._assignment_fits(held, job, info, want):
                return held
            if held is None:
                ga = self._admit_locked(job, info, want, uid)
                if ga is not None:
                    self._assigned[uid] = ga
                    self.version += 1
                    log.info(
                        "admitted job uid=%s onto %s",
                        uid, [h.slice_id for h in ga.slices],
                    )
                return ga
            # Demand changed. Snapshot the free lists so a failed re-carve
            # restores the world exactly (the held boxes may be needed by,
            # or adjacent to, the new shape — release first, then carve).
            snapshot = self._snapshot_free()
            for h in held.slices:
                self._release_handle(h)
            ga = self._admit_locked(job, info, want, uid)
            if ga is None:
                self._restore_free(snapshot)
                log.debug(
                    "job uid=%s demand change unsatisfiable; keeping old gang",
                    uid,
                )
                return None
            self._assigned[uid] = ga
            self.version += 1
            log.info(
                "job uid=%s demand changed; re-admitted onto %s",
                uid, [h.slice_id for h in ga.slices],
            )
            return ga

    def _admit_locked(
        self, job: TPUJob, info: topo.SliceInfo, want: int, uid: str
    ) -> Optional[GangAssignment]:
        """Carve ``want`` slices for the job, or None (partial carves
        rolled back). Caller holds the lock and owns ``_assigned``."""
        if info.generation == "cpu":
            # Local/hermetic backend: slices are virtual and unlimited,
            # and every replica is a "host" of its virtual slice (cpu
            # jobs aren't bound by physical host counts — validation
            # exempts them too).
            hosts_per_slice = self._cpu_hosts_per_slice(job, want)
            handles = []
            for _ in range(want):
                handles.append(
                    SliceHandle(f"cpu/slice-{self._cpu_counter}", info.accelerator, info)
                )
                self._cpu_counter += 1
            return GangAssignment(uid, handles, hosts_per_slice=hosts_per_slice)

        handles: List[SliceHandle] = []
        for _ in range(want):
            h = self._find_box(info)
            if h is None:
                # all-or-nothing: roll back partial carves
                for got in handles:
                    self._release_handle(got)
                return None
            handles.append(h)
        return GangAssignment(uid, handles, hosts_per_slice=info.hosts)

    def _snapshot_free(self) -> Dict[str, List[Box]]:
        """Copy of every slice's free list (caller holds the lock) — the
        one rollback mechanism shared by admit / admit_with_preemption /
        preemption_plan."""
        return {sid: list(free) for sid, (_ps, free) in self._slices.items()}

    def _restore_free(self, snapshot: Dict[str, List[Box]]) -> None:
        for sid, boxes in snapshot.items():
            ps, _stale = self._slices[sid]
            self._slices[sid] = (ps, boxes)

    def _release_handle(self, h: SliceHandle) -> None:
        if h.physical is None or h.box is None:
            return
        _, free = self._slices[h.physical.slice_id]
        free.append(h.box)
        self._coalesce(free)

    def _coalesce(self, free: List[Box]) -> None:
        """Merge axis-adjacent same-shape boxes so released sub-slices
        recombine into larger allocatable regions."""
        merged = True
        while merged:
            merged = False
            for i in range(len(free)):
                for j in range(i + 1, len(free)):
                    m = _try_merge(free[i], free[j])
                    if m is not None:
                        free[i] = m
                        free.pop(j)
                        merged = True
                        break
                if merged:
                    break

    def assignment(self, job_uid: str) -> Optional[GangAssignment]:
        with self._lock:
            return self._assigned.get(job_uid)

    def admit_with_preemption(
        self, job: TPUJob, victim_uids: List[str]
    ) -> Optional[GangAssignment]:
        """Atomically release ``victim_uids``' gangs and admit ``job``
        into the freed capacity — under ONE lock, so no other job (least
        of all a victim's own concurrent sync re-admitting itself) can
        slip into the window between release and carve. On failure the
        victims' assignments and the free lists are restored intact."""
        uid = job.metadata.uid
        with self._lock:
            info = topo.parse_accelerator(job.spec.tpu.accelerator, job.spec.tpu.topology)
            want = max(job.spec.tpu.num_slices, 1)
            snapshot_free = self._snapshot_free()
            snapshot_assigned = {
                v: self._assigned.get(v) for v in victim_uids
            }
            for v in victim_uids:
                ga_v = self._assigned.pop(v, None)
                if ga_v is not None:
                    for h in ga_v.slices:
                        self._release_handle(h)
            held = self._assigned.pop(uid, None)  # demand-changed re-carve
            if held is not None:
                for h in held.slices:
                    self._release_handle(h)
            ga = self._admit_locked(job, info, want, uid)
            if ga is None:
                self._restore_free(snapshot_free)
                for v, a in snapshot_assigned.items():
                    if a is not None:
                        self._assigned[v] = a
                if held is not None:
                    self._assigned[uid] = held
                return None
            self._assigned[uid] = ga
            self.version += 1
            log.info(
                "admitted job uid=%s onto %s, preempting %s",
                uid, [h.slice_id for h in ga.slices], victim_uids,
            )
            return ga

    def preemption_plan(
        self, job: TPUJob, candidate_uids: List[str]
    ) -> Optional[List[str]]:
        """Dry-run (k8s-preemption style): the SHORTEST prefix of
        ``candidate_uids`` (caller orders them cheapest-victim-first)
        whose release would let ``job`` admit, or None when even evicting
        all of them cannot help — the caller must then evict nobody
        (evicting without a feasible plan would livelock the cluster:
        victims churn forever while the job still never fits). Pure
        simulation: every free-list mutation is rolled back before
        returning."""
        uid = job.metadata.uid
        with self._lock:
            info = topo.parse_accelerator(job.spec.tpu.accelerator, job.spec.tpu.topology)
            want = max(job.spec.tpu.num_slices, 1)
            snapshot = self._snapshot_free()
            try:
                # the real admit() offers the preemptor's own held boxes
                # back for a demand-changed re-carve; the dry run must do
                # the same or a scale-up that needs its own boxes PLUS a
                # victim's is judged infeasible (priority inversion)
                held_self = self._assigned.get(uid)
                if held_self is not None:
                    for h in held_self.slices:
                        self._release_handle(h)
                plan: List[str] = []
                for vuid in candidate_uids:
                    held = self._assigned.get(vuid)
                    if held is None:
                        continue
                    for h in held.slices:
                        self._release_handle(h)
                    plan.append(vuid)
                    ga = self._admit_locked(job, info, want, uid)
                    if ga is not None:
                        # trial carve mutated the free lists; the finally
                        # block restores everything
                        return plan
                return None
            finally:
                self._restore_free(snapshot)

    def release(self, job_uid: str) -> None:
        """Return a gang's boxes to the pool (job finished, deleted, or
        gang-restarting after slice loss)."""
        with self._lock:
            ga = self._assigned.pop(job_uid, None)
            if ga is None:
                return
            for h in ga.slices:
                self._release_handle(h)
            self.version += 1
            log.info("released gang of job uid=%s", job_uid)

    def capacity_summary(self) -> Dict[str, int]:
        """Free whole-slice count per physical accelerator type in the
        inventory — the operator exports these as one labeled gauge on
        /metrics: ``gang_free_slices{accelerator="<type>"}``, e.g.
        ``gang_free_slices{accelerator="v5litepod-16"}``."""
        with self._lock:
            accs = sorted({ps.info.accelerator for ps, _ in self._slices.values()})
        return {acc: self.free_slices(acc) for acc in accs}

    def free_slices(self, accelerator: str) -> int:
        """How many ``accelerator``-shaped sub-slices could be admitted
        right now (counts carvable boxes, not just whole slices)."""
        with self._lock:
            info = topo.parse_accelerator(accelerator)
            grid = topo.host_grid_shape(info)
            n = 0
            for ps, free in self._slices.values():
                if ps.info.generation != info.generation:
                    continue
                if len(topo.host_grid_shape(ps.info)) != len(grid):
                    continue
                for b in free:
                    if b.fits(grid):
                        # how many want-shaped tiles fit in this box
                        tiles = 1
                        for bs, ws in zip(b.shape, grid):
                            tiles *= bs // ws
                        n += tiles
            return n


def _try_merge(a: Box, b: Box) -> Optional[Box]:
    """Merge two boxes iff they are flush along exactly one axis."""
    for d in range(len(a.shape)):
        same_other = all(
            a.origin[i] == b.origin[i] and a.shape[i] == b.shape[i]
            for i in range(len(a.shape))
            if i != d
        )
        if not same_other:
            continue
        if a.origin[d] + a.shape[d] == b.origin[d]:
            return Box(a.origin, tuple(
                a.shape[i] + (b.shape[d] if i == d else 0)
                for i in range(len(a.shape))
            ))
        if b.origin[d] + b.shape[d] == a.origin[d]:
            return Box(b.origin, tuple(
                b.shape[i] + (a.shape[d] if i == d else 0)
                for i in range(len(a.shape))
            ))
    return None
