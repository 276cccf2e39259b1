"""Accelerator topology math for the port: NVIDIA H100 hosts.

The JAX package's ``utils/topology.py`` resolves TPU slices (``v5p-32``,
a 3-D ICI torus of chips, 4 a host). This copy keeps its names
(:class:`SliceInfo`, the host grid the gang allocator carves) and changes
the accelerator vocabulary to the one this operator places:

- ``h100-N``: N counts cards. A host holds 8, joined all to all by
  NVLink/NVSwitch, so the grid is 1-D (``(N,)``). ``h100-1``, ``-2``,
  ``-4`` and ``-8`` are one host; a larger N is a multiple of 8 and spans
  N/8 hosts. Any other N is refused.
- ``cpu-N`` (hermetic tests / local backend): N virtual devices, one
  host, exactly the reference's.

Any other generation, a TPU's (``v4``, ``v5p``, ...) among them, is
refused, naming the accepted types. Placement stays host-granular, as in
the reference: a job takes whole hosts, so the host grid is the 1-D run
``(hosts,)``, and a pod's ranks take cards 0..d-1 of its host
(``runtime/launcher.rank_device``).
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Tuple

_GEN_RE = re.compile(r"^([a-z]+[0-9]*[a-z]*)(?:-([0-9]+))?$")

# generation -> the value of GKE's cloud.google.com/gke-accelerator node
# label on a nodepool of that card. cpu has none: validation rejects
# provider="gke" for it rather than rendering a half-GKE pod.
GKE_ACCELERATOR = {"h100": "nvidia-h100-80gb"}

# generation -> chips a host (None: all devices on one host)
_GENERATIONS = {"h100": 8, "cpu": None}
# the card counts one host takes (its NVLink domain split evenly)
_HOST_SIZES = (1, 2, 4, 8)


@dataclasses.dataclass(frozen=True)
class SliceInfo:
    """Resolved shape of one slice of an accelerator type."""

    accelerator: str
    generation: str
    chips: int
    hosts: int
    topology: Tuple[int, ...]  # chip grid: (chips,), or a cpu's explicit one

    @property
    def chips_per_host(self) -> int:
        return self.chips // self.hosts


class TopologyError(ValueError):
    pass


def parse_topology(s: str) -> Tuple[int, ...]:
    """``"2x4"`` -> ``(2, 4)``."""
    try:
        dims = tuple(int(p) for p in s.lower().split("x"))
    except ValueError:
        raise TopologyError(f"malformed topology {s!r}")
    if not dims or any(d < 1 for d in dims):
        raise TopologyError(f"malformed topology {s!r}")
    return dims


def host_grid_shape(info: SliceInfo) -> Tuple[int, ...]:
    """How the slice's hosts arrange as a grid: a 1-D run of hosts, which
    the gang allocator carves into runs of consecutive hosts."""
    return (info.hosts,)


def host_index_of(info: SliceInfo, coords: Tuple[int, ...]) -> int:
    """Host-grid coordinates -> host index."""
    (idx,) = coords
    return idx


def parse_accelerator(accelerator: str, topology: str = "") -> SliceInfo:
    """Resolve an accelerator type string (+ optional explicit topology) into
    a :class:`SliceInfo`. Raises :class:`TopologyError` on malformed or
    inconsistent requests — surfaced to users via api/validation.py."""
    acc = accelerator.strip().lower()
    m = _GEN_RE.match(acc)
    if not m:
        raise TopologyError(f"unknown accelerator type {accelerator!r}")
    gen, size = m.group(1), m.group(2)
    if gen not in _GENERATIONS:
        raise TopologyError(
            f"unknown accelerator generation {gen!r} (accepted: "
            f"{', '.join(g + '-N' for g in sorted(_GENERATIONS))}; "
            "a TPU slice cannot run on this operator)"
        )
    chips_per_host = _GENERATIONS[gen]

    chips = int(size) if size else 1
    if chips < 1:
        raise TopologyError(f"accelerator size must be >= 1, got {accelerator!r}")

    if topology:
        topo = parse_topology(topology)
        if math.prod(topo) != chips:
            raise TopologyError(
                f"topology {topology!r} has {math.prod(topo)} chips but "
                f"{accelerator!r} has {chips}"
            )
        if gen != "cpu" and len(topo) != 1:
            raise TopologyError(
                f"{gen} slices have a 1-D NVLink grid; topology "
                f"{topology!r} is {len(topo)}-D"
            )
    else:
        topo = (chips,)

    if chips_per_host is None:
        hosts = 1
    elif chips <= chips_per_host:
        if chips not in _HOST_SIZES:
            raise TopologyError(
                f"{accelerator!r}: {chips} chips do not split one "
                f"{chips_per_host}-chip host evenly (one host takes "
                f"{', '.join(map(str, _HOST_SIZES))})"
            )
        hosts = 1
    else:
        if chips % chips_per_host:
            raise TopologyError(
                f"{accelerator!r}: {chips} chips not divisible into "
                f"{chips_per_host}-chip hosts"
            )
        hosts = chips // chips_per_host

    return SliceInfo(
        accelerator=acc,
        generation=gen,
        chips=chips,
        hosts=hosts,
        topology=topo,
    )
