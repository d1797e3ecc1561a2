"""Power-of-two sub-mesh device groups for the malleable-plan executor.

The PM planner (repro_torch.sparse.plan) assigns every front a power-of-two
device-group *size*; this module turns those sizes into *placements* on a
concrete device list: contiguous, preferentially size-aligned blocks, so a
group always corresponds to a valid sub-mesh of a 1-D device ring (the same
buddy-allocation discipline TPU runtimes use for slice carving).

The allocator is deliberately pure Python over indices — it never touches
jax device state — so it is unit-testable without devices and reusable for
both the wave executor (placement of sharded front batches) and future
elastic reallocation (re-carving after capacity events).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np


def pow2_floor(x: int) -> int:
    """Largest power of two ≤ max(x, 1)."""
    return 1 << (max(int(x), 1).bit_length() - 1)


@dataclass(frozen=True)
class DeviceGroup:
    """A contiguous block of a device list: ``devices[offset:offset+size]``."""

    offset: int
    size: int

    def take(self, devices: Sequence) -> list:
        return list(devices[self.offset : self.offset + self.size])


def scale_group(g: int, planned_total: int, n_devices: int) -> int:
    """Rescale a planned group size to the mesh actually available.

    Plans are often made for a bigger mesh than the one executing them
    (CPU validation of a 256-chip plan).  Keep the plan's *proportions*:
    g/planned_total of the real mesh, floored to a power of two, min 1.
    """
    if planned_total == n_devices:
        return min(pow2_floor(g), pow2_floor(n_devices))
    want = max(1, (g * n_devices) // max(planned_total, 1))
    return min(pow2_floor(want), pow2_floor(n_devices))


def assign_wave_groups(
    requests: Mapping[int, int], n_devices: int
) -> Dict[int, DeviceGroup]:
    """Place one wave's device groups on ``n_devices`` devices.

    ``requests``: front id → group size (already power-of-two and ≤ the
    pow2 floor of the mesh; see ``scale_group``).  Largest groups are placed
    first at size-aligned offsets (buddy discipline); if alignment cannot be
    met the group falls back to any contiguous run, then halves.  When the
    wave genuinely oversubscribes the mesh (possible after downscaling a
    plan), the leftover groups time-share the least-loaded device — the
    executor serializes dispatches anyway, so this is placement pressure,
    not an error.
    """
    free = np.ones(n_devices, dtype=bool)
    load = np.zeros(n_devices, dtype=np.int64)
    out: Dict[int, DeviceGroup] = {}
    for front, g in sorted(requests.items(), key=lambda kv: (-kv[1], kv[0])):
        size = min(pow2_floor(g), pow2_floor(n_devices))
        placed = None
        while placed is None and size >= 1:
            offsets = list(range(0, n_devices - size + 1, size))
            if size > 1:  # aligned first, then sliding
                offsets += [o for o in range(n_devices - size + 1) if o % size]
            for off in offsets:
                if free[off : off + size].all():
                    placed = DeviceGroup(off, size)
                    break
            if placed is None:
                if size == 1:
                    break
                size //= 2
        if placed is None:  # oversubscribed: time-share the least-loaded
            placed = DeviceGroup(int(np.argmin(load)), 1)
        free[placed.offset : placed.offset + placed.size] = False
        load[placed.offset : placed.offset + placed.size] += 1
        out[front] = placed
    return out


class BuddyAllocator:
    """Incremental buddy allocation over a 1-D device ring.

    The wave executor carves all of a wave's groups at once
    (:func:`assign_wave_groups`); the async futures executor instead
    allocates a group the moment a front dispatches and returns it the
    moment the front completes, so freed devices are immediately
    re-carvable for whatever became ready in the meantime.  Same
    discipline as the wave carver — requested power-of-two size, aligned
    offsets first, then any contiguous run, then halving — but stateful:
    ``alloc`` returns ``None`` when no device is free (the caller waits
    for a completion instead of time-sharing).
    """

    def __init__(self, n_devices: int) -> None:
        self.n_devices = int(n_devices)
        self._free = np.ones(self.n_devices, dtype=bool)

    @property
    def n_free(self) -> int:
        return int(self._free.sum())

    @property
    def fragmentation(self) -> float:
        """1 − largest contiguous free run / free devices (0.0 when the
        free set is one block or empty) — how much of the free capacity
        a maximal aligned carve cannot reach."""
        free = int(self._free.sum())
        if free == 0:
            return 0.0
        run = best = 0
        for f in self._free:
            run = run + 1 if f else 0
            best = max(best, run)
        return 1.0 - best / free

    def alloc(self, size: int) -> "DeviceGroup | None":
        """Carve a group of up to ``size`` devices; halves under pressure.

        Returns ``None`` only when *no* device is free.
        """
        size = min(pow2_floor(size), pow2_floor(self.n_devices))
        while size >= 1:
            offsets = list(range(0, self.n_devices - size + 1, size))
            if size > 1:  # aligned first, then sliding
                offsets += [
                    o for o in range(self.n_devices - size + 1) if o % size
                ]
            for off in offsets:
                if self._free[off : off + size].all():
                    self._free[off : off + size] = False
                    return DeviceGroup(off, size)
            size //= 2
        return None

    def free(self, group: DeviceGroup) -> None:
        assert not self._free[group.offset : group.offset + group.size].any(), (
            "double free of device group"
        )
        self._free[group.offset : group.offset + group.size] = True


def groups_footprint(groups: Mapping[int, DeviceGroup]) -> Tuple[int, int]:
    """(devices touched, max concurrent per device) — capacity diagnostics."""
    if not groups:
        return 0, 0
    hi = max(g.offset + g.size for g in groups.values())
    load = np.zeros(hi, dtype=np.int64)
    for g in groups.values():
        load[g.offset : g.offset + g.size] += 1
    return int((load > 0).sum()), int(load.max())
