"""One platform protocol over the repo's four platform notions.

Before the facade, "where does this run" was spelled four ways: a
:class:`~repro_torch.core.profiles.Profile` (shared memory, §4's p(t)), a node
count / :class:`~repro_torch.online.events.ProcessorPool` (the online core),
``(p, q)`` node pairs (§6's two-node algorithms), and a torch device list
(the plan executor).  A :class:`Platform` answers all four questions:

* ``capacity()``            — total processors right now
* ``profile()``             — capacity over time (step function p(t))
* ``node_sizes()``          — the 𝓡-constraint structure (one entry per
  multicore node; a single entry means no placement constraint)
* ``to_mesh()`` / ``devices()`` — the device bridge for real execution
* ``resources()``           — the typed resource view: the compute
  profile *plus* per-node memory capacities in bytes (the dimension the
  memory-bounded policies and admission plan against)

New platforms subclass :class:`Platform` in their own file; ``Session``
only speaks the protocol, so nothing else changes.  ``resources()`` has
a default (infinite memory per node), so pre-existing third-party
subclasses keep planning exactly as before.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core.profiles import Profile


def _host_memory_bytes() -> float:
    """Physical memory of this host, with a conservative fallback."""
    try:
        return float(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"))
    except (AttributeError, OSError, ValueError):
        return float(16 * 2**30)


@dataclass(frozen=True)
class Resources:
    """Typed resource view of a platform: compute *and* memory.

    ``compute`` is the share profile p(t) (what the PM theory schedules);
    ``memory`` is one capacity in bytes per memory node — one entry for a
    shared-memory machine, one per node for a cluster, one per device for
    a mesh.  ``inf`` entries mean "unconstrained" (the pre-memory-model
    default every :class:`Platform` subclass inherits).
    """

    compute: Profile
    memory: Tuple[float, ...]

    def __post_init__(self) -> None:
        if not self.memory or any(m <= 0 for m in self.memory):
            raise ValueError("memory capacities must be positive")

    def total_memory(self) -> float:
        return float(sum(self.memory))

    def min_node_memory(self) -> float:
        return float(min(self.memory))

    def describe(self) -> str:
        def fmt(m: float) -> str:
            return "inf" if math.isinf(m) else f"{m / 2**30:.1f}GiB"

        mems = "+".join(fmt(m) for m in self.memory)
        return f"p(0)={self.compute.p_at(0.0):g}, mem={mems}"


class Platform:
    """Base protocol.  Subclasses override what differs."""

    name: str = "platform"

    # -- capacity -------------------------------------------------------
    def capacity(self) -> float:
        """Total processors available at t=0."""
        raise NotImplementedError

    def profile(self) -> Profile:
        """Capacity over time; constant by default."""
        return Profile.constant(self.capacity())

    def node_sizes(self) -> Tuple[float, ...]:
        """Per-node processor counts (the 𝓡 placement constraint).

        A single entry means tasks may use any processors (shared
        memory / one pod); ≥ 2 entries means a task must stay within one
        node (§6's constraint).
        """
        return (self.capacity(),)

    @property
    def n_nodes(self) -> int:
        return len(self.node_sizes())

    def node_alphas(self) -> Optional[Tuple[float, ...]]:
        """Per-node speedup exponents, or None when the platform does
        not distinguish them (the problem's single α applies then).
        Only genuinely mixed platforms override this."""
        return None

    def node_speeds(self) -> Tuple[float, ...]:
        """Per-node work rates relative to the unit the task lengths are
        expressed in (1.0 everywhere for homogeneous platforms)."""
        return tuple(1.0 for _ in self.node_sizes())

    def resources(self) -> Resources:
        """The typed resource view (compute profile + per-node memory).

        The default reports *infinite* memory per node so that platforms
        written before the resource model keep planning unchanged;
        built-ins override it with real byte counts.
        """
        return Resources(
            compute=self.profile(),
            memory=tuple(math.inf for _ in self.node_sizes()),
        )

    def to_pool(self):
        """A live :class:`~repro_torch.online.events.ProcessorPool` sized to
        this platform (the online scheduler's capacity substrate)."""
        from repro_torch.online.events import ProcessorPool

        p = self.capacity()
        if abs(p - round(p)) < 1e-9 and p >= 1:
            return ProcessorPool(int(round(p)))
        return ProcessorPool(1, node_speed=p)

    # -- the device bridge ----------------------------------------------
    def devices(self) -> Optional[List[torch.device]]:
        """Torch devices backing this platform, or None (model-only)."""
        return None

    def to_mesh(self, axis: str = "task") -> List[torch.device]:
        """The device list :meth:`devices` returns (``axis`` is accepted
        for the reference's signature; a torch plan executor takes a flat
        device list, not a named mesh).

        Raises on model-only platforms — planning works everywhere, but
        execution needs hardware behind the capacity numbers.
        """
        devs = self.devices()
        if not devs:
            raise RuntimeError(
                f"platform {self.name!r} has no devices to build a mesh "
                f"from; use DeviceMesh (or any Platform whose devices() "
                f"is non-empty) for .execute()"
            )
        return list(devs)

    def describe(self) -> str:
        sizes = self.node_sizes()
        nodes = "x".join(f"{s:g}" for s in sizes)
        return f"{self.name}[{nodes}]"

    def __repr__(self) -> str:
        return self.describe()


# ----------------------------------------------------------------------
class SharedMemory(Platform):
    """§4's machine: p processors, possibly varying over time.

    ``SharedMemory(40)`` or ``SharedMemory(Profile.of([(10, 64), (inf,
    32)]))`` — the paper's step-function p(t) is the platform.
    """

    name = "shared"

    def __init__(
        self,
        p: Union[float, int, Profile],
        *,
        memory: Optional[float] = None,
    ) -> None:
        if isinstance(p, Profile):
            self._profile = p
        else:
            if p <= 0:
                raise ValueError("capacity must be positive")
            self._profile = Profile.constant(float(p))
        # memory in bytes; default = this host's physical RAM (a shared-
        # memory machine *is* the host the process plans on)
        self._memory = float(memory) if memory is not None else _host_memory_bytes()
        if self._memory <= 0:
            raise ValueError("memory must be positive")

    def capacity(self) -> float:
        return self._profile.p_at(0.0)

    def profile(self) -> Profile:
        return self._profile

    def resources(self) -> Resources:
        return Resources(compute=self._profile, memory=(self._memory,))


class MulticoreCluster(Platform):
    """Distributed multicore nodes with the 𝓡 constraint (§6).

    ``MulticoreCluster([p, p])`` is the homogeneous two-node platform of
    Algorithm 11; ``MulticoreCluster([p, q])`` the heterogeneous one of
    Algorithm 12; ``k`` entries the beyond-paper k-node greedy.
    """

    name = "cluster"

    def __init__(
        self,
        nodes: Sequence[float],
        *,
        node_memory: Optional[Union[float, Sequence[float]]] = None,
    ) -> None:
        sizes = tuple(float(s) for s in nodes)
        if not sizes or any(s <= 0 for s in sizes):
            raise ValueError("cluster needs positive node sizes")
        self._sizes = sizes
        if node_memory is None:
            mems = tuple(_host_memory_bytes() for _ in sizes)
        elif isinstance(node_memory, (int, float)):
            mems = tuple(float(node_memory) for _ in sizes)
        else:
            mems = tuple(float(m) for m in node_memory)
            if len(mems) != len(sizes):
                raise ValueError(
                    f"{len(sizes)} nodes but {len(mems)} memory capacities"
                )
        if any(m <= 0 for m in mems):
            raise ValueError("node memory must be positive")
        self._memory = mems

    def capacity(self) -> float:
        return float(sum(self._sizes))

    def node_sizes(self) -> Tuple[float, ...]:
        return self._sizes

    def resources(self) -> Resources:
        return Resources(compute=self.profile(), memory=self._memory)

    @property
    def homogeneous(self) -> bool:
        return len(set(self._sizes)) == 1


class DeviceMesh(Platform):
    """A torch device list: capacity = device count, and a real bridge.

    ``DeviceMesh()`` takes every CUDA device lazily, at the first
    ``devices()`` call, and raises there when there is none: the CPU is
    used only when the caller passes it, e.g.
    ``DeviceMesh([torch.device("cpu")] * 4)`` (four logical lanes running
    the kernels' plain versions).  ``plan_devices`` lets a plan target a
    bigger mesh than the local one (plan for 256, execute on one card —
    the executor rescales groups).
    """

    name = "mesh"

    def __init__(
        self,
        devices: Optional[Sequence] = None,
        *,
        plan_devices: Optional[int] = None,
    ) -> None:
        self._devices = (
            [torch.device(d) for d in devices] if devices is not None else None
        )
        if plan_devices is not None and plan_devices < 1:
            raise ValueError("plan_devices must be >= 1")
        self._plan_devices = plan_devices

    def devices(self) -> List[torch.device]:
        if self._devices is None:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if n == 0:
                raise RuntimeError(
                    "DeviceMesh: no CUDA device; pass "
                    "DeviceMesh([torch.device('cpu')] * k) to run on the CPU"
                )
            self._devices = [torch.device("cuda", i) for i in range(n)]
        return self._devices

    def capacity(self) -> float:
        if self._plan_devices is not None:
            return float(self._plan_devices)
        return float(len(self.devices()))

    def resources(self) -> Resources:
        """Per-device memory: a CUDA device's total bytes from
        ``torch.cuda.mem_get_info``; CPU lanes get an equal slice of the
        host's physical RAM, so planning against them still sees finite,
        realistic capacities."""
        devs = self.devices()
        fallback = _host_memory_bytes() / max(len(devs), 1)
        mems = tuple(
            float(torch.cuda.mem_get_info(d)[1]) if d.type == "cuda" else fallback
            for d in devs
        )
        return Resources(compute=self.profile(), memory=mems)

    def describe(self) -> str:
        n = self._plan_devices
        if n is None and self._devices is not None:
            n = len(self._devices)
        return f"mesh[{n if n is not None else '?'}]"


class MixedCluster(Platform):
    """Genuinely heterogeneous nodes: CPU hosts next to accelerator
    meshes, each with its own speedup exponent and work rate (§6's
    model with the homogeneity assumptions actually dropped).

    ``MixedCluster([SharedMemory(40), DeviceMesh()], alphas=(0.85,
    0.95), speeds=(1.0, 4.0))`` — nodes may be Platforms or plain
    processor counts.  ``speeds`` are relative work rates in the unit
    the task lengths are expressed in (the ``hetero-mixed`` policy
    divides work by them); ``alphas`` default to None, meaning the
    problem's single α applies to every node.
    """

    name = "mixed"

    def __init__(
        self,
        nodes: Sequence,
        *,
        alphas: Optional[Sequence[float]] = None,
        speeds: Optional[Sequence[float]] = None,
        node_memory: Optional[Union[float, Sequence[float]]] = None,
    ) -> None:
        if not nodes:
            raise ValueError("a mixed cluster needs at least one node")
        subs: List[Platform] = []
        for nd in nodes:
            if isinstance(nd, Platform):
                subs.append(nd)
            elif isinstance(nd, (int, float)) and not isinstance(nd, bool):
                subs.append(SharedMemory(float(nd)))
            else:
                raise TypeError(
                    f"mixed nodes are Platforms or processor counts, got "
                    f"{type(nd).__name__}"
                )
        self._subs = tuple(subs)
        n = len(self._subs)

        def per_node(vals, what, positive=True):
            out = tuple(float(v) for v in vals)
            if len(out) != n:
                raise ValueError(f"{n} nodes but {len(out)} {what}")
            if positive and any(v <= 0 for v in out):
                raise ValueError(f"{what} must be positive")
            return out

        self._alphas = None if alphas is None else per_node(alphas, "alphas")
        if self._alphas is not None and any(a > 1.0 for a in self._alphas):
            raise ValueError("alphas must be in (0, 1]")
        self._speeds = (
            tuple(1.0 for _ in self._subs)
            if speeds is None
            else per_node(speeds, "speeds")
        )
        if node_memory is None:
            self._memory = tuple(
                s.resources().total_memory() for s in self._subs
            )
        elif isinstance(node_memory, (int, float)):
            self._memory = tuple(float(node_memory) for _ in self._subs)
        else:
            self._memory = per_node(node_memory, "memory capacities")

    def subplatforms(self) -> Tuple[Platform, ...]:
        return self._subs

    def capacity(self) -> float:
        return float(sum(s.capacity() for s in self._subs))

    def node_sizes(self) -> Tuple[float, ...]:
        return tuple(s.capacity() for s in self._subs)

    def node_alphas(self) -> Optional[Tuple[float, ...]]:
        return self._alphas

    def node_speeds(self) -> Tuple[float, ...]:
        return self._speeds

    def resources(self) -> Resources:
        return Resources(compute=self.profile(), memory=self._memory)

    def devices(self) -> Optional[List[torch.device]]:
        for s in self._subs:
            devs = s.devices()
            if devs:
                return devs
        return None

    def describe(self) -> str:
        parts = []
        for s, sp in zip(self._subs, self._speeds):
            tag = f"{s.name}:{s.capacity():g}"
            if sp != 1.0:
                tag += f"@{sp:g}x"
            parts.append(tag)
        return f"mixed[{'+'.join(parts)}]"


# ----------------------------------------------------------------------
def as_platform(obj) -> Platform:
    """Coerce ``obj`` into a Platform.

    Platform → itself; number → SharedMemory; Profile → SharedMemory;
    sequence of numbers → MulticoreCluster; None → DeviceMesh().
    """
    if isinstance(obj, Platform):
        return obj
    if obj is None:
        return DeviceMesh()
    if isinstance(obj, Profile):
        return SharedMemory(obj)
    if isinstance(obj, (int, float)) and not isinstance(obj, bool):
        if not math.isfinite(float(obj)):
            raise ValueError("capacity must be finite")
        return SharedMemory(obj)
    if isinstance(obj, (list, tuple)) and obj and all(
        isinstance(x, (int, float)) for x in obj
    ):
        return MulticoreCluster(obj)
    raise TypeError(f"cannot interpret {obj!r} as a Platform")


__all__ = [
    "DeviceMesh",
    "MixedCluster",
    "MulticoreCluster",
    "Platform",
    "Resources",
    "SharedMemory",
    "as_platform",
]
