"""Meshes of rank processes for the LM stack, and lane layouts for the
device-resident serve engine: the port of the reference package's
``launch/mesh.py``.

**The mesh.** The reference lays its LM stack over a device mesh with
named axes (``data``, ``model``, and ``pod`` outermost) and lets GSPMD
place each array.  The port runs explicit SPMD: one rank process a mesh
position, in row-major order over the axes (rank r sits at
``np.unravel_index(r, sizes)``, as ``jax.make_mesh`` lays devices out).
A ``Mesh`` holds the axes and sizes, this rank's coordinates, and a
``torch.distributed`` group for each axis and for ``("pod", "data")``
(every set of axes; the mesh spans the world).  ``make_mesh``, ``make_host_mesh`` and
``make_production_mesh`` build one; the production mesh, (16, 16) or
(2, 16, 16) multi-pod, is *abstract* (axes and sizes, no rank, no groups)
when fewer ranks run than it has positions, so that
``parallel/sharding.py`` can lay leaves out on it, as the reference's
``compat.abstract_mesh`` does.

**The backend** is chosen by one rule (``choose_backend``), shared with
``launch/ranks.py``: NCCL when every rank has a card of its own; gloo
when ranks share one card or run on the CPU (NCCL refuses two ranks on
one card).  On gloo a collective on card tensors stages through pinned
host memory (``parallel/collectives.py``); ``Mesh.staged`` says so, and
the callers report it.  Nothing falls back silently.

**A fake world** (``fake_world``): one process playing rank 0 of N through
torch's ``fake`` process-group backend, whose collectives return at once
and move nothing.  The dry run (``launch/dryrun.py``) makes the production
mesh concrete so, and traces a rank's step on fake tensors; its
``Mesh.backend`` is ``"fake"`` and nothing is staged.

**Lanes.** The reference lays K DDC shards over a K-device mesh axis, one
shard a device.  The port lays K lanes on one torch device: on a card each
lane owns a ``torch.cuda.Stream``, so one lane's work is ordered only
against its own and against what the device's current stream issued
before it; on the CPU no lane has a stream and work runs in the order it
is issued.  One card holds any number of lanes.

Cross-stream rules the lanes' users keep:

* ``Lane.scope()`` makes the lane's stream wait for everything the
  current stream has issued, then issues the block's work on the lane.
  So a lane never reads a tensor before the current stream has finished
  writing it, and a block a lane reuses from the allocator was released
  by readers that were issued before.
* ``join(lanes)`` makes the current stream wait for the lanes' work
  before it reads what they wrote; ``Lane.hold(t)`` records a current-
  stream tensor as used by the lane, so the caching allocator does not
  hand its block out again before the lane's reads of it are done.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# ---------------------------------------------------------------------------
# Meshes of ranks (the LM stack)
# ---------------------------------------------------------------------------


def choose_backend(world: int, device="cuda") -> str:
    """The process group's backend: "nccl" when ``device`` is a card and
    each of the ``world`` ranks has a card of its own, "gloo" otherwise
    (ranks sharing a card, or on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


_GROUPS: dict = {}


def _subgroup(ranks: tuple):
    """The process group of the global ``ranks`` (the default group when
    they are the whole world), made once a process.  Every rank of the
    world must ask for the same groups in the same order: torch's group
    creation keeps per-process state that ranks making different groups
    would let drift apart (even with ``use_local_synchronization``)."""
    if len(ranks) == dist.get_world_size():
        return dist.group.WORLD
    if ranks not in _GROUPS:
        _GROUPS[ranks] = dist.new_group(list(ranks))
    return _GROUPS[ranks]


@dataclasses.dataclass(eq=False)
class Mesh:
    """Named mesh axes over rank processes.  ``shape`` maps each axis to
    its size, in order (outermost first), as a jax mesh's ``shape`` does.
    An abstract mesh (``rank`` None) has no coordinates and no groups."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    ranks: Optional[Tuple[int, ...]] = None   # global rank of each position, row-major
    rank: Optional[int] = None                # this process's position
    device: Optional[torch.device] = None
    _groups: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    @property
    def abstract(self) -> bool:
        return self.rank is None

    @property
    def coords(self) -> dict:
        """This rank's position on each axis."""
        self._concrete()
        return self.coords_of(self.rank)

    def coords_of(self, position: int) -> dict:
        """The position on each axis of the ``position``-th rank (row-major)."""
        return dict(zip(self.axis_names,
                        (int(c) for c in np.unravel_index(position, self.sizes))))

    @property
    def backend(self) -> str:
        self._concrete()
        return dist.get_backend(self.group(self.axis_names))

    @property
    def staged(self) -> bool:
        """Collectives on card tensors go through pinned host memory (gloo)."""
        return self.backend == "gloo" and self.device is not None and self.device.type == "cuda"

    def _concrete(self) -> None:
        if self.abstract:
            raise ValueError(f"the mesh {self.shape} is abstract: it has no ranks")

    def _axes(self, axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in self.axis_names if a in axes)

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self._axes(axes))

    def index(self, axes) -> int:
        """This rank's row-major index over ``axes`` (0 for no axis)."""
        c = self.coords
        idx = 0
        for a in self._axes(axes):
            idx = idx * self.shape[a] + c[a]
        return idx

    def group(self, axes):
        """The process group over ``axes`` holding this rank (``make_mesh``
        made the groups of every set of axes)."""
        key = self._axes(axes)
        if key not in self._groups:
            raise ValueError(f"the mesh {self.shape} has no group over {key}")
        return self._groups[key]

    def _make_groups(self) -> None:
        """One group for every set of axes and every position of the
        others, made by every rank in one order; this rank keeps its own."""
        grid = np.arange(self.size).reshape(self.sizes)
        n = len(self.axis_names)
        for mask in range(1, 1 << n):
            axes = tuple(a for i, a in enumerate(self.axis_names) if mask >> (n - 1 - i) & 1)
            moved = np.moveaxis(grid, [self.axis_names.index(a) for a in axes],
                                range(n - len(axes), n))
            mine = None
            for pos in moved.reshape(-1, math.prod(self.shape[a] for a in axes)):
                ranks = tuple(self.ranks[int(i)] for i in pos)
                g = _subgroup(ranks)
                if self.ranks[self.rank] in ranks:
                    mine = g
            self._groups[axes] = mine


@contextlib.contextmanager
def fake_world(world: int):
    """This process as rank 0 of ``world`` ranks on torch's ``fake``
    backend (no other process, no data moved), for the dry run; the
    default group and every group made inside are destroyed on exit."""
    try:   # an internal module of torch's: imported only here
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError("the dry run needs torch's fake process group "
                           "(torch.testing._internal.distributed.fake_pg), which this "
                           f"torch {torch.__version__} does not have") from e
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised: a fake world needs "
                           "a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()
        _GROUPS.clear()


def make_mesh(shape, axes, group=None, *, device=None) -> Mesh:
    """A mesh of ``shape`` over ``axes`` on the ranks of the world, which
    must number exactly prod(shape) (``group``, if given, must be the
    whole world: every rank takes part in making the mesh's groups, one
    for every set of axes).  Without an initialised default group the mesh
    is abstract."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in length")
    if not dist.is_initialized():
        return Mesh(axes, shape)
    ranks = tuple(dist.get_process_group_ranks(group or dist.group.WORLD))
    if len(ranks) != dist.get_world_size():
        raise ValueError("a mesh spans the whole world: run it in a spawn of its own size")
    if len(ranks) != math.prod(shape):
        raise ValueError(f"a mesh of shape {dict(zip(axes, shape))} needs {math.prod(shape)} "
                         f"ranks; the world has {len(ranks)}")
    mesh = Mesh(axes, shape, ranks, dist.get_rank(group or dist.group.WORLD),
                None if device is None else torch.device(device))
    mesh._make_groups()
    return mesh


def make_host_mesh(n: int | None = None, axis: str = "data", group=None, *,
                   device=None) -> Mesh:
    """A one-axis mesh over ``n`` ranks (all of ``group``'s by default)."""
    if n is None:
        n = dist.get_world_size(group) if dist.is_initialized() else 1
    return make_mesh((n,), (axis,), group, device=device)


def production_shape(multi_pod: bool = False) -> tuple:
    """((sizes), (axes)) of the production mesh: 256 ranks as (data 16,
    model 16), or 512 as (pod 2, data 16, model 16)."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, group=None, device=None) -> Mesh:
    """The production mesh: concrete when ``group`` (the world by default)
    has exactly its 256 (512) ranks, abstract when there are fewer (or
    no process group), for laying leaves out; more ranks raise."""
    shape, axes = production_shape(multi_pod)
    n = dist.get_world_size(group) if dist.is_initialized() else 0
    if n < math.prod(shape):
        return Mesh(axes, shape)
    return make_mesh(shape, axes, group, device=device)


# ---------------------------------------------------------------------------
# Lanes (the DDC serve engine)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class Lane:
    """One shard's lane: its index, device and (on a card) stream."""

    index: int
    device: torch.device
    stream: Optional["torch.cuda.Stream"]

    def scope(self):
        """Context that issues its work on this lane, after all that the
        device's current stream issued before it."""
        if self.stream is None:
            return contextlib.nullcontext()
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        return torch.cuda.stream(self.stream)

    def hold(self, *tensors: torch.Tensor) -> None:
        """Mark tensors allocated on another stream as read by this lane."""
        if self.stream is not None:
            for t in tensors:
                t.record_stream(self.stream)


def make_lane_mesh(n: int, device="cuda") -> Tuple[Lane, ...]:
    """``n`` lanes on ``device``: each with a stream of its own on a card,
    none on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return tuple(Lane(i, dev, torch.cuda.Stream(dev) if dev.type == "cuda" else None)
                 for i in range(n))


def join(lanes: Sequence[Lane], *tensors: torch.Tensor) -> None:
    """Make the current stream wait for ``lanes``' work, and record
    ``tensors`` (written on those lanes) as read by the current stream."""
    streams = [lane.stream for lane in lanes if lane.stream is not None]
    if not streams:
        return
    cur = torch.cuda.current_stream(lanes[0].device)
    for s in streams:
        cur.wait_stream(s)
    for t in tensors:
        t.record_stream(cur)
