"""Device meshes: which process and device each position of a grid runs on.

Two kinds of mesh, one class:

* **Local** (no ``torch.distributed`` process group): every position sits on
  the one device the caller names.  A PE-array grid
  (``repro_torch.backends.grid``) then runs its shards one after another
  there and adds the partial sums explicitly; a pipeline
  (``launch/pipeline.py``) hands its stages over on that device.  Only a
  one-position :func:`make_mesh` exists without a process group.  A local
  mesh whose positions name several devices is refused by
  ``pipeline_apply``: stages on several devices run one rank a position.
* **Distributed** (a process group is up, from ``torchrun``'s ``RANK`` /
  ``WORLD_SIZE`` / ``LOCAL_RANK`` through :func:`init_distributed`, or from a
  test's spawn): one position per rank, row-major, each rank on its own
  device (``cuda:LOCAL_RANK``, or the CPU under ``gloo``).  The program is
  SPMD, as the reference's jit is: every rank runs the same code, holds its
  own shard of what the reference shards, and the reference's collectives
  (``psum``, ``pmax``, ``all_to_all``) are ``torch.distributed`` collectives
  on the rank's line of one axis (:meth:`Mesh.axis_group`).  A mesh whose
  size differs from the world size raises; nothing is emulated.

``with mesh:`` makes a mesh the current one (:func:`current_mesh`), standing
in for the reference's ``_current_mesh()``: the sequence-sharded decodes
(``models/attention.py``) and expert parallelism (``models/moe.py``) read it.
:func:`grid_mesh` is the (cached) mesh a grid backend executes on, and
:func:`make_production_mesh` the reference's pod meshes of ``launch/train.py
--mesh pod|multipod``.
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
import math
import os

import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_production_mesh", "make_mesh", "make_grid_mesh",
           "make_pipeline_mesh", "grid_mesh", "current_mesh",
           "init_distributed", "distributed", "world_size", "rank",
           "DEFAULT_TIMEOUT_S"]

#: the process group's timeout: a rank that diverges (and leaves the others
#: waiting in a collective) fails the run after this long instead of hanging
DEFAULT_TIMEOUT_S = 300

_CURRENT: list["Mesh"] = []
_GRID_MESHES: dict = {}


def distributed() -> bool:
    """Whether a ``torch.distributed`` process group is up."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if distributed() else 1


def rank() -> int:
    return dist.get_rank() if distributed() else 0


def init_distributed(device="cuda", *, timeout_s: float = DEFAULT_TIMEOUT_S,
                     init_method: str | None = None, rank_: int | None = None,
                     world: int | None = None) -> torch.device:
    """Join (or reuse) the process group and return this rank's device.

    Without ``init_method`` the group comes from the environment ``torchrun``
    sets (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); a
    spawner passes ``init_method`` (``tcp://localhost:<port>`` or
    ``file://...``), ``rank_`` and ``world``.  ``device`` "cuda" binds the
    rank to ``cuda:LOCAL_RANK`` (``LOCAL_RANK`` defaults to the rank) and
    uses NCCL with its asynchronous error handling on; "cpu" uses ``gloo``.
    The timeout is finite, so a rank left waiting in a collective fails.
    """
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed(device='cuda') but "
                               "torch.cuda.is_available() is False")
        os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "1")
    if not distributed():
        kw = dict(timeout=datetime.timedelta(seconds=timeout_s))
        if init_method is not None:
            kw.update(init_method=init_method, rank=int(rank_),
                      world_size=int(world))
        if device.type == "cuda":
            local = int(os.environ.get("LOCAL_RANK",
                                       rank_ if rank_ is not None
                                       else os.environ.get("RANK", 0)))
            torch.cuda.set_device(local)
            dist.init_process_group("nccl", device_id=torch.device("cuda", local),
                                    **kw)
        else:
            dist.init_process_group("gloo", **kw)
    return _rank_device()


def _rank_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A named grid of positions, each placed on a device.

    ``shape`` / ``axes`` — the grid and its axis names; ``devices`` — one
    ``torch.device`` per position, row-major over ``shape``.  A distributed
    mesh also has ``rank`` (this process's flat position, which is its rank
    in the process group) and ``groups``: for each axis, the process group of
    the rank's line along it (the ranks that differ from it in that
    coordinate only).  ``with mesh:`` makes it :func:`current_mesh`.
    """

    shape: tuple[int, ...]
    axes: tuple[str, ...]
    devices: tuple[torch.device, ...]
    rank: int | None = None
    groups: tuple = ()

    def __post_init__(self) -> None:
        if len(self.shape) != len(self.axes):
            raise ValueError(f"mesh shape {self.shape} and axes {self.axes} "
                             f"differ in length")
        if len(self.devices) != math.prod(self.shape):
            raise ValueError(f"mesh of shape {self.shape} needs "
                             f"{math.prod(self.shape)} devices, got "
                             f"{len(self.devices)}")

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def distributed(self) -> bool:
        """One position per rank of a process group (else all positions on
        one device, in this process)."""
        return self.rank is not None

    def coord_of(self, flat: int) -> tuple[int, ...]:
        coord = []
        for s in reversed(self.shape):
            coord.append(flat % s)
            flat //= s
        return tuple(reversed(coord))

    def flat_of(self, coord: tuple[int, ...]) -> int:
        flat = 0
        for c, s in zip(coord, self.shape):
            if not 0 <= c < s:
                raise IndexError(f"position {coord} outside mesh {self.shape}")
            flat = flat * s + c
        return flat

    def device_of(self, coord: tuple[int, ...]) -> torch.device:
        """The device position ``coord`` runs on."""
        return self.devices[self.flat_of(coord)]

    @property
    def rank_coord(self) -> tuple[int, ...]:
        """This rank's coordinate (a distributed mesh only)."""
        self._require_distributed("rank_coord")
        return self.coord_of(self.rank)

    def axis_size(self, name: str) -> int:
        return self.shape[self.axes.index(name)]

    def axis_index(self, name: str) -> int:
        """This rank's coordinate along ``name`` (``lax.axis_index``)."""
        return self.rank_coord[self.axes.index(name)]

    def axis_group(self, name: str):
        """The process group of this rank's line along ``name``."""
        self._require_distributed("axis_group")
        return dict(self.groups)[name]

    def _require_distributed(self, what: str) -> None:
        if not self.distributed:
            raise ValueError(f"Mesh.{what} needs a distributed mesh (one "
                             f"position per rank); this one is local")

    def __enter__(self) -> "Mesh":
        _CURRENT.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _CURRENT.remove(self)


def current_mesh() -> Mesh | None:
    """The innermost mesh entered with ``with mesh:`` (None outside any)."""
    return _CURRENT[-1] if _CURRENT else None


def _line_groups(shape: tuple[int, ...], axes: tuple[str, ...],
                 me: int) -> tuple:
    """Create every line group of every axis, on every rank in the same
    order (``dist.new_group`` is collective over the whole world), and keep
    the ones that hold rank ``me``.  A line that spans the whole world is
    the default group."""
    n = math.prod(shape)
    strides = [math.prod(shape[i + 1:]) for i in range(len(shape))]
    mine = []
    for a, name in enumerate(axes):
        others = [range(s) if i != a else range(1)
                  for i, s in enumerate(shape)]
        group = None
        for base in itertools.product(*others):
            start = sum(c * st for c, st in zip(base, strides))
            ranks = [start + j * strides[a] for j in range(shape[a])]
            g = (dist.group.WORLD if len(ranks) == n
                 else dist.new_group(ranks))
            if me in ranks:
                group = g
        mine.append((name, group))
    return tuple(mine)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device="cuda") -> Mesh:
    """A mesh with one position per rank of the process group.

    With a process group up, its world size must equal the mesh's size
    (else ``ValueError``; nothing is emulated), and every rank must call this
    with the same arguments, in the same order relative to its other
    collectives.  ``device`` names this rank's device type; the rank's own
    device is the process group's (:func:`init_distributed`).  Without a
    process group only a one-position mesh exists (on ``device``); a larger
    one raises ``RuntimeError``.
    """
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    n = math.prod(shape)
    label = "x".join(map(str, shape))
    if not distributed():
        if n != 1:
            raise RuntimeError(
                f"a {label} mesh has {n} positions, one process each, but no "
                f"torch.distributed process group is up: run under torchrun "
                f"--nproc-per-node {n} (or spawn {n} ranks and call "
                f"launch.mesh.init_distributed)")
        return Mesh(shape, axes, (torch.device(device),))
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"a {label} mesh has {n} positions but the process "
                         f"group has {world} ranks: one rank per position")
    me = dist.get_rank()
    own = _rank_device()
    if own.type == "cuda":
        per_host = int(os.environ.get("LOCAL_WORLD_SIZE",
                                      torch.cuda.device_count()))
        devices = tuple(own if r == me else torch.device("cuda", r % per_host)
                        for r in range(n))
    else:
        devices = (own,) * n
    return Mesh(shape, axes, devices, rank=me,
                groups=_line_groups(shape, axes, me))


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """The reference's ``("data", "model")`` 16x16 training mesh (256
    positions) or its ``("pod", "data", "model")`` 2x16x16 (512), one rank
    a position.  A world of another size raises ``NotImplementedError``,
    naming both counts (nothing is emulated)."""
    shape, axes = (((2, 16, 16), ("pod", "data", "model")) if multi_pod
                   else ((16, 16), ("data", "model")))
    n = math.prod(shape)
    if world_size() != n:
        raise NotImplementedError(
            f"the {'x'.join(map(str, shape))} production mesh has {n} "
            f"positions and the world has {world_size()} rank(s): run one "
            f"rank a position (torchrun with {n} processes in all)")
    return make_mesh(shape, axes, device)


def make_grid_mesh(units_x: int, units_y: int, device="cuda") -> Mesh:
    """The ``("gx", "gy")`` mesh of a ``units_x`` x ``units_y`` PE-array
    grid.

    With a process group up, one rank per position (:func:`make_mesh`);
    without one, every position on ``device`` (shards run in turn there).
    ``gx`` is the contraction-dim partition whose partial sums add, ``gy``
    the output-column partition (see ``repro_torch.backends.grid``).
    """
    units_x, units_y = int(units_x), int(units_y)
    if units_x < 1 or units_y < 1:
        raise ValueError(f"grid must be >= 1x1, got {units_x}x{units_y}")
    if distributed():
        return make_mesh((units_x, units_y), ("gx", "gy"), device)
    return Mesh((units_x, units_y), ("gx", "gy"),
                (torch.device(device),) * (units_x * units_y))


def grid_mesh(units_x: int, units_y: int) -> Mesh | None:
    """The distributed mesh a ``units_x`` x ``units_y`` grid backend executes
    on, built once per process group (every rank builds it at its first
    grid call, in the same order); None without a process group (the shards
    then run in turn on the operands' device)."""
    if not distributed():
        return None
    key = (int(units_x), int(units_y), dist.group.WORLD)
    mesh = _GRID_MESHES.get(key)
    if mesh is None:
        mesh = _GRID_MESHES[key] = make_grid_mesh(units_x, units_y)
    return mesh


def make_pipeline_mesh(n_stages: int, device="cuda") -> Mesh:
    """The ``("pod",)`` mesh of an ``n_stages``-stage layer pipeline
    (``repro_torch.launch.pipeline``).

    With a process group up, one rank per stage (:func:`make_mesh`: the
    world size must be ``n_stages``); without one, every stage on
    ``device`` (the stages run in turn there)."""
    n_stages = int(n_stages)
    if n_stages < 1:
        raise ValueError(f"a pipeline needs >= 1 stage, got {n_stages}")
    if distributed():
        return make_mesh((n_stages,), ("pod",), device)
    return Mesh((n_stages,), ("pod",), (torch.device(device),) * n_stages)
