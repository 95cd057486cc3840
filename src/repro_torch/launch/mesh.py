"""Device meshes: which device each position of a logical grid runs on.

The port runs on one card.  A PE-array grid (``repro_torch.backends.grid``)
still has ``units_x`` x ``units_y`` positions, and :func:`make_grid_mesh`
maps every one of them to the single device the operands live on, so
``GridBackend.execute`` runs its shards one after another there and adds
the partial sums explicitly.  This is the seam where ``torch.distributed``
goes later: a mesh whose positions name different devices (one process per
card, partial sums reduced by a collective).

Meshes that need one device per position — the production pod meshes of
``launch/train.py --mesh pod|multipod``, or any :func:`make_mesh` of more
than one position — raise ``NotImplementedError`` (ROADMAP Queue 1 item 6,
multi-device meshes).
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["Mesh", "make_production_mesh", "make_mesh", "make_grid_mesh"]

_MULTI_DEVICE_MSG = ("needs one device per position, which the port does not "
                     "have yet (ROADMAP Queue 1 item 6, multi-device meshes)")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A named grid of positions, each placed on a device.

    ``shape`` / ``axes`` — the grid and its axis names; ``devices`` — one
    ``torch.device`` per position, row-major over ``shape``.
    """

    shape: tuple[int, ...]
    axes: tuple[str, ...]
    devices: tuple[torch.device, ...]

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

    def device_of(self, coord: tuple[int, ...]) -> torch.device:
        """The device position ``coord`` runs on."""
        flat = 0
        for c, s in zip(coord, self.shape):
            if not 0 <= c < s:
                raise IndexError(f"position {coord} outside mesh {self.shape}")
            flat = flat * s + c
        return self.devices[flat]


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's 16x16 (256 chips) or 2x16x16 (512 chips) training
    mesh: refused on one card."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device="cuda") -> Mesh:
    """A mesh with one device per position; only a one-position mesh exists
    on one card, anything larger raises ``NotImplementedError``."""
    shape = tuple(int(s) for s in shape)
    if math.prod(shape) != 1:
        raise NotImplementedError(f"a {'x'.join(map(str, shape))} mesh "
                                  f"{_MULTI_DEVICE_MSG}")
    return Mesh(shape, tuple(axes), (torch.device(device),))


def make_grid_mesh(units_x: int, units_y: int, device="cuda") -> Mesh:
    """The ``("gx", "gy")`` mesh of a ``units_x`` x ``units_y`` PE-array
    grid, every position on ``device``.

    ``gx`` is the contraction-dim partition whose partial sums add, ``gy``
    the output-column partition (see ``repro_torch.backends.grid``).
    """
    units_x, units_y = int(units_x), int(units_y)
    if units_x < 1 or units_y < 1:
        raise ValueError(f"grid must be >= 1x1, got {units_x}x{units_y}")
    return Mesh((units_x, units_y), ("gx", "gy"),
                (torch.device(device),) * (units_x * units_y))

