"""The benchmark measures the port alone: no JAX and no reference package.

Module names are compared by their top-level name (the part before the
first dot) whole, so ``repro_torch`` is not ``repro``.
"""

from __future__ import annotations

import sys

__all__ = ["FORBIDDEN", "forbidden_loaded"]

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden_loaded(modules=None) -> list[str]:
    """The forbidden top-level names among ``modules`` (``sys.modules``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.partition(".")[0] for m in names} & FORBIDDEN)
