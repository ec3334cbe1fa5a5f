"""The import guard: no module of JAX, nor the JAX package the port was
made from, may be loaded in a run's process.  Names are compared whole, by
their top-level part: ``ndt_2d_tpu_torch`` is not ``ndt_2d_tpu``."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "ndt_2d_tpu")


def forbidden_modules(also=()) -> list:
    """Top-level names of loaded modules that are forbidden (and those of
    ``also``), sorted."""
    banned = set(FORBIDDEN) | set(also)
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & banned)
