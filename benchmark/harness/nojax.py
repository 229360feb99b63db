"""The run's guard against JAX: which forbidden packages the process holds.

Module names are compared by their top-level name (the part before the
first dot) whole, so ``zigflac_tpu_torch`` is not ``zigflac_tpu``.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "zigflac_tpu"})


def loaded(modules=None) -> list:
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)
