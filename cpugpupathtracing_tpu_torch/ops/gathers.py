"""Row lookups in small tables (the JAX package's ops/gathers.py).

The JAX function replaces a per-lane gather with a chain of broadcast
compares and selects, because the TPU's per-lane gather is slow
(ops/gathers.py:1-13 there).  A GPU gathers well, so here it is one
clamped index: the same rows bit for bit, for every table size.  The
reference's equivalents are plain pointer lookups
(data.materials[mat_index], Source/Main.cpp:336).
"""

from __future__ import annotations

import torch


def select_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] for a (K, ...) table and (N,) integer lanes: (N, ...)
    rows, with idx clamped to [0, K - 1] as the JAX function clamps it.
    Raises on an empty table."""
    k = table.shape[0]
    if k == 0:
        raise ValueError("select_rows on an empty table")
    return table[torch.clamp(idx, 0, k - 1).long()]
