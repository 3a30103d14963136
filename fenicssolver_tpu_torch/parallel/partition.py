"""Geometric mesh partitioning (port of ``fenicssolver_tpu/parallel/partition.py``).

Recursive coordinate bisection over cell midpoints, in host numpy:
deterministic, cheap, and spatially compact, so each shard's scatter-add
touches a bounded slice of the dof vector.  The arrays equal the
reference's for the same mesh.
"""

from __future__ import annotations

import numpy as np


def partition_cells(mesh, n_parts):
    """Assign each cell to one of n_parts by recursive coordinate bisection.

    Returns (part (nc,) int array, parts list of cell-index arrays padded to
    equal length with -1)."""
    mids = mesh.midpoints("cell")
    nc = mids.shape[0]
    part = np.zeros(nc, dtype=np.int32)

    def bisect(idx, parts_left, base):
        if parts_left == 1:
            part[idx] = base
            return
        left_parts = parts_left // 2
        frac = left_parts / parts_left
        spans = mids[idx].max(axis=0) - mids[idx].min(axis=0)
        axis = int(np.argmax(spans))
        order = np.argsort(mids[idx, axis], kind="stable")
        cut = int(round(len(idx) * frac))
        bisect(idx[order[:cut]], left_parts, base)
        bisect(idx[order[cut:]], parts_left - left_parts, base + left_parts)

    bisect(np.arange(nc), n_parts, 0)
    counts = np.bincount(part, minlength=n_parts)
    pad = int(counts.max())
    parts = np.full((n_parts, pad), -1, dtype=np.int32)
    for p in range(n_parts):
        ids = np.nonzero(part == p)[0]
        parts[p, : len(ids)] = ids
    return part, parts
