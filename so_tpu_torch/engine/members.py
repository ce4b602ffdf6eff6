"""Group mean velocity from interior member lists (port of the host half of
so_tpu/engine/members.py).

The reference computes the mass-weighted mean velocity over the j
interior particles of each solved group (_VcmParticles, kd2.c:595-609).
This is THE accumulation order of every vcm (docs/PARITY.md #8): a
per-halo sequential float64 sum over the distance-sorted member list
(np.add.reduceat), so each halo's result depends only on its own list.
"""

from __future__ import annotations

import numpy as np


def member_mv_sums(vel, mass, rows: np.ndarray,
                   counts: np.ndarray) -> np.ndarray:
    """(G, 3) f64 per-halo sequential sums of m*v over concatenated member
    rows. ``vel`` (N, 3) and ``mass`` (N,) are per-particle host arrays;
    the f32 product m*v is formed on member rows only (bit-identical: the
    elementwise multiply commutes with the gather)."""
    counts = np.asarray(counts, np.int64)
    sums = np.zeros((counts.shape[0], 3), np.float64)
    nz = counts > 0
    if nz.any():
        mv_rows = (np.asarray(vel, np.float32)[rows]
                   * np.asarray(mass, np.float32)[rows, None])
        seg_starts = (np.cumsum(counts) - counts)[nz]
        sums[nz] = np.add.reduceat(mv_rows.astype(np.float64), seg_starts,
                                   axis=0)
    return sums


def vcm_from_members(vel, mass, rows: np.ndarray, counts: np.ndarray,
                     mvir: np.ndarray) -> np.ndarray:
    """Group mean velocity from concatenated member rows (halo-major,
    ascending distance within each halo): the f64 member sums over Mvir."""
    sums = member_mv_sums(vel, mass, rows, counts)
    return (sums / np.maximum(np.asarray(mvir, np.float64)[:, None], 1e-300)
            ).astype(np.float32) * (np.asarray(counts, np.int64) > 0)[:, None]
