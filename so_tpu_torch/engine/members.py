"""Interior-member extraction and group mean velocity (port of
so_tpu/engine/members.py).

The reference tags the j strictly-interior particles of each solved group
in ascending-distance order (kdTagParticles call site, kd2.c:823) and
computes the mass-weighted mean velocity over the same j particles
(_VcmParticles, kd2.c:595-609). The pipeline takes the lists from the
fused pass (engine/fused.py); ``extract_members`` is the standalone pass,
one sorted gather at each halo's d2cut.

vcm's accumulation order is the same everywhere (docs/PARITY.md #8): a
per-halo sequential float64 sum over the distance-sorted member list
(np.add.reduceat), so each halo's result depends only on its own list.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.gather import slab_gather
from ..ops.grid import CellGrid
from .derived import ball_rounds


def member_mv_sums(mvh, rows: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """(G, 3) f64 per-halo sequential sums of m*v over concatenated member
    rows. ``mvh`` is the per-particle m*v on the host, a dense (N, 3) f32
    array or the ``(vel, mass)`` pair; the pair's f32 product m*v is
    formed on member rows only, bit-identical to the dense form (the
    elementwise multiply commutes with the gather)."""
    counts = np.asarray(counts, np.int64)
    sums = np.zeros((counts.shape[0], 3), np.float64)
    nz = counts > 0
    if nz.any():
        if isinstance(mvh, tuple):
            vel, mass = mvh
            mv_rows = (np.asarray(vel, np.float32)[rows]
                       * np.asarray(mass, np.float32)[rows, None])
        else:
            mv_rows = np.asarray(mvh, np.float32)[rows]
        seg_starts = (np.cumsum(counts) - counts)[nz]
        sums[nz] = np.add.reduceat(mv_rows.astype(np.float64), seg_starts,
                                   axis=0)
    return sums


def vcm_from_sums(sums: np.ndarray, counts: np.ndarray,
                  mvir: np.ndarray) -> np.ndarray:
    """Group mean velocity from the (G, 3) f64 member sums: the sums over
    Mvir in f64, rounded once to f32 (0 for an empty list)."""
    return (sums / np.maximum(np.asarray(mvir, np.float64)[:, None], 1e-300)
            ).astype(np.float32) * (np.asarray(counts, np.int64) > 0)[:, None]


def vcm_from_members(mvh, rows: np.ndarray, counts: np.ndarray,
                     mvir: np.ndarray) -> np.ndarray:
    """Group mean velocity from concatenated member rows (halo-major,
    ascending distance within each halo): the f64 member sums of ``mvh``
    (member_mv_sums' dense m*v or ``(vel, mass)`` pair) over Mvir."""
    return vcm_from_sums(member_mv_sums(mvh, rows, counts), counts, mvir)


def _members_stage(grid, level: int, K: int, S: int, centers, cover, d2cut,
                   j):
    """One capacity tier: (member file indices, halo-major in ascending
    distance; per-halo counts; overflow), on the grid's device. The ball is
    d2 <= d2cut, so its sorted prefix of j rows is the interior."""
    sg = slab_gather(grid, level, centers, cover, d2cut, K, S,
                     channels=("orig",))
    slot = torch.arange(sg.d2.shape[1], device=sg.d2.device)[None, :]
    interior = (slot < j[:, None]) & (slot < sg.n_in[:, None])
    return sg.channels[0][interior], interior.sum(dim=1), sg.overflow


def extract_members(grid, centers: np.ndarray, d2cut: np.ndarray,
                    j: np.ndarray, mvir: np.ndarray, cap_hint=None,
                    host_mv=None):
    """Per halo: its interior as file-order indices in ascending distance
    (length j; ties at d2cut cut at j, as the reference's walk stops at j,
    kd2.c:663-670) and the group mean velocity, (list, (G, 3) f32).

    Each halo is gathered at its d2cut through the port's sorted gather,
    dispatched by derived.ball_rounds: first capacities from the exact
    footprints or, with ``cap_hint`` (SolveResult.kcap), the capacity that
    resolved the halo (at least 512), x4 on overflow. A parallel.mesh
    ShardedGrid is merged at the gather seam. ``host_mv`` is the
    per-particle m*v in file order, a dense (N, 3) f32 array or the
    ``(vel, mass)`` pair; None reads the pair from the grid (a ShardedGrid's
    shards through parallel.mesh.host_mv_from_sharded, which refuses one
    rank's part of a --distributed grid)."""
    G = centers.shape[0]
    out: list[np.ndarray | None] = [None] * G
    if G == 0:
        return out, np.zeros((0, 3), np.float32)
    if host_mv is None and not isinstance(grid, CellGrid):
        from ..parallel.mesh import host_mv_from_sharded

        host_mv = host_mv_from_sharded(grid)
    if host_mv is None:
        oi = grid.orig_idx.cpu().numpy()
        vel = np.empty((grid.n, 3), np.float32)
        mass = np.empty(grid.n, np.float32)
        vel[oi] = grid.vel_a().cpu().numpy()
        mass[oi] = grid.mass_a().cpu().numpy()
        host_mv = (vel, mass)
    centers = np.asarray(centers, np.float32)
    d2cut = np.asarray(d2cut, np.float32)
    j = np.asarray(j, np.int64)
    mvir = np.asarray(mvir, np.float32)
    # the walk's radius: just past sqrt(d2cut), so every cell holding a
    # particle at d2 <= d2cut is enumerated (so_tpu's cover)
    cover = np.sqrt(d2cut.astype(np.float64)).astype(np.float32)
    cover = np.nextafter(cover, np.float32(np.inf)) * np.float32(1.0 + 1e-6)
    dev = grid.device

    def stage(part, level, K, S):
        def dev_t(a):
            return torch.as_tensor(a[part], device=dev)

        rows, counts, ovf = _members_stage(grid, level, K, S,
                                           dev_t(centers), dev_t(cover),
                                           dev_t(d2cut), dev_t(j))
        ovf = ovf.cpu().numpy()
        pieces = np.split(rows.cpu().numpy(),
                          np.cumsum(counts.cpu().numpy())[:-1])
        for i in np.nonzero(~ovf)[0]:
            out[part[i]] = pieces[i]
        return ovf

    need_cap = (None if cap_hint is None
                else np.maximum(np.asarray(cap_hint, np.int64), 512))
    ball_rounds(grid, centers, cover, np.arange(G), stage, need_cap)
    counts = np.array([lst.size for lst in out], np.int64)
    rows = (np.concatenate(out) if counts.sum()
            else np.zeros(0, np.int64))
    return out, vcm_from_members(host_mv, rows, counts, mvir)
