"""-pot most-bound recentring (port of so_tpu/engine/recenter.py) —
reference: kdRvir's bPot block (kd2.c:749-761).

Before the ball ladder runs, each group's center is replaced by the
position of the minimum-phi particle within radius Rgtp of the input
center. The pass reads only particle data, so it runs batched over all
halos before the solve: K1 (K3 on giant tiers) gathers the Rgtp ball
from a copy of the payload with phi in the mass row, unsorted, and an
argmin over the slots picks the particle (its position is read at the
kernel's source row, gather.POSITION). On a sharded grid each shard's
payload gets its copy, each shard reads its own candidates' positions,
and the argmin runs over the shards' merged rows (across ranks too,
under --distributed).

Ties: the reference keeps the first minimum in kd-tree order; torch's
argmin keeps the first minimum in K1's slot order, which is so_tpu's
chunk layout (on a sharded grid: (shard, slot) order). With distinct phi
the chosen particle is the same; with equal phi it may differ, as
so_tpu's may.

An empty Rgtp ball (the reference reads stale list memory there) keeps
the original center.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.gather import unsorted_gather
from ..ops.grid import CellGrid
from .solver import _dispatch_chunks, _k_limit, _pick_level_span


def _with_phi(grid: CellGrid) -> CellGrid:
    """The grid with a payload copy that holds phi in the mass row (32 B a
    particle, for this pass only)."""
    if grid.phi is None:
        raise ValueError("-pot needs particle potentials (build_grid phi=)")
    soa = grid.soa8t.clone()
    soa[3, :grid.n] = grid.phi
    return dataclasses.replace(grid, soa8t=soa)


def _recenter_stage(grid: CellGrid, level: int, K: int, S: int, centers,
                    radii):
    """(new centers, overflow) for one capacity tier on a _with_phi grid."""
    d2, ch, _, overflow = unsorted_gather(
        grid, level, centers, radii, radii * radii, K, S,
        chans=("mass", "x", "y", "z"))
    ok = torch.isfinite(d2)
    phi = torch.where(ok, ch[:, 0], torch.full_like(d2, torch.inf))
    amin = torch.argmin(phi, dim=1)       # the first minimum in slot order
    rows = torch.arange(centers.shape[0], device=centers.device)
    best = ch[rows, 1:, amin]
    found = ok.any(dim=1)
    return torch.where(found[:, None], best, centers), overflow


def recenter_most_bound(grid: CellGrid, centers: np.ndarray, rgtp: np.ndarray,
                        k0_cap: int = 4096) -> np.ndarray:
    """Most-bound centers for all halos; capacity x4 on overflow up to the
    gather-complete ceiling _k_limit. One capacity per round keeps the
    dispatches few: on the H100 this loop beats derived.ball_rounds'
    footprint-sized tiers, whose extra pass and dispatches cost more than
    the slots they save on Rgtp balls."""
    dev = grid.device
    centers = np.asarray(centers, np.float32)
    rgtp = np.asarray(rgtp, np.float32)
    out = centers.copy()
    phi_grid = grid.map_shards(_with_phi)
    kl = _k_limit(grid)
    todo = np.arange(centers.shape[0])
    capacity = k0_cap
    while todo.size:
        K = int(min(capacity, kl))
        level, S = _pick_level_span(grid, float(rgtp[todo].max()))
        still = []
        for _, part in _dispatch_chunks(todo, grid.parts * K):
            nc, ovf = _recenter_stage(
                phi_grid, level, K, S,
                torch.as_tensor(centers[part], device=dev),
                torch.as_tensor(rgtp[part], device=dev))
            ovf = ovf.cpu().numpy()
            out[part[~ovf]] = nc.cpu().numpy()[~ovf]
            still.append(part[ovf])
        todo = np.concatenate(still)
        if todo.size and K >= kl:
            raise RuntimeError("recentring overflowed the capacity ceiling")
        capacity *= 4
    return out
