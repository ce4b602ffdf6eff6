"""Fused member-extraction + derived-quantity pass (port of
so_tpu/engine/fused.py).

The reference re-gathers every solved group twice: kdTagParticles walks
the j interior particles (kd2.c:823) and kdVcirc re-gathers at 2*Rvir
(kd2.c:511-514). The interior is a prefix of the distance-sorted 2*Rvir
ball, so ONE gather at 2*Rvir with (mass, meta, orig) channels yields both:
the derived quantities (derived_from_sorted) and the member lists (the
first j sorted rows of each halo, as file-order indices: the "orig"
channel; those rows are the ball's hits at d2 <= d2cut, the solve's d2
at row j - 1, and the mask reads both bounds). vcm is computed on the
host from the member rows (members.vcm_from_members, or an injected
vcm_fn under --distributed).

Derived quantities are computed for every solved group; the pipeline
zeroes the rows of groups slurped during their own tagging (kd2.c:884)
after the conflict pass.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.gather import slab_gather
from ..ops.grid import CellGrid
from ..profiling import counts, span
from .derived import (DerivedResult, ball_rounds, derived_from_sorted,
                      probe_capacities)
from .members import vcm_from_members
from .solver import _row_ladder


def _fused_stage(grid: CellGrid, level: int, K: int, S: int,
                 n_members: int, species: tuple, centers, rvir, d2cut, j,
                 mvir, grav: float):
    """One capacity tier. Returns (member original indices, concatenated
    halo-major in ascending distance; per-halo member counts; derived
    dict; overflow), all on the grid's device."""
    fball = 2.0 * rvir
    um = grid.uniform_mass
    chans = ((() if um is not None else ("mass",))
             + (("meta",) if species else ()) + ("orig",))
    sg = slab_gather(grid, level, centers, fball, fball * fball, K, S,
                     channels=chans)
    d2_s = sg.d2
    mass_s = None if um is not None else sg.channels[0]
    if species:
        meta = sg.channels[-2].to(torch.int32)
        ptype_s, mark_s = meta & 0xF, (meta >> 4) > 0
    else:
        ptype_s = torch.zeros_like(d2_s, dtype=torch.int32)
        mark_s = torch.zeros_like(d2_s, dtype=torch.bool)
    orig = sg.channels[-1]
    der = derived_from_sorted(d2_s, mass_s, ptype_s, mark_s, sg.n_in, rvir,
                              mvir, fball, n_members, species, grav,
                              uniform_m=um, lad=_row_ladder(grid, K))
    # interior members: the first j sorted rows, all at d2 <= d2cut (the
    # solve's d2 at row j - 1 lies inside its own Rvir < 2*Rvir) — a PREFIX
    # of each row, so a boolean-mask compaction keeps halo-major,
    # ascending-distance order
    slot = torch.arange(d2_s.shape[1], device=d2_s.device)[None, :]
    interior = ((slot < j[:, None]) & (d2_s <= d2cut[:, None])
                & (orig >= 0))
    counts = interior.sum(dim=1)
    return orig[interior], counts, der, sg.overflow


def members_and_derived(grid: CellGrid, centers: np.ndarray,
                        rvir: np.ndarray, d2cut: np.ndarray, j: np.ndarray,
                        mvir: np.ndarray, host_mv, n_members: int = 8,
                        species: tuple = (), grav: float = 1.0, vcm_fn=None,
                        member_filter=None):
    """One fused pass over the solved halos: (members, vcm, DerivedResult).

    Dispatches follow derived.ball_rounds (capacities from the exact
    footprints of the 2*Rvir balls, x4 on overflow). ``d2cut`` and ``j``
    are the solve's: the members are the first j rows, at d2 <= d2cut.
    ``host_mv`` is the per-particle m*v in original file order, a dense
    (N, 3) f32 array or the ``(vel, mass)`` pair (members.member_mv_sums).

    ``vcm_fn(rows, counts, mvir_rows) -> (n, 3) f32`` takes the place of
    members.vcm_from_members over ``host_mv``, which is then not read (a
    --distributed rank holds its segment only: parallel.driver.dist_vcm_fn
    merges per-segment partials). ``member_filter(rows)`` maps each halo's
    full member array to what is kept of it (parallel.driver.
    seg_member_filter: the rank's segment rows with their ranks), so no
    rank keeps every member list.

    Spans: fused.probe (the footprints that size the first capacities)
    and a fused.dispatch a stage, with fused.gather (the stage's enqueue),
    fused.fetch (its three fetches), fused.fill (derived.fill), fused.split
    (the member lists) and fused.vcm. Counts: fused.dispatches,
    fused.halo_gathers (halos over all dispatches) and fused.member_rows
    (the member rows fetched to the host, an overflowed dispatch's too).
    """
    G = centers.shape[0]
    dev = grid.device
    vcm = np.zeros((G, 3), np.float32)
    out_members: list[np.ndarray | None] = [None] * G
    derived = DerivedResult.zeros(G, species)
    if G == 0:
        return out_members, vcm, derived
    centers = np.asarray(centers, np.float32)
    rvir = np.asarray(rvir, np.float32)
    d2cut = np.asarray(d2cut, np.float32)
    j = np.asarray(j, np.int64)
    mvir = np.asarray(mvir, np.float32)
    grav = float(np.float32(grav))

    def stage(part, level, K, S):
        def dev_t(a):
            return torch.as_tensor(a[part], device=dev)

        with span("fused.dispatch"):
            counts[("fused.dispatches",)] += 1
            counts[("fused.halo_gathers",)] += int(part.size)
            with span("fused.gather"):
                mem, counts_t, der, ovf = _fused_stage(
                    grid, level, K, S, n_members, species, dev_t(centers),
                    dev_t(rvir), dev_t(d2cut), dev_t(j), dev_t(mvir), grav)
            with span("fused.fetch"):
                ovf = ovf.cpu().numpy()
                n_mem = counts_t.cpu().numpy()
                rows64 = mem.cpu().numpy()
            counts[("fused.member_rows",)] += int(rows64.size)
            ok = ~ovf
            with span("fused.fill"):
                derived.fill(part, ok, der)
            with span("fused.split"):
                pieces = np.split(rows64, np.cumsum(n_mem)[:-1])
                for i in np.nonzero(ok)[0]:
                    out_members[part[i]] = (pieces[i] if member_filter is None
                                            else member_filter(pieces[i]))
            with span("fused.vcm"):
                # group mean velocity from the member rows (_VcmParticles)
                vcm[part[ok]] = (vcm_from_members(host_mv, rows64, n_mem,
                                                  mvir[part]) if vcm_fn is None
                                 else vcm_fn(rows64, n_mem, mvir[part]))[ok]
        return ovf

    fball = (np.float32(2.0) * rvir).astype(np.float32)
    todo = np.arange(G)
    with span("fused.probe"):
        need_cap = probe_capacities(grid, centers, fball, todo)
    ball_rounds(grid, centers, fball, todo, stage, need_cap)
    return out_members, vcm, derived
