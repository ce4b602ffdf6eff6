"""Fused member-extraction + derived-quantity pass (port of
so_tpu/engine/fused.py).

The reference re-gathers every solved group twice: kdTagParticles walks
the j interior particles (kd2.c:823) and kdVcirc re-gathers at 2*Rvir
(kd2.c:511-514). The interior is a prefix of the distance-sorted 2*Rvir
ball, so ONE gather at 2*Rvir with (mass, meta, idx) channels yields both:
the derived quantities (derived_from_sorted) and the member lists (the
first j sorted rows of each halo). vcm is computed on the host from the
member rows (members.vcm_from_members).

Derived quantities are computed for every solved group; the pipeline
zeroes the rows of groups slurped during their own tagging (kd2.c:884)
after the conflict pass.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.gather import slab_gather
from ..ops.grid import CellGrid
from .derived import DerivedResult, derived_from_sorted
from .members import vcm_from_members
from .solver import (FUSED_SLOT_BUDGET, _chunk_for, _foot_stage, _k_limit,
                     _pick_level_span)


def _fused_stage(grid: CellGrid, level: int, K: int, S: int,
                 n_members: int, species: tuple, centers, rvir, j, mvir,
                 grav: float):
    """One capacity tier. Returns (member original indices, concatenated
    halo-major in ascending distance; per-halo member counts; derived
    dict; overflow), all on the grid's device."""
    fball = 2.0 * rvir
    um = grid.uniform_mass
    chans = ((() if um is not None else ("mass",))
             + (("meta",) if species else ()) + ("idx",))
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
    srow = sg.channels[-1]
    der = derived_from_sorted(d2_s, mass_s, ptype_s, mark_s, sg.n_in, rvir,
                              mvir, fball, n_members, species, grav,
                              uniform_m=um)
    # interior members: the first j sorted rows — a PREFIX of each row, so
    # a boolean-mask compaction keeps halo-major, ascending-distance order
    slot = torch.arange(K, device=d2_s.device)[None, :]
    interior = (slot < j[:, None]) & torch.isfinite(d2_s) & (srow >= 0)
    counts = interior.sum(dim=1)
    members = grid.orig_idx[srow[interior].long()]
    return members, counts, der, sg.overflow


def members_and_derived(grid: CellGrid, centers: np.ndarray,
                        rvir: np.ndarray, j: np.ndarray, mvir: np.ndarray,
                        host_mv, n_members: int = 8, species: tuple = (),
                        grav: float = 1.0):
    """One fused pass over the solved halos: (members, vcm, DerivedResult).

    Capacities come from the exact per-halo slab footprints of the 2*Rvir
    balls (one enumeration-only pass, _foot_stage); a halo whose
    dispatch level needs more slots overflows and retries at 4x.
    ``host_mv`` is the ``(vel, mass)`` pair of per-particle host arrays
    in original file order.
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
    j = np.asarray(j, np.int64)
    mvir = np.asarray(mvir, np.float32)
    grav = float(np.float32(grav))
    kl = _k_limit(grid)

    fball = (np.float32(2.0) * rvir).astype(np.float32)
    g0, S0 = _pick_level_span(grid, float(fball.max()))
    foot = _foot_stage(grid, g0, S0, torch.as_tensor(centers, device=dev),
                       torch.as_tensor(fball, device=dev)).cpu().numpy()
    need_cap = 2 ** np.ceil(np.log2(np.maximum(foot, 256))).astype(np.int64)

    todo = np.arange(G)
    rounds = 0
    while todo.size:
        rounds += 1
        if rounds > 64:
            raise RuntimeError("fused member/derived escalation runaway")
        next_todo = []
        for capacity in np.unique(need_cap[todo]):
            sel = todo[need_cap[todo] == capacity]
            K = int(min(capacity, max(512, kl)))
            level, S = _pick_level_span(grid, float(fball[sel].max()))
            chunk = _chunk_for(K, FUSED_SLOT_BUDGET)
            for lo in range(0, sel.size, chunk):
                part = sel[lo:lo + chunk]

                def dev_t(a):
                    return torch.as_tensor(a[part], device=dev)

                mem, counts, der, ovf = _fused_stage(
                    grid, level, K, S, n_members, species, dev_t(centers),
                    dev_t(rvir), dev_t(j), dev_t(mvir), grav)
                ovf = ovf.cpu().numpy()
                counts = counts.cpu().numpy()
                rows64 = mem.cpu().numpy()
                okm = ~ovf
                idx = part[okm]
                derived.vcirc[idx] = der["vcirc"].cpu().numpy()[okm]
                derived.rmass[idx] = der["rmass"].cpu().numpy()[okm]
                derived.rmax[idx] = der["rmax"].cpu().numpy()[okm]
                derived.vmax[idx] = der["vmax"].cpu().numpy()[okm]
                for sp in species:
                    derived.profiles[sp][idx] = \
                        der["profiles"][sp].cpu().numpy()[okm]
                pieces = np.split(rows64, np.cumsum(counts)[:-1])
                for i, h in enumerate(part):
                    if ovf[i]:
                        next_todo.append(h)
                    else:
                        out_members[h] = pieces[i]
                need_cap[part[ovf]] = np.minimum(need_cap[part[ovf]] * 4,
                                                 2 * kl)
                # group mean velocity from the member rows (_VcmParticles)
                vcm[idx] = vcm_from_members(*host_mv, rows64, counts,
                                            mvir[part])[okm]
        todo = np.asarray(next_todo, np.int64)
    return out_members, vcm, derived
