"""Derived halo quantities from a sorted 2*Rvir gather — kdVcirc +
kdMassProfile (port of so_tpu/engine/derived.py).

  - 8 circular-velocity bins at (0.25..2.0)*Rvir: Vc = sqrt(G M(<r)/r),
    mass strictly inside each bin radius; the last bin uses the whole
    2*Rvir gather (kd2.c:508-532)
  - quarter/half-mass radii: distance of the first sorted particle where
    cumulative mass reaches {0.25, 0.5}*Mvir (kd2.c:537-546)
  - Vmax/Rmax: max of sqrt(G M(<r)/r) from the nMembers-th particle on,
    earliest maximum (kd2.c:549-569)
  - 16 cumulative per-species mass-profile bins at (2/16..2.0)*Rvir
    (kdMassProfile, kd2.c:458-496)

Every cumulative mass is the serial f32 sum (kernel K2), or the shared
uniform-mass ladder when every particle mass is the same f32 value.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..io.tipsy import MARK
from ..ops.gather import footprint, slab_gather
from ..ops.ieee import sqrt_rn
from ..ops.seqsum import seq_cumsum
from .solver import (FUSED_SLOT_BUDGET, _chunk_for, _k_limit,
                     _pick_level_span, _row_ladder, _uniform_cum,
                     first_true)

NVCIRC = 8          # kd2.h:10
NMASSPROFILE = 16   # kd2.h:12


@dataclass
class DerivedResult:
    vcirc: np.ndarray     # (G, NVCIRC) f32
    rmass: np.ndarray     # (G, 2) f32 — quarter/half mass radii
    rmax: np.ndarray      # (G,) f32
    vmax: np.ndarray      # (G,) f32
    profiles: dict        # species -> (G, NMASSPROFILE) f32

    @classmethod
    def zeros(cls, G: int, species: tuple) -> "DerivedResult":
        return cls(vcirc=np.zeros((G, NVCIRC), np.float32),
                   rmass=np.zeros((G, 2), np.float32),
                   rmax=np.zeros(G, np.float32),
                   vmax=np.zeros(G, np.float32),
                   profiles={sp: np.zeros((G, NMASSPROFILE), np.float32)
                             for sp in species})

    def fill(self, part: np.ndarray, ok: np.ndarray, der: dict) -> None:
        """Rows ``part[ok]`` from one dispatch's derived_from_sorted dict
        (device tensors over ``part``)."""
        idx = part[ok]
        for f in ("vcirc", "rmass", "rmax", "vmax"):
            getattr(self, f)[idx] = der[f].cpu().numpy()[ok]
        for sp, v in self.profiles.items():
            v[idx] = der["profiles"][sp].cpu().numpy()[ok]


def derived_from_sorted(d2_s, mass_s, ptype_s, mark_s, n_in, rvir, mvir,
                        fball, n_members: int, species: tuple, grav: float,
                        uniform_m: float | None = None, lad=None) -> dict:
    """All kdVcirc/kdMassProfile quantities from distance-sorted hits.
    ``mass_s`` may be None on uniform-mass grids (the ladder gives every
    cumulative mass; species profiles sample it at exact selection
    counts; ``lad`` as in solver._uniform_cum). ``grav`` must be
    f32-representable."""
    B, K = d2_s.shape
    dev = d2_s.device
    slot = torch.arange(K, device=dev)[None, :]
    valid = slot < n_in[:, None]
    rows = torch.arange(B, device=dev)
    zero = torch.zeros((), device=dev)
    if uniform_m is not None:
        cum, lad = _uniform_cum(uniform_m, K, n_in, valid, lad)
    else:
        # C-order f32 (kd2.c:521, 543), K2
        cum = seq_cumsum(mass_s, n_valid=n_in)

    def cum_at(counts, c):
        return torch.where(counts > 0, c[rows, torch.clamp(counts - 1, min=0)],
                           zero)

    total_mass = cum_at(n_in, cum)

    # Vc bins (kd2.c:508-532): strict d2 < r^2 cumulative mass
    vcs = []
    for i in range(NVCIRC - 1):
        r = float(np.float32((i + 1) * (2.0 / NVCIRC))) * rvir
        cnt = (valid & (d2_s < (r * r)[:, None])).sum(dim=1)
        vcs.append(sqrt_rn(grav * cum_at(cnt, cum) / r))
    vcs.append(sqrt_rn(grav * total_mass / fball))
    vcirc = torch.stack(vcs, dim=1)

    # quarter/half mass radii (kd2.c:537-546), clamped to the last hit
    rmass = []
    for f in (0.25, 0.5):
        has, jq = first_true(cum >= (f * mvir)[:, None])
        jq = torch.where(has, jq, torch.clamp(n_in - 1, min=0))
        rmass.append(sqrt_rn(d2_s[rows, jq]))
    rmass = torch.stack(rmass, dim=1)

    # Vmax/Rmax (kd2.c:549-569): earliest maximum from the nMembers-th hit
    r_s = sqrt_rn(d2_s)
    vc_all = sqrt_rn(grav * cum / r_s)
    vc_all = torch.where((slot >= n_members - 1) & valid, vc_all,
                         torch.full_like(vc_all, -torch.inf))
    jm = torch.argmax(vc_all, dim=1)     # the first maximum, as jnp.argmax
    vmax = vc_all[rows, jm]
    rmax = r_s[rows, jm]
    none = ~torch.isfinite(vmax)
    vmax = torch.where(none, zero, vmax)
    rmax = torch.where(none, zero, rmax)

    # species mass profiles (kdMassProfile, kd2.c:458-496)
    bin_cnts = []
    for i in range(NMASSPROFILE - 1):
        r = float(np.float32((i + 1) * (2.0 / NMASSPROFILE))) * rvir
        bin_cnts.append((valid & (d2_s < (r * r)[:, None])).sum(dim=1))
    bin_cnts.append(n_in)                   # last bin: everything <= 2 Rvir
    profs = {}
    for sp in species:
        sel = mark_s if sp == MARK else (ptype_s == sp)
        if uniform_m is not None:
            # ladder at the exact count of selected hits in the prefix
            selcnt = torch.cumsum((sel & valid).long(), dim=1)
            bins = []
            for cnt in bin_cnts:
                sc = torch.where(cnt > 0,
                                 selcnt[rows, torch.clamp(cnt - 1, min=0)],
                                 torch.zeros_like(cnt))
                bins.append(torch.where(sc > 0, lad[torch.clamp(sc - 1, min=0)],
                                        zero))
        else:
            cumsp = seq_cumsum(torch.where(sel, mass_s, zero),
                                n_valid=n_in)
            bins = [cum_at(cnt, cumsp) for cnt in bin_cnts]
        profs[sp] = torch.stack(bins, dim=1)

    return dict(vcirc=vcirc, rmass=rmass, rmax=rmax, vmax=vmax,
                profiles=profs)


def _derived_stage(grid, level: int, K: int, S: int, n_members: int,
                   species: tuple, centers, rvir, mvir, grav: float):
    """One capacity tier of compute_derived: (derived dict, overflow)."""
    fball = 2.0 * rvir
    um = grid.uniform_mass
    chans = ((() if um is not None else ("mass",))
             + (("meta",) if species else ()))
    sg = slab_gather(grid, level, centers, fball, fball * fball, K, S,
                     channels=chans)
    if species:
        meta = sg.channels[-1].to(torch.int32)
        ptype_s, mark_s = meta & 0xF, (meta >> 4) > 0
    else:
        ptype_s = torch.zeros_like(sg.d2, dtype=torch.int32)
        mark_s = torch.zeros_like(sg.d2, dtype=torch.bool)
    der = derived_from_sorted(sg.d2, None if um is not None
                              else sg.channels[0], ptype_s, mark_s, sg.n_in,
                              rvir, mvir, fball, n_members, species, grav,
                              uniform_m=um, lad=_row_ladder(grid, K))
    return der, sg.overflow


# (halo, cell) pairs one footprint probe holds: cell_ranges keeps ~15
# int64 tensors of that many entries at once (8 GB at 2^26)
FOOTPRINT_PAIRS = 1 << 26


def probe_capacities(grid, centers: np.ndarray, fball: np.ndarray,
                     todo: np.ndarray) -> np.ndarray:
    """(G,) i64 first capacities of the halos ``todo``: each one's exact
    slab footprint (gather.footprint, an enumeration-only pass) at one
    level and cube side for all of them, rounded up to a power of two (at
    least 256); 0 elsewhere. The probe runs in chunks of halos, each at
    most FOOTPRINT_PAIRS (halo, cell) pairs."""
    dev = grid.device
    g0, S0 = _pick_level_span(grid, float(fball[todo].max()))
    step = max(1, FOOTPRINT_PAIRS // S0 ** 3)
    foot = np.concatenate([
        footprint(grid, g0, torch.as_tensor(centers[part], device=dev),
                  torch.as_tensor(fball[part], device=dev), S0).cpu().numpy()
        for part in (todo[lo:lo + step] for lo in range(0, todo.size, step))])
    need_cap = np.zeros(centers.shape[0], np.int64)
    need_cap[todo] = 2 ** np.ceil(np.log2(np.maximum(foot, 256))).astype(
        np.int64)
    return need_cap


def ball_rounds(grid, centers: np.ndarray, fball: np.ndarray,
                todo: np.ndarray, stage, need_cap=None) -> None:
    """Dispatch the halos ``todo`` at their 2*Rvir balls ``fball``, with
    capacities from probe_capacities (or ``need_cap``, (G,) first
    capacities); a halo whose dispatch level needs more slots overflows
    and retries at 4x. ``stage(part, level, K, S)`` gathers one dispatch,
    keeps the results of the rows that did not overflow, and returns the
    host overflow mask."""
    kl = _k_limit(grid)
    need_cap = (probe_capacities(grid, centers, fball, todo)
                if need_cap is None else np.array(need_cap, np.int64))
    rounds = 0
    while todo.size:
        rounds += 1
        if rounds > 64:
            raise RuntimeError("2*Rvir gather escalation runaway")
        next_todo = []
        for capacity in np.unique(need_cap[todo]):
            sel = todo[need_cap[todo] == capacity]
            K = int(min(capacity, max(512, kl)))
            level, S = _pick_level_span(grid, float(fball[sel].max()))
            chunk = _chunk_for(grid.parts * K, FUSED_SLOT_BUDGET)
            for lo in range(0, sel.size, chunk):
                part = sel[lo:lo + chunk]
                ovf = stage(part, level, K, S)
                need_cap[part[ovf]] = np.minimum(need_cap[part[ovf]] * 4,
                                                 2 * kl)
                next_todo.append(part[ovf])
        todo = np.concatenate(next_todo)


def compute_derived(grid, centers: np.ndarray, rvir: np.ndarray,
                    mvir: np.ndarray, j_interior: np.ndarray,
                    eligible: np.ndarray, n_members: int = 8,
                    species: tuple = (), grav: float = 1.0) -> DerivedResult:
    """Derived quantities for the eligible halos from a K1/K3 gather at
    2*Rvir (zeros elsewhere): the checkpoint-resume path, where member
    lists come from the saved state and only this pass runs on the card.

    ``j_interior`` (the interior counts) is so_tpu's first-capacity hint
    and is not read: ball_rounds sizes each ball from its exact footprint,
    so no result depends on it."""
    G = centers.shape[0]
    out = DerivedResult.zeros(G, species)
    todo = np.nonzero(eligible)[0]
    if todo.size == 0:
        return out
    dev = grid.device
    centers = np.asarray(centers, np.float32)
    rvir = np.asarray(rvir, np.float32)
    mvir = np.asarray(mvir, np.float32)
    grav = float(np.float32(grav))

    def stage(part, level, K, S):
        def dev_t(a):
            return torch.as_tensor(a[part], device=dev)

        der, ovf = _derived_stage(grid, level, K, S, n_members, species,
                                  dev_t(centers), dev_t(rvir), dev_t(mvir),
                                  grav)
        ovf = ovf.cpu().numpy()
        out.fill(part, ~ovf, der)
        return ovf

    ball_rounds(grid, centers, (np.float32(2.0) * rvir).astype(np.float32),
                todo, stage)
    return out
