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

from so_tpu.io.tipsy import MARK

from ..ops.ieee import sqrt_rn
from ..ops.seqsum import seq_cumsum
from .solver import _uniform_cum, first_true

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


def derived_from_sorted(d2_s, mass_s, ptype_s, mark_s, n_in, rvir, mvir,
                        fball, n_members: int, species: tuple, grav: float,
                        uniform_m: float | None = None) -> dict:
    """All kdVcirc/kdMassProfile quantities from distance-sorted hits.
    ``mass_s`` may be None on uniform-mass grids (the ladder gives every
    cumulative mass; species profiles sample it at exact selection
    counts). ``grav`` must be f32-representable."""
    B, K = d2_s.shape
    dev = d2_s.device
    slot = torch.arange(K, device=dev)[None, :]
    valid = slot < n_in[:, None]
    rows = torch.arange(B, device=dev)
    zero = torch.zeros((), device=dev)
    lad = None
    if uniform_m is not None:
        cum, lad = _uniform_cum(uniform_m, K, n_in, valid)
    else:
        cum = seq_cumsum(mass_s)        # C-order f32 (kd2.c:521, 543), K2

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
        if lad is not None:
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
            cumsp = seq_cumsum(torch.where(sel, mass_s, zero))
            bins = [cum_at(cnt, cumsp) for cnt in bin_cnts]
        profs[sp] = torch.stack(bins, dim=1)

    return dict(vcirc=vcirc, rmass=rmass, rmax=rmax, vmax=vmax,
                profiles=profs)
