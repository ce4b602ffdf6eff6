"""The plain reference of a spherical-overdensity run.

Written from the reference code's semantics (SO's kd2.c: kdRvir,
kdTagParticles, kdVcirc, kdMassProfile, kdOutStats) in plain PyTorch and
NumPy. It imports nothing of the program and shares no code with it: it
takes the generated inputs and works out again everything the program
derives from them.

- The solve, the members and the derived quantities of one halo come from
  a brute-force pass: the min-image d2 of every particle to the center
  (each f32 operation rounded once), the hits of a ball sorted by d2, the
  cumulative mass a serial f32 sum (numpy's ``cumsum``), and the ladder of
  balls Rgtp * 1.2^k. Ties in d2 go in the order of the particles along a
  Morton curve of the box's cells (about 24 particles a cell, file order
  within one), the tie order the port states; ``particle_ranks`` works
  it out from the positions.
- The conflict pass is the mass-ordered subsume/slurp/retain walk, run
  over every group in the order of Numerical Recipes' ``indexx`` of the
  catalog masses (the reference's scheduler, including its tie order).
- The stats are kdOutStats' sums in float64.

``dtype`` other than float32 gives the control: the same computation with
the positions, distances and masses held in that precision; ``vcm_acc``
float32 the control of the group mean velocity's float64 sum.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

FOUR_THIRDS_PI = np.float32(4.0 / 3.0 * np.pi)
NVCIRC = 8
NMASSPROFILE = 16
DARK, GAS, STAR = 1, 2, 4


# --------------------------------------------------------------------------
# Tie order: particles along the Morton curve of the box's cells
# --------------------------------------------------------------------------

def cells_per_axis_log2(n: int) -> int:
    """The finest level of cells: about 24 particles a cell, at most 2^9
    cells an axis."""
    if n <= 1:
        return 0
    m = int(round(np.log2(max(1.0, n / 24) ** (1.0 / 3.0))))
    return int(np.clip(m, 0, 9))


def _spread_bits(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.int64) & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    return (x | (x << 2)) & 0x09249249


def particle_ranks(pos: torch.Tensor, period, center=(0.0, 0.0, 0.0)):
    """(N,) int64: each particle's place in the order of its cell's Morton
    code, file order within a cell."""
    dev = pos.device
    period = torch.as_tensor(np.asarray(period, np.float32), device=dev)
    lo = torch.as_tensor(np.asarray(center, np.float32), device=dev) \
        - period * 0.5
    n = pos.shape[0]
    nc = 1 << cells_per_axis_log2(n)
    u = pos - lo
    u = u - torch.floor(u / period) * period
    ic = torch.clip((u / period * nc).to(torch.int32), 0, nc - 1)
    code = (_spread_bits(ic[:, 0]) | (_spread_bits(ic[:, 1]) << 1)
            | (_spread_bits(ic[:, 2]) << 2))
    order = torch.argsort(code, stable=True)
    rank = torch.empty(n, dtype=torch.int64, device=dev)
    rank[order] = torch.arange(n, device=dev)
    return rank


# --------------------------------------------------------------------------
# One halo: the solve, its members and its derived quantities
# --------------------------------------------------------------------------

@dataclass
class Halo:
    code: int
    mvir: np.float32
    rvir: np.float32
    j: int
    members: np.ndarray        # file-order indices, ascending (d2, rank)
    vcm: np.ndarray            # (3,) f32
    vcirc: np.ndarray          # (NVCIRC,) f32
    rmass: np.ndarray          # (2,) f32
    rmax: np.float32
    vmax: np.float32
    profiles: dict             # species -> (NMASSPROFILE,) f32


class Particles:
    """The snapshot on the reference's device: positions, masses, species,
    velocities and the tie ranks, in ``dtype`` (float32, or the control's
    lower precision)."""

    def __init__(self, pos, mass, vel, split, period, dtype=torch.float32,
                 device="cpu", vcm_acc=np.float64):
        dev = torch.device(device)
        self.dtype = dtype
        self.vcm_acc = vcm_acc
        self.period = np.asarray(period, np.float32)
        pos_t = torch.as_tensor(np.asarray(pos, np.float32), device=dev)
        self.rank = particle_ranks(pos_t, self.period)
        self.x = [pos_t[:, a].contiguous().to(dtype) for a in range(3)]
        del pos_t
        self.mass = torch.as_tensor(np.asarray(mass, np.float32), device=dev)
        self.mass_np = np.asarray(mass, np.float32)
        self.vel_np = np.asarray(vel, np.float32)
        n_gas, n_dark, _ = split
        idx = np.arange(self.mass_np.shape[0])
        self.ptype = np.where(idx < n_gas, GAS,
                              np.where(idx < n_gas + n_dark, DARK, STAR))
        self.device = dev

    @property
    def n(self) -> int:
        return self.mass_np.shape[0]

    def d2_many(self, centers: np.ndarray) -> torch.Tensor:
        """(B, N): d2 as ``d2`` gives it, for B centers at once."""
        c_all = torch.as_tensor(np.asarray(centers, np.float32),
                                device=self.device).to(self.dtype)
        out = None
        for a in range(3):
            c = c_all[:, a:a + 1]
            p = torch.tensor(float(self.period[a]), dtype=self.dtype,
                             device=self.device)
            x = self.x[a][None, :]
            d = (c - p * torch.round((c - x) / p)) - x
            out = d * d if out is None else out + d * d
            del d
        return out.to(torch.float32)

    def d2(self, center) -> torch.Tensor:
        """Min-image d2 of every particle: d = (c - p*rint((c - x)/p)) - x
        per axis, then (dx*dx + dy*dy) + dz*dz, each operation rounded."""
        out = None
        for a in range(3):
            c = torch.tensor(float(center[a]), dtype=self.dtype,
                             device=self.device)
            p = torch.tensor(float(self.period[a]), dtype=self.dtype,
                             device=self.device)
            x = self.x[a]
            d = (c - p * torch.round((c - x) / p)) - x
            out = d * d if out is None else out + d * d
        return out.to(torch.float32)

    def ball(self, d2: torch.Tensor, r2: np.float32):
        """(file indices, d2) of the hits d2 <= r2, ascending (d2, rank),
        on the host."""
        idx = torch.nonzero(d2 <= float(r2)).flatten()
        dd = d2[idx]
        key = (dd.view(torch.int32).to(torch.int64) << 32) | self.rank[idx]
        o = torch.argsort(key)
        return idx[o].cpu().numpy(), dd[o].cpu().numpy()

    def cumsum(self, m: np.ndarray) -> np.ndarray:
        """Serial cumulative sum: float32, or the control's precision."""
        if self.dtype == torch.float32:
            return np.cumsum(m, dtype=np.float32)
        return torch.cumsum(torch.as_tensor(m).to(self.dtype), 0).to(
            torch.float32).numpy()


def ladder(rgtp: np.float32, period) -> list:
    """Rgtp * 1.2^k, k = 1, 2, ..., while the ball is under a quarter of
    the box diagonal (empty when Rgtp is not)."""
    p = np.asarray(period, np.float32)
    root = np.float32(np.sqrt(np.float64(p[0] * p[0] + p[1] * p[1]
                                         + p[2] * p[2])))
    cap = 0.25 * np.float64(root)
    f = np.float32(rgtp)
    radii = []
    while np.float64(f) < cap:
        f = np.float32(f * np.float32(1.2))
        radii.append(f)
    return radii


def rvir_of(mvir: np.float32, thr: float) -> np.float32:
    """fRvir = pow(fMvir / (4/3 pi Delta), 0.3333333333) as kd2.c forms
    it: the quotient in double rounded to float, the power in double."""
    denom = (4.0 / 3.0) * math.pi * float(np.float32(thr))
    r3 = np.float32(np.float64(mvir) / denom)
    return np.float32(np.power(np.float64(r3), 0.3333333333))


def _failed(code: int, species) -> Halo:
    return Halo(code, np.float32(code), np.float32(code), 0,
                members=np.zeros(0, np.int64), vcm=np.zeros(3, np.float32),
                vcirc=np.zeros(NVCIRC, np.float32),
                rmass=np.zeros(2, np.float32), rmax=np.float32(0),
                vmax=np.float32(0),
                profiles={sp: np.zeros(NMASSPROFILE, np.float32)
                          for sp in species})


def vcm_of(members: np.ndarray, vel: np.ndarray, mass: np.ndarray,
           mvir: np.float32, acc=np.float64) -> np.ndarray:
    """_VcmParticles: the f32 products m*v summed one member after the
    other in ``acc`` (float64; the control's float32), over Mvir, rounded
    to f32."""
    if members.size == 0:
        return np.zeros(3, np.float32)
    mv = (vel[members] * mass[members, None]).astype(acc)
    total = np.cumsum(mv, axis=0, dtype=acc)[-1]
    return (total / max(acc(mvir), acc(1e-300))).astype(np.float32)


def _rung(ps: Particles, idx, d2s, thr32, n_members: int):
    """The first j whose pair of densities lies below Delta in one ball
    (sorted hits ``idx``, ``d2s``), or None; and the ball's masses and
    their serial sums."""
    m = ps.mass_np[idx]
    cum = ps.cumsum(m)
    with np.errstate(divide="ignore", invalid="ignore"):
        r3 = d2s * np.sqrt(d2s)
        rho = cum / (FOUR_THIRDS_PI * r3)
    below = rho < thr32
    pair = below[:-1] & below[1:]
    pair[:max(0, n_members - 2)] = False
    hit = np.nonzero(pair)[0]
    return (int(hit[0]) if hit.size else None), m, cum


def _solved(ps: Particles, j: int, m, cum, idx, thr: float, n_members: int,
            species):
    """(Halo without its derived quantities, or a failed Halo; Rvir) from
    the rung that holds j."""
    if j == n_members - 2:
        return _failed(-2, species), None
    # fMvir adds the j-th particle and takes it away again (kd2.c:810-818)
    mvir = np.float32(np.float32(cum[j - 1] + m[j]) - m[j])
    rvir = rvir_of(mvir, thr)
    members = idx[:j]
    vcm = vcm_of(members, ps.vel_np, ps.mass_np, mvir, ps.vcm_acc)
    return Halo(0, mvir, rvir, j, members, vcm, None, None, None, None,
                None), rvir


def _with_derived(h: Halo, der: dict) -> Halo:
    return Halo(h.code, h.mvir, h.rvir, h.j, h.members, h.vcm, **der)


def solve_halo(ps: Particles, center, rgtp, thr: float, n_members: int,
               species=(), grav: float = 1.0) -> Halo:
    """kdRvir for one halo, then its interior members, vcm and (for a
    solved halo) kdVcirc and kdMassProfile from its 2 Rvir ball."""
    radii = ladder(np.float32(rgtp), ps.period)
    if not radii:
        return _failed(-3, species)
    d2 = ps.d2(center)
    r0 = radii[0]
    if int((d2 <= float(np.float32(r0 * r0))).sum()) < n_members:
        return _failed(-1, species)
    thr32 = np.float32(thr)
    for r in radii:
        idx, d2s = ps.ball(d2, np.float32(r * r))
        j, m, cum = _rung(ps, idx, d2s, thr32, n_members)
        if j is not None:
            break
    else:
        return _failed(-3, species)
    h, rvir = _solved(ps, j, m, cum, idx, thr, n_members, species)
    if h.code != 0:
        return h
    fball = np.float32(np.float32(2.0) * rvir)
    idx, d2s = ps.ball(d2, np.float32(fball * fball))
    return _with_derived(h, derived(ps, idx, d2s, rvir, h.mvir, n_members,
                                    species, grav))


def solve_halos(ps: Particles, centers, rgtps, thr: float, n_members: int,
                species=(), grav: float = 1.0) -> list:
    """solve_halo for many halos, alike bit for bit, in batches: the d2 of
    a batch of centers in one pass, then each halo from one sorted ball of
    radius 2 r1 (r1 its first rung), whose prefixes are the balls at r1
    and at 2 Rvir. A halo that needs a later rung, or whose 2 Rvir lies
    past 2 r1, goes through solve_halo."""
    G = len(rgtps)
    out = [None] * G
    thr32 = np.float32(thr)
    batch = max(1, min(64, (1 << 29) // max(ps.n, 1)))
    for lo in range(0, G, batch):
        rows, r0sq, rbsq = [], [], []
        for i in range(lo, min(lo + batch, G)):
            radii = ladder(np.float32(rgtps[i]), ps.period)
            if not radii:
                out[i] = _failed(-3, species)
                continue
            r0 = radii[0]
            rb = np.float32(np.float32(2.0) * r0)
            rows.append(i)
            r0sq.append(np.float32(r0 * r0))
            rbsq.append(np.float32(rb * rb))
        if not rows:
            continue
        d2 = ps.d2_many(np.asarray(centers, np.float32)[rows])
        dev = d2.device
        n0 = (d2 <= torch.as_tensor(np.asarray(r0sq), device=dev)[:, None]
              ).sum(dim=1).cpu().numpy()
        mask = d2 <= torch.as_tensor(np.asarray(rbsq), device=dev)[:, None]
        row, col = torch.nonzero(mask, as_tuple=True)
        del mask
        dd = d2[row, col]
        del d2
        key = (dd.view(torch.int32).to(torch.int64) << 32) | ps.rank[col]
        o = torch.argsort(key)
        o = o[torch.argsort(row[o], stable=True)]
        counts = torch.bincount(row, minlength=len(rows)).cpu().numpy()
        col = col[o].cpu().numpy()
        dd = dd[o].cpu().numpy()
        del row, key, o
        starts = np.concatenate([[0], np.cumsum(counts)])
        for b, i in enumerate(rows):
            if n0[b] < n_members:
                out[i] = _failed(-1, species)
                continue
            idx_b = col[starts[b]:starts[b + 1]]
            d2_b = dd[starts[b]:starts[b + 1]]
            k0 = int(np.searchsorted(d2_b, r0sq[b], side="right"))
            j, m, cum = _rung(ps, idx_b[:k0], d2_b[:k0], thr32, n_members)
            if j is None:
                out[i] = solve_halo(ps, centers[i], rgtps[i], thr,
                                    n_members, species, grav)
                continue
            h, rvir = _solved(ps, j, m, cum, idx_b, thr, n_members, species)
            if h.code != 0:
                out[i] = h
                continue
            fball = np.float32(np.float32(2.0) * rvir)
            fb2 = np.float32(fball * fball)
            if fb2 > rbsq[b]:
                out[i] = solve_halo(ps, centers[i], rgtps[i], thr,
                                    n_members, species, grav)
                continue
            kf = int(np.searchsorted(d2_b, fb2, side="right"))
            out[i] = _with_derived(h, derived(
                ps, idx_b[:kf], d2_b[:kf], rvir, h.mvir, n_members, species,
                grav))
    return out


def derived(ps: Particles, idx: np.ndarray, d2s: np.ndarray,
            rvir: np.float32, mvir: np.float32, n_members: int, species,
            grav: float) -> dict:
    """kdVcirc and kdMassProfile over the ball of radius 2 Rvir (its hits
    ``idx`` sorted, their ``d2s``)."""
    fball = np.float32(np.float32(2.0) * rvir)
    m = ps.mass_np[idx]
    cum = ps.cumsum(m)
    g = np.float32(grav)
    n_in = idx.size

    def cum_below(c, r):
        """The cumulative mass strictly inside r, and its count."""
        k = int(np.count_nonzero(d2s < np.float32(r * r)))
        return (c[k - 1] if k else np.float32(0)), k

    vcirc = np.zeros(NVCIRC, np.float32)
    for i in range(NVCIRC - 1):
        r = np.float32(np.float32((i + 1) * (2.0 / NVCIRC)) * rvir)
        mass_in, _ = cum_below(cum, r)
        vcirc[i] = np.sqrt(np.float32(g * mass_in) / r)
    vcirc[-1] = np.sqrt(np.float32(g * cum[-1]) / fball)

    rmass = np.zeros(2, np.float32)
    for q, f in enumerate((0.25, 0.5)):
        over = np.nonzero(cum >= np.float32(np.float32(f) * mvir))[0]
        jq = over[0] if over.size else max(n_in - 1, 0)
        rmass[q] = np.sqrt(d2s[jq])

    r_s = np.sqrt(d2s)
    with np.errstate(divide="ignore", invalid="ignore"):
        vc = np.sqrt((g * cum) / r_s)
    vc[:max(0, n_members - 1)] = -np.inf
    jm = int(np.argmax(vc)) if n_in else 0
    if n_in and np.isfinite(vc[jm]):
        vmax, rmax = np.float32(vc[jm]), np.float32(r_s[jm])
    else:
        vmax = rmax = np.float32(0)

    profiles = {}
    for sp in species:
        sel = ps.ptype[idx] == sp
        cs = ps.cumsum(np.where(sel, m, np.float32(0)).astype(np.float32))
        bins = np.zeros(NMASSPROFILE, np.float32)
        for i in range(NMASSPROFILE - 1):
            r = np.float32(np.float32((i + 1) * (2.0 / NMASSPROFILE)) * rvir)
            bins[i], _ = cum_below(cs, r)
        bins[-1] = cs[-1] if n_in else np.float32(0)
        profiles[sp] = bins
    return dict(vcirc=vcirc, rmass=rmass, rmax=rmax, vmax=vmax,
                profiles=profiles)


# --------------------------------------------------------------------------
# The processing order: Numerical Recipes' indexx (the reference's
# scheduler, kd2.c:843-861, nr.c), whose tie order a stable sort lacks
# --------------------------------------------------------------------------

def indexx(arr) -> np.ndarray:
    """0-based permutation sorting ``arr`` ascending, ties as NR's
    quicksort leaves them."""
    a1 = [0.0] + np.asarray(arr, np.float64).tolist()
    n = len(a1) - 1
    indx = list(range(n + 1))
    stack = []
    lo, ir = 1, n
    while True:
        if ir - lo < 7:
            for j in range(lo + 1, ir + 1):
                t = indx[j]
                v = a1[t]
                i = j - 1
                while i >= 1 and a1[indx[i]] > v:
                    indx[i + 1] = indx[i]
                    i -= 1
                indx[i + 1] = t
            if not stack:
                break
            ir = stack.pop()
            lo = stack.pop()
        else:
            k = (lo + ir) >> 1
            indx[k], indx[lo + 1] = indx[lo + 1], indx[k]
            if a1[indx[lo + 1]] > a1[indx[ir]]:
                indx[lo + 1], indx[ir] = indx[ir], indx[lo + 1]
            if a1[indx[lo]] > a1[indx[ir]]:
                indx[lo], indx[ir] = indx[ir], indx[lo]
            if a1[indx[lo + 1]] > a1[indx[lo]]:
                indx[lo + 1], indx[lo] = indx[lo], indx[lo + 1]
            i, j = lo + 1, ir
            t = indx[lo]
            v = a1[t]
            while True:
                i += 1
                while a1[indx[i]] < v:
                    i += 1
                j -= 1
                while a1[indx[j]] > v:
                    j -= 1
                if j < i:
                    break
                indx[i], indx[j] = indx[j], indx[i]
            indx[lo] = indx[j]
            indx[j] = t
            if ir - i + 1 >= j - lo:
                stack += [i, ir]
                ir = j - 1
            else:
                stack += [lo, j - 1]
                lo = i
    return np.asarray(indx[1:], np.int64) - 1


# --------------------------------------------------------------------------
# The conflict pass and the stats
# --------------------------------------------------------------------------

@dataclass
class Conflicts:
    igrp: np.ndarray
    n_subsumed: np.ndarray
    n_ignored: np.ndarray
    mvir: np.ndarray
    rvir: np.ndarray
    slurped_own: np.ndarray
    groups_removed: int
    groups_slurped: int


def round_bf16(x) -> np.ndarray:
    """f32 values rounded to the nearest bfloat16 (ties to even), kept as
    f32: the control's precision for f32 arithmetic."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = ((b + 0x7FFF + ((b >> 16) & 1)) >> 16) << 16
    return b.astype(np.uint32).view(np.float32)


def conflict_pass(index, pos, mvir, rvir, code, members, gtp_mass,
                  n_particles: int, rnd=None) -> Conflicts:
    """kdSO's walk (kd2.c:864-895 with kdTagParticles, kd2.c:663-720):
    groups in ascending catalog mass; each solved group walks its interior
    in ascending distance. An unowned particle is tagged. One owned by B
    subsumes B (every particle tagged B is freed and counted) when the
    centers lie within Rvir of A, slurps A (A's tags are freed, the walk
    ends) when within Rvir of B, and is otherwise retained by B (counted
    as ignored). Distances between centers are raw f32 differences, each
    operation rounded by ``rnd`` too when it is given (the control's
    precision)."""
    G = index.shape[0]
    r = (lambda v: v) if rnd is None else rnd
    igrp = np.zeros(n_particles, np.int32)
    n_sub = np.zeros(n_particles, np.int32)
    n_ign = np.zeros(n_particles, np.int32)
    mvir = np.asarray(mvir, np.float32).copy()
    rvir = np.asarray(rvir, np.float32).copy()
    pos = np.asarray(pos, np.float32)
    slurped_own = np.zeros(G, bool)
    removed = slurped = 0
    row_of = np.full(int(index.max()) + 1, -1, np.int64)
    row_of[index] = np.arange(G)
    tags = [None] * G
    for a in indexx(np.asarray(gtp_mass, np.float32)):
        if code[a] != 0 or members[a] is None or members[a].size == 0:
            continue
        ms = np.asarray(members[a], np.int64)
        a_id = np.int32(index[a])
        owner = igrp[ms]
        occ = np.nonzero(owner)[0]
        cut = ms.size
        slurper = -1
        if occ.size:
            b_rows = row_of[owner[occ]]
            d = r(r(pos[a][None, :]) - r(pos[b_rows]))
            r2 = r(r(r(d[:, 0] * d[:, 0]) + r(d[:, 1] * d[:, 1]))
                   + r(d[:, 2] * d[:, 2]))
            ra, rb = r(np.float32(rvir[a])), r(rvir[b_rows])
            sub = r2 <= r(np.float32(ra * ra))
            slurp = ~sub & (r2 <= r(rb * rb))
            if slurp.any():
                first = int(np.argmax(slurp))
                cut, slurper = int(occ[first]), int(b_rows[first])
            before = occ < cut
            for b in np.unique(b_rows[sub & before]):
                t = tags[b]
                if t is not None:
                    mine = t[igrp[t] == index[b]]
                    n_sub[mine] += 1
                    igrp[mine] = 0
                tags[b] = None
                rvir[b] = np.float32(-10.0) * np.float32(a_id)
                mvir[b] = -mvir[b]
                removed += 1
            n_ign[ms[occ[~sub & ~slurp & before]]] += 1
        walk = ms[:cut]
        take = walk[igrp[walk] == 0]
        igrp[take] = a_id
        tags[a] = take
        if slurper >= 0:
            n_sub[take] += 1
            igrp[take] = 0
            tags[a] = None
            rvir[a] = np.float32(-10.0) * np.float32(index[slurper])
            mvir[a] = -mvir[a]
            slurped_own[a] = True
            slurped += 1
    return Conflicts(igrp, n_sub, n_ign, mvir, rvir, slurped_own, removed,
                     slurped)


STATS_FIELDS = ("cum_particles_subsumed", "particles_subsumed",
                "cum_mass_subsumed", "mass_subsumed",
                "cum_particles_ignored", "particles_ignored",
                "cum_mass_ignored", "mass_ignored", "groups_removed",
                "groups_slurped", "particle_mass_sum", "halo_mass_sum")


def stats(mass, c: Conflicts, acc=np.float64) -> dict:
    """kdOutStats' totals: sums in float64, or in ``acc`` (the control's
    float32)."""
    m = np.asarray(mass).astype(acc)
    sub, ign = c.n_subsumed > 0, c.n_ignored > 0

    def total(x):
        return float(np.sum(x, dtype=acc))
    return dict(
        cum_particles_subsumed=int(c.n_subsumed.sum()),
        particles_subsumed=int(sub.sum()),
        cum_mass_subsumed=total(m * c.n_subsumed.astype(acc)),
        mass_subsumed=total(m[sub]),
        cum_particles_ignored=int(c.n_ignored.sum()),
        particles_ignored=int(ign.sum()),
        cum_mass_ignored=total(m * c.n_ignored.astype(acc)),
        mass_ignored=total(m[ign]),
        groups_removed=c.groups_removed, groups_slurped=c.groups_slurped,
        particle_mass_sum=total(m[c.igrp > 0]),
        halo_mass_sum=total(np.maximum(c.mvir.astype(acc), 0)))
