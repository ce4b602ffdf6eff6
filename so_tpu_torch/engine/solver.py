"""Batched R_Delta solver (port of so_tpu/engine/solver.py, the
single-threshold classic escalation).

The reference grows a gather ball from Rgtp by x1.2 per pass (kd2.c:745-769),
sorts hits by distance and scans cumulative mass until the enclosed
density drops below threshold for two consecutive particles
(kd2.c:804-831). The scan state carries across regrows and each pair is
evaluated once, so the whole procedure equals ONE scan over the globally
distance-sorted hits inside the last ladder radius:

    cum(i)  = serial f32 sum of sorted masses m_0..m_i
    rho(i)  = cum(i) / ((4/3) pi d2(i)^(3/2))
    j* = first i >= nMembers-2 with rho(i) < thr, rho(i+1) < thr, i+1 in ball

    j* == nMembers-2            -> -2
    j*  > nMembers-2            -> Mvir = fl(fl(cum(j*-1) + m_j*) - m_j*),
                                   Rvir from Mvir, interior = rows 0..j*-1
    no j* by the ladder cap     -> -3
    first ball holds < nMembers -> -1
    Rgtp >= the cap already     -> -3

Results are therefore independent of how halos are batched, which level
and span each dispatch uses, and how far each escalation jumps (asserted
for so_tpu in tests/test_solver.py); the port keeps only the classic
round loop and drops the TPU's dispatch-shaping machinery.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..ops.gather import cell_ranges, slab_gather
from ..ops.grid import CellGrid
from ..ops.ieee import sqrt_rn
from ..ops.seqsum import seq_cumsum

FOUR_THIRDS_PI = np.float32(4.0 / 3.0 * np.pi)  # rhoEnclosed (kd2.c:592)
DK = 8             # ladder exponents per grow-ball escalation
S_MAX = 7          # largest cell-cube side a gather enumerates
SOLVE_SLOT_BUDGET = 1 << 26   # B*K slots per solve dispatch
FUSED_SLOT_BUDGET = 1 << 25   # B*K slots per fused dispatch (five channels)


def rvir_reference_bits(mvir, thr) -> np.ndarray:
    """fRvir with the reference's arithmetic (kd2.c:816-819): one f32
    rounding of a double quotient, then libm pow with the truncated
    exponent 0.3333333333, rounded once to f32."""
    denom = (4.0 / 3.0) * math.pi * float(np.float32(thr))
    r3 = np.asarray(np.asarray(mvir, np.float64) / denom, np.float32)
    return np.power(r3.astype(np.float64), 0.3333333333).astype(np.float32)


def rvir_ladder(rgtp: np.ndarray, period) -> tuple[np.ndarray, np.float32]:
    """Per-halo (kmax, cap): x1.2 growths until the give-up bound, the
    loop head ``while (fBall < 0.25*fRootPeriod) fBall *= 1.2`` in f32.
    kmax == 0: the loop never runs (immediate -3)."""
    period = np.asarray(period, np.float32)
    root = np.float32(np.sqrt(np.float64(period[0] * period[0]
                                         + period[1] * period[1]
                                         + period[2] * period[2])))
    cap = 0.25 * np.float64(root)
    fball = np.asarray(rgtp, np.float32).copy()
    kmax = np.zeros(fball.shape, np.int32)
    live = np.float64(fball) < cap
    while live.any():
        fball[live] = (fball[live] * np.float32(1.2)).astype(np.float32)
        kmax[live] += 1
        live = np.float64(fball) < cap
    return kmax, np.float32(cap)


def ladder_radius(rgtp: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Rgtp * 1.2^k by repeated f32 multiplication (per-halo k)."""
    r = np.asarray(rgtp, np.float32).copy()
    k = np.asarray(k)
    for step in range(int(k.max()) if k.size else 0):
        sel = k > step
        r[sel] = (r[sel] * np.float32(1.2)).astype(np.float32)
    return r


@lru_cache(maxsize=8)
def _mass_ladder(m: float, K: int) -> np.ndarray:
    """Serial-f32 cumulative sums of K copies of m (np.cumsum is the
    sequential r[i] = r[i-1] + a[i])."""
    return np.cumsum(np.full(K, np.float32(m), np.float32))


@lru_cache(maxsize=8)
def _mass_ladder_on(m: float, K: int, device: torch.device) -> torch.Tensor:
    """_mass_ladder uploaded once per (m, K, device)."""
    return torch.as_tensor(_mass_ladder(m, K), device=device)


def _uniform_cum(uniform_m: float, K: int, n_in, live):
    """Serial-f32 cumulative mass over bit-identical-mass sorted rows:
    cum(i) = ladder[min(i, n_in-1)] (adding the zero pad never changes a
    serial accumulator). Returns (cum, ladder)."""
    lad = _mass_ladder_on(uniform_m, K, n_in.device)
    last = torch.where(n_in > 0, lad[torch.clamp(n_in - 1, min=0)],
                       torch.zeros((), device=n_in.device))
    return torch.where(live, lad[None, :], last[:, None]), lad


def first_true(mask: torch.Tensor):
    """(any, index of the first True along dim 1, 0 where none)."""
    K = mask.shape[1]
    slot = torch.arange(K, device=mask.device)[None, :]
    first = torch.where(mask, slot, torch.full_like(slot, K)).min(dim=1).values
    found = first < K
    return found, torch.where(found, first, torch.zeros_like(first))


def scan_sorted(d2_s, mass_s, n_in, thr: float, n_members: int,
                uniform_m: float | None = None):
    """The density scan over distance-sorted hits. ``mass_s`` is zero on
    invalid slots, or None on uniform-mass grids (the cum ladder is then
    shared by every halo). Returns found, jstar, mvir, d2cut per halo."""
    B, K = d2_s.shape
    dev = d2_s.device
    slot = torch.arange(K, device=dev)[None, :]
    if uniform_m is not None:
        cum, _ = _uniform_cum(uniform_m, K, n_in, slot < n_in[:, None])
    else:
        cum = seq_cumsum(mass_s)          # C-order f32 (kd2.c:807), K2

    r3 = d2_s * sqrt_rn(d2_s)
    rho = cum / (float(FOUR_THIRDS_PI) * r3)
    rho_next = torch.cat([rho[:, 1:], torch.full((B, 1), torch.inf,
                                                 device=dev)], dim=1)
    thr = float(np.float32(thr))
    pair_ok = ((rho < thr) & (rho_next < thr)
               & (slot + 1 < n_in[:, None]) & (slot >= n_members - 2))
    found, jstar = first_true(pair_ok)
    rows = torch.arange(B, device=dev)
    jm1 = torch.clamp(jstar - 1, min=0)
    # Mvir adds the j* particle and subtracts it again (kd2.c:810-818):
    # fMvir = fl(fl(cum[j*-1] + m_j*) - m_j*) = fl(cum[j*] - m_j*)
    if uniform_m is not None:
        m_at = torch.where(n_in > 0, torch.full((B,), np.float32(uniform_m),
                                                device=dev),
                           torch.zeros(B, device=dev))
    else:
        m_at = mass_s[rows, jstar]
    mvir = cum[rows, jstar] - m_at
    d2cut = d2_s[rows, jm1]
    return dict(found=found, jstar=jstar, mvir=mvir, d2cut=d2cut)


def _solve_stage(grid: CellGrid, level: int, K: int, S: int, n_members: int,
                 centers, radii, thr: float):
    """One capacity tier: gather + sort + scan for a batch of halos.
    Returns host arrays ((B, 4) ints [n_in, jstar, found, overflow],
    (B, 2) f32 [mvir, d2cut])."""
    um = grid.uniform_mass
    g = slab_gather(grid, level, centers, radii, radii * radii, K, S,
                    channels=() if um is not None else ("mass",))
    out = scan_sorted(g.d2, None if um is not None else g.channels[0],
                      g.n_in, thr, n_members, uniform_m=um)
    ints = torch.stack([g.n_in, out["jstar"], out["found"].long(),
                        g.overflow.long()], dim=1)
    flts = torch.stack([out["mvir"], out["d2cut"]], dim=1)
    return ints.cpu().numpy(), flts.cpu().numpy()


@dataclass
class SolveResult:
    """Per-halo R_Delta solve output (pre-conflict-resolution)."""
    code: np.ndarray    # (G,) i32: 0 ok; -1/-2/-3 reference error codes
    mvir: np.ndarray    # (G,) f32: cum mass strictly inside Rvir (or code)
    rvir: np.ndarray    # (G,) f32: derived radius (or code)
    j: np.ndarray       # (G,) i32: interior particle count
    d2cut: np.ndarray   # (G,) f32: d2 of the (j-1)-th sorted particle
    vcm: np.ndarray     # (G,3) f32: filled by the member pass
    kcap: np.ndarray | None = None  # (G,) i64 capacity that resolved it


def _k_limit(grid) -> int:
    """Capacity ceiling guaranteed gather-complete on the slab path: the
    particle count plus a run's worst alignment padding (st % chunk in
    front, the round-up behind: < 2 chunks) for each of at most S_MAX^3
    merged runs. so_tpu budgets one chunk per cell and leaves tiers above
    its slab ceiling to an XLA gather without padding; the port's kernel
    serves every tier, so its ceiling must hold the padding itself."""
    extra = (S_MAX ** 3) * 2 * grid.chunk
    return max(256, 1 << int(np.ceil(np.log2(max(grid.n + extra, 2)))))


def _pick_level(grid: CellGrid, rmax: float) -> int:
    """Finest level whose S_MAX-cube covers radius rmax and whose mean
    cell occupancy is at least 3/4 of a slab chunk (so chunks arrive
    mostly full)."""
    min_occ = (3 * grid.chunk) // 4
    period = grid.period_np()
    for g in range(grid.m + 1):
        cs = float(period.min()) / grid.ncell(g)
        occ = grid.n / (grid.ncell(g) ** 3)
        if 2 * int(np.ceil(rmax / cs)) + 2 <= S_MAX and occ >= min_occ:
            return g
    return grid.m


def _pick_level_span(grid: CellGrid, rmax: float) -> tuple[int, int]:
    """(level, S): the level as above plus the smallest cube side that
    covers rmax there."""
    g = _pick_level(grid, rmax)
    cs = float(grid.period_np().min()) / grid.ncell(g)
    span = min(int(2 * rmax / cs) + 2, S_MAX, grid.ncell(g))
    return g, max(span, 1)


def _chunk_for(K: int, slot_budget: int) -> int:
    """Halos per dispatch: B*K slot buffers within the budget."""
    return max(1, min(16384, slot_budget // K))


def _dispatch_chunks(sel: np.ndarray, K: int):
    chunk = _chunk_for(K, SOLVE_SLOT_BUDGET)
    for lo in range(0, sel.size, chunk):
        yield lo, sel[lo:lo + chunk]


def _foot_stage(grid: CellGrid, level: int, S: int, centers, radii):
    """Exact per-halo slab-slot footprints (cell_ranges totals)."""
    _, _, _, total = cell_ranges(grid, level, centers, radii, radii * radii,
                                 S, align=grid.chunk)
    return total


def solve_rvir(grid: CellGrid, centers: np.ndarray, rgtp: np.ndarray,
               thr: float, n_members: int = 8,
               k0_cap: int = 4096) -> SolveResult:
    """Solve R_Delta for every halo (batched, staged capacity escalation)."""
    G = centers.shape[0]
    dev = grid.device
    period = grid.period_np()
    centers = np.asarray(centers, np.float32)
    rgtp = np.asarray(rgtp, np.float32)

    code = np.zeros(G, np.int32)
    mvir = np.zeros(G, np.float32)
    rvir = np.zeros(G, np.float32)
    jout = np.zeros(G, np.int32)
    d2cut = np.zeros(G, np.float32)
    kcap = np.full(G, k0_cap, np.int64)
    resolved = np.zeros(G, bool)

    kmax, _ = rvir_ladder(rgtp, period)
    zero_iter = kmax == 0                 # loop never entered -> -3
    code[zero_iter] = -3
    mvir[zero_iter] = -3.0
    rvir[zero_iter] = -3.0
    resolved |= zero_iter

    cur_k = np.ones(G, np.int32)          # ladder exponent (first gather k=1)
    cur_cap = np.full(G, k0_cap, np.int64)
    minus1_open = np.ones(G, bool)        # -1 check still undecided
    kl = _k_limit(grid)
    k_cap_max = max(2 * kl, k0_cap)

    def apply_round(part, ints, flts, k_now, cap_now):
        """One round of the reference's regrow decisions (kd2.c:745-839)."""
        n_in, jstar = ints[:, 0], ints[:, 1]
        found = ints[:, 2].astype(bool)
        ovf = ints[:, 3].astype(bool)
        o_mvir, o_d2c = flts[:, 0], flts[:, 1]

        cur_k[part] = np.minimum(k_now, kmax[part])
        at_cap_k = cur_k[part] >= kmax[part]
        # -1: first ladder radius holds < nMembers (kd2.c:772-778);
        # decidable negative at any capacity, positive only w/o overflow
        is_m1 = minus1_open[part] & ~ovf & (n_in < n_members)
        minus1_open[part[n_in >= n_members]] = False

        ok = ~ovf                           # resolutions need no overflow
        is_m2 = ok & found & (jstar == n_members - 2) & ~is_m1
        is_succ = ok & found & (jstar > n_members - 2) & ~is_m1
        is_m3 = ok & ~found & at_cap_k & ~is_m1 & ~minus1_open[part]

        for mask, c in ((is_m1, -1), (is_m2, -2), (is_m3, -3)):
            idx = part[mask]
            code[idx] = c
            mvir[idx] = float(c)
            rvir[idx] = float(c)
            resolved[idx] = True
        kcap[part] = np.maximum(kcap[part], int(cap_now))
        idx = part[is_succ]
        code[idx] = 0
        mvir[idx] = o_mvir[is_succ]
        rvir[idx] = rvir_reference_bits(o_mvir[is_succ], thr)
        jout[idx] = jstar[is_succ]
        d2cut[idx] = o_d2c[is_succ]
        resolved[idx] = True

        rest = ~(is_m1 | is_m2 | is_succ | is_m3)
        # overflow: more capacity, same radius (smGrowList, smooth2.c:49-55)
        grow_cap = rest & ovf
        cur_cap[part[grow_cap]] = min(int(cap_now) * 4, k_cap_max)
        # nothing found, ladder not exhausted: grow the ball DK rungs and
        # presize capacity from the observed density
        grow_ball = rest & ~ovf & ~at_cap_k
        gi = part[grow_ball]
        cur_k[gi] = np.minimum(cur_k[gi] + DK, kmax[gi])
        vol_ratio = int(np.ceil(np.float64(1.2) ** (3 * DK)))
        est = (n_in[grow_ball].astype(np.int64) + 64) * vol_ratio
        cur_cap[gi] = np.maximum(cur_cap[gi], np.minimum(
            2 ** np.ceil(np.log2(np.maximum(est, 1))).astype(np.int64),
            k_cap_max))

    rnd = 0
    while not resolved.all():
        rnd += 1
        if rnd > 200:
            raise RuntimeError("solver failed to converge (escalation runaway)")
        live = np.nonzero(~resolved)[0]
        if rnd > 1:
            # unify the capacity tier across a tail that fits one dispatch;
            # otherwise only within a x16 band of the largest cap
            capu = cur_cap[live].max()
            if live.size <= _chunk_for(int(min(capu, kl)), SOLVE_SLOT_BUDGET):
                cur_cap[live] = capu
            else:
                cur_cap[live[cur_cap[live] * 16 > capu]] = capu
        for capacity in np.unique(cur_cap[live]):
            sel = live[cur_cap[live] == capacity]
            K = int(min(capacity, kl))
            k_eff = np.minimum(cur_k[sel], kmax[sel])
            radii = ladder_radius(rgtp[sel], k_eff)
            level, S = _pick_level_span(grid, float(radii.max()))
            for lo, part in _dispatch_chunks(sel, K):
                c_dev = torch.as_tensor(centers[part], device=dev)
                r_dev = torch.as_tensor(radii[lo:lo + part.size], device=dev)
                ints, flts = _solve_stage(grid, level, K, S, n_members,
                                          c_dev, r_dev, thr)
                apply_round(part, ints, flts, k_eff[lo:lo + part.size], K)
    return SolveResult(code=code, mvir=mvir, rvir=rvir, j=jout, d2cut=d2cut,
                       vcm=np.zeros((G, 3), np.float32), kcap=kcap)
