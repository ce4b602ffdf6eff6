"""Batched R_Delta solver (port of so_tpu/engine/solver.py: the classic
escalation and the --survey pre-pass).

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
round loop and drops the TPU's dispatch-shaping machinery. The scan is
split into its threshold-free half (enclosed_density) and a verdict per
threshold (scan_verdict); the round loop itself is multi.solve_rvir_multi,
and solve_rvir is its one-threshold case.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..ops.gather import unsorted_gather
from ..ops.grid import CellGrid
from ..ops.ieee import cbrt_f32, sqrt_rn
from ..ops.ranges import S_MAX  # largest cell-cube side a gather enumerates
from ..ops.seqsum import seq_cumsum
from ..profiling import counts, span

FOUR_THIRDS_PI = np.float32(4.0 / 3.0 * np.pi)  # rhoEnclosed (kd2.c:592)
DK = 8             # ladder exponents per grow-ball escalation
SOLVE_SLOT_BUDGET = 1 << 26   # B*K slots per solve dispatch
FUSED_SLOT_BUDGET = 1 << 25   # B*K slots per fused dispatch (five channels)
GIANT_K = 1 << 24             # solve dispatches at this K or more count as giant


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


def _row_ladder(grid, K: int):
    """The ladder of a dispatch at capacity K on a uniform-mass grid (None
    on general masses): grid.parts * K entries, the widest row a gather
    returns, whose prefix serves the narrower rows of the in-ball sort, so
    the cache keeps one entry a capacity."""
    um = grid.uniform_mass
    return (None if um is None
            else _mass_ladder_on(um, grid.parts * K, grid.device))


def _uniform_cum(uniform_m: float, K: int, n_in, live, lad=None):
    """Serial-f32 cumulative mass over bit-identical-mass sorted rows:
    cum(i) = ladder[min(i, n_in-1)] (adding the zero pad never changes a
    serial accumulator). ``lad`` is a ladder of at least K entries to use
    instead of the cached one (its first K are the K-long ladder: rows
    narrower than the capacity pass the capacity's). Returns (cum,
    ladder)."""
    if lad is None:
        lad = _mass_ladder_on(uniform_m, K, n_in.device)
    lad = lad[:K]
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


def enclosed_density(d2_s, mass_s, n_in, uniform_m: float | None = None,
                     lad=None):
    """The threshold-free half of the scan over distance-sorted hits:
    (cum, rho), the serial f32 cumulative mass (K2, or the shared ladder
    when ``mass_s`` is None on a uniform-mass grid; ``lad`` as in
    _uniform_cum) and the enclosed density at each slot. ``mass_s`` is
    +0.0 on invalid slots, so K2's chain stops at n_in."""
    K = d2_s.shape[1]
    slot = torch.arange(K, device=d2_s.device)[None, :]
    if uniform_m is not None:
        cum, _ = _uniform_cum(uniform_m, K, n_in, slot < n_in[:, None], lad)
    else:
        cum = seq_cumsum(mass_s, n_valid=n_in)  # C-order f32 (kd2.c:807)
    r3 = d2_s * sqrt_rn(d2_s)
    return cum, cum / (float(FOUR_THIRDS_PI) * r3)


def scan_verdict(d2_s, mass_s, n_in, cum, rho, thr: float, n_members: int,
                 uniform_m: float | None = None):
    """The per-threshold half: found, jstar, mvir, d2cut per halo from
    enclosed_density's (cum, rho)."""
    B, K = d2_s.shape
    dev = d2_s.device
    slot = torch.arange(K, device=dev)[None, :]
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


def scan_sorted(d2_s, mass_s, vel_s, n_in, thr, n_members: int,
                uniform_m: float | None = None, lad=None):
    """so_tpu's density scan over distance-sorted hits, one threshold:
    dict(found, jstar, mvir, rvir, d2cut, vcm) per halo, from
    enclosed_density (K2 on general masses) and scan_verdict. ``mass_s`` is
    +0.0 on invalid slots, or None on a uniform-mass grid (``uniform_m``;
    ``lad`` as in _uniform_cum).

    rvir is so_tpu's f32 cbrt(mvir / (4/3 pi thr)) (ops/ieee.cbrt_f32),
    not the reference's bits (rvir_reference_bits, which the solve
    writes). vcm is the mass-weighted mean velocity over the first jstar
    slots of ``vel_s`` (B, K, 3), or zeros when ``vel_s`` is None; it needs
    ``mass_s``."""
    if vel_s is not None and mass_s is None:
        raise ValueError("vcm needs per-slot masses; pass mass_s")
    cum, rho = enclosed_density(d2_s, mass_s, n_in, uniform_m, lad)
    out = scan_verdict(d2_s, mass_s, n_in, cum, rho, thr, n_members,
                       uniform_m)
    mvir = out["mvir"]
    # so_tpu's FOUR_THIRDS_PI * thr is one f32 product. It divides as a
    # tensor: torch on CUDA multiplies by the reciprocal of a Python
    # scalar divisor, which is not the correctly rounded quotient
    den = torch.tensor(FOUR_THIRDS_PI * np.float32(thr), device=mvir.device)
    out["rvir"] = cbrt_f32(mvir / den)
    B, K = d2_s.shape
    if vel_s is not None:
        slot = torch.arange(K, device=d2_s.device)[None, :]
        w = torch.where(slot < out["jstar"][:, None], mass_s,
                        torch.zeros((), device=d2_s.device))
        out["vcm"] = (w[:, :, None] * vel_s).sum(dim=1) / mvir[:, None]
    else:
        out["vcm"] = torch.zeros((B, 3), device=d2_s.device)
    return out


def pack_block(n_in, overflow, outs):
    """A stage's host block from its scan_verdict dicts (one a threshold):
    ((B, 2) ints [n_in, overflow], (T, B, 2) ints [found, jstar], (T, B,
    2) f32 [mvir, d2cut]), in a span solve.fetch."""
    with span("solve.fetch"):
        ints = torch.stack([n_in, overflow.long()], dim=1)
        per_t = torch.stack([torch.stack([o["found"].long(), o["jstar"]],
                                         dim=1) for o in outs])
        flts = torch.stack([torch.stack([o["mvir"], o["d2cut"]], dim=1)
                            for o in outs])
        return ints.cpu().numpy(), per_t.cpu().numpy(), flts.cpu().numpy()


def _classify_stage(grid: CellGrid, level: int, K: int, S: int,
                    n_members: int, centers, radii,
                    thresholds: np.ndarray) -> np.ndarray:
    """Sort-free -1/-2 classification from the first-rung hits.

    The -1 verdict needs only the in-ball count (kd2.c:772-778) and the
    -2 verdict only the first nMembers sorted hits (the two-consecutive
    rule firing at the earliest eligible slot, kd2.c:785-796): an
    unsorted K1 gather (K3 above gather.PIECE_K_MIN slots) plus a count
    test (uniform masses) or a 16-wide nearest prefix (general masses)
    replaces the K-wide sort. Halos it cannot decide re-run in the full
    rounds, whose verdict is the contract. ``thresholds`` is a (T,) f32
    vector: the -2 rule is evaluated per threshold against the same
    gather. Returns the host (B, 2) i32
    [n_in | overflow << 31, bit t = -2 at thresholds[t]]. Spans:
    solve.ranges, solve.gather, solve.scan (the verdict) and solve.fetch."""
    um = grid.uniform_mass
    d2, ch, _, overflow = unsorted_gather(
        grid, level, centers, radii, radii * radii, K, S,
        chans=() if um is not None else ("mass",), layer="solve")
    with span("solve.scan"):
        n_in = torch.isfinite(d2).sum(dim=1)
        if um is not None:
            m2 = _classify_counts(d2, n_in, thresholds, n_members, um)
        else:
            kk = min(K, max(16, n_members + 2))  # a clamped window defers -2
            d2k, mk = _classify_prefix(d2, ch[:, 0], kk)
            m2 = _classify_verdict(d2k, mk, n_in, thresholds, n_members)
        w0 = n_in | (overflow.long() << 31)
        packed = torch.stack([w0, m2], dim=1)
    with span("solve.fetch"):
        return packed.cpu().numpy().astype(np.int32)


# the certainty band of _classify_counts: ~250 f32 ulps, covering the
# <= 5-op rounding chain of the scan's rho plus Q's own f32 evaluation
BAND = 3e-5


def _classify_counts(d2, n_in, thresholds, n_members: int, um: float):
    """Counting form of the -2 verdict for uniform masses.

    Every sorted cumulative mass is the ladder value cum(i), so
        rho(i) < thr  <=>  d2_(i) > Q_i,   Q_i = (cum(i)/((4/3)pi thr))^(2/3)
                      <=>  count(d2 <= Q_i) <= i,
    an order statistic, exact under any tie order. -2 at the first
    eligible slot b1 = nMembers-2 is then two counts per threshold (and
    slot b1+1 inside the ball). The full solve compares f32-rounded rho,
    so each count is taken at Q*(1 +/- BAND) and a halo is called -2 only
    when both edges agree; the rest defer to the full solve. Q is
    computed on the host in numpy f32, so the CPU and CUDA runs compare
    against the same bits."""
    b1 = n_members - 2
    lad = np.cumsum(np.full(n_members, np.float32(um), np.float32))
    hi, lo = np.float32(1.0 + BAND), np.float32(1.0 - BAND)
    two_thirds = np.float32(2.0 / 3.0)
    m2 = torch.zeros_like(n_in)

    def cnt(q):
        return (d2 <= float(q)).sum(dim=1)

    for t, thr in enumerate(np.asarray(thresholds, np.float32)):
        q1 = (lad[b1] / (FOUR_THIRDS_PI * thr)) ** two_thirds
        q2 = (lad[b1 + 1] / (FOUR_THIRDS_PI * thr)) ** two_thirds
        c1, c2 = cnt(q1 * hi), cnt(q2 * hi)
        is_m2 = ((c1 <= b1) & (c2 <= b1 + 1) & (c1 == cnt(q1 * lo))
                 & (c2 == cnt(q2 * lo)) & (n_in >= n_members))
        m2 = m2 | (is_m2.long() << t)
    return m2


def _classify_prefix(d2, mass, kk: int):
    """Ascending kk-nearest (d2, mass) prefix of unsorted hit lists (pad
    slots carry d2=+inf, mass 0). torch.topk leaves the order of equal
    values open, so the kk picks are put back in slot order and sorted
    stably: ties below the kk-th value come out the same on every
    device."""
    _, pick = torch.topk(d2, kk, dim=1, largest=False, sorted=False)
    pick, _ = torch.sort(pick, dim=1)
    d2k, o = torch.sort(torch.gather(d2, 1, pick), dim=1, stable=True)
    return d2k, torch.gather(mass, 1, torch.gather(pick, 1, o))


def _classify_verdict(d2k, mk, n_in, thresholds, n_members: int):
    """The -2 verdict over an ascending kk-prefix (the scan's rule on its
    first slots, K2 for the cumulative mass). Ties at the decision slots
    (nMembers-2, -1, and the next) defer: the full solve may order equal
    d2 differently."""
    B, kk = d2k.shape
    cum = seq_cumsum(mk, n_valid=n_in)          # mk is +0.0 past min(n_in, kk)
    rho = cum / (float(FOUR_THIRDS_PI) * (d2k * sqrt_rn(d2k)))
    slot = torch.arange(kk, device=d2k.device)[None, :]
    rho_next = torch.cat([rho[:, 1:], torch.full((B, 1), torch.inf,
                                                 device=d2k.device)], dim=1)
    b1 = n_members - 2
    m2 = torch.zeros_like(n_in)
    if b1 + 2 > kk - 1:                 # window too short to decide -2
        return m2
    no_tie = ((d2k[:, b1] != d2k[:, b1 + 1])
              & (d2k[:, b1 + 1] != d2k[:, b1 + 2]))
    for t, thr in enumerate(np.asarray(thresholds, np.float32)):
        thr = float(thr)
        pair_ok = ((rho < thr) & (rho_next < thr)
                   & (slot + 1 < n_in[:, None]) & (slot >= b1))
        found, jstar = first_true(pair_ok)
        m2 = m2 | ((found & (jstar == b1) & no_tie).long() << t)
    return m2


# --survey auto-gate (survey=None): catalogs below SURVEY_MIN_G halos skip
# the pre-pass; above it a SURVEY_SAMPLE-halo classify runs first and the
# full pre-pass only proceeds when >= SURVEY_FRAC of the sample resolves
SURVEY_MIN_G = 1 << 15
SURVEY_SAMPLE = 1024
SURVEY_FRAC = 0.25


def count_dispatch(part: np.ndarray, K: int) -> None:
    """One solve dispatch over the halos ``part`` at capacity K, in
    profiling's counts; at K >= GIANT_K also solve.giant_dispatches and
    solve.giant_slots (its B x K)."""
    counts[("solve.dispatches",)] += 1
    counts[("solve.halo_gathers",)] += int(part.size)
    if K >= GIANT_K:
        counts[("solve.giant_dispatches",)] += 1
        counts[("solve.giant_slots",)] += int(part.size) * K


def survey_pass(grid: CellGrid, centers, radii, live, n_members: int, K: int,
                thresholds, auto: bool, apply) -> int:
    """The sort-free -1/-2 pre-pass over the live halos at their first
    ladder radii. ``apply(part, packed)`` takes each dispatch's
    _classify_stage block and returns how many halos it resolved; with
    ``auto`` a sample decides whether the rest is classified. Returns
    the number of halos resolved. Spans: solve.plan (each run's level),
    solve.dispatch (a _classify_stage and solve.apply, ``apply``'s
    call); each dispatch adds to the counts solve.dispatches and
    solve.halo_gathers."""
    if live.size < SURVEY_MIN_G and auto:
        return 0
    dev = grid.device

    def run(idx, rads):
        total = 0
        if idx.size == 0:
            return total
        with span("solve.plan"):
            level, S = _pick_level_span(grid, float(rads.max()))
        for lo, part in _dispatch_chunks(idx, grid.parts * K):
            with span("solve.dispatch"):
                count_dispatch(part, K)
                packed = _classify_stage(
                    grid, level, K, S, n_members,
                    torch.as_tensor(centers[part], device=dev),
                    torch.as_tensor(rads[lo:lo + part.size], device=dev),
                    thresholds)
                with span("solve.apply"):
                    total += apply(part, packed)
        return total

    start = n_res = 0
    if auto:
        ns = min(SURVEY_SAMPLE, live.size)
        n_res = run(live[:ns], radii[:ns])
        start = ns if n_res >= SURVEY_FRAC * ns else live.size
    return n_res + run(live[start:], radii[start:])


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
    n_survey: int = 0   # halos the survey pre-pass resolved


def _k_limit(grid) -> int:
    """Capacity ceiling guaranteed gather-complete on the slab path: the
    particle count (of a shard, on a sharded grid) plus a run's worst
    alignment padding (st % chunk in front, the round-up behind: < 2
    chunks) for each of at most S_MAX^3 merged runs. so_tpu budgets one chunk per cell and leaves tiers above
    its slab ceiling to an XLA gather without padding; the port's kernel
    serves every tier, so its ceiling must hold the padding itself."""
    extra = (S_MAX ** 3) * 2 * grid.chunk
    return max(256, 1 << int(np.ceil(np.log2(max(grid.n + extra, 2)))))


def _pick_level(grid: CellGrid, rmax: float) -> int:
    """Finest level whose S_MAX-cube covers radius rmax and whose mean
    cell occupancy (of a shard's cells, on a sharded grid) is at least 3/4
    of a slab chunk (so chunks arrive mostly full)."""
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


def _chunk_for(slots: int, slot_budget: int) -> int:
    """Halos per dispatch: B * slots buffers within the budget, where
    ``slots`` is a halo's row width (grid.parts * K)."""
    return max(1, min(16384, slot_budget // slots))


def _dispatch_chunks(sel: np.ndarray, slots: int):
    chunk = _chunk_for(slots, SOLVE_SLOT_BUDGET)
    for lo in range(0, sel.size, chunk):
        yield lo, sel[lo:lo + chunk]


def solve_rvir(grid: CellGrid, centers: np.ndarray, rgtp: np.ndarray,
               thr: float, n_members: int = 8, k0_cap: int = 4096,
               progress=None, survey: bool | None = None) -> SolveResult:
    """Solve R_Delta for every halo (batched, staged capacity escalation):
    multi.solve_rvir_multi at the one threshold ``thr``, whose docstring
    says what ``survey`` and ``progress`` do."""
    from .multi import solve_rvir_multi   # multi builds on this module

    return solve_rvir_multi(grid, centers, rgtp, [thr], n_members, k0_cap,
                            survey, progress=progress).at(0)
