"""Multi-threshold solver: R_200m / R_vir / R_200c catalogs in one pass
(port of so_tpu/engine/multi.py).

The reference solves one overdensity threshold per run. Here T thresholds
are scanned against the same sorted candidate stream per halo: one K1/K3
gather, one row sort and one cumulative mass (K2) per dispatch, then the
single-threshold verdict per threshold, error codes included, so each
output catalog equals an independent run at that threshold.
solver.solve_rvir is this loop at one threshold.

The give-up ladder and the -1 check depend only on geometry and counts
(kd2.c:765-778), so the escalation tracks one ball per halo and a
(T,)-vector of verdicts.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.gather import slab_gather
from ..ops.grid import CellGrid
from ..profiling import counts, span
from .solver import (DK, SOLVE_SLOT_BUDGET, SolveResult, _chunk_for,
                     _dispatch_chunks, _k_limit, _pick_level_span,
                     _row_ladder, count_dispatch, enclosed_density,
                     ladder_radius, pack_block, rvir_ladder,
                     rvir_reference_bits, scan_verdict, survey_pass)


@dataclass
class MultiSolveResult:
    """Per-(threshold, halo) results; axis 0 indexes thresholds."""
    code: np.ndarray    # (T, G) i32
    mvir: np.ndarray    # (T, G) f32
    rvir: np.ndarray    # (T, G) f32
    j: np.ndarray       # (T, G) i32
    d2cut: np.ndarray   # (T, G) f32
    kcap: np.ndarray    # (G,) i64 largest capacity each halo was gathered at
    n_survey: int = 0   # halos the survey pre-pass resolved at every threshold

    def at(self, t: int) -> SolveResult:
        """Threshold ``t``'s SolveResult: copies of row t, vcm zero (the
        member pass fills it)."""
        return SolveResult(code=self.code[t].copy(), mvir=self.mvir[t].copy(),
                           rvir=self.rvir[t].copy(), j=self.j[t].copy(),
                           d2cut=self.d2cut[t].copy(),
                           vcm=np.zeros((self.code.shape[1], 3), np.float32),
                           kcap=self.kcap.copy(), n_survey=self.n_survey)


def _multi_stage(grid: CellGrid, level: int, K: int, S: int, n_members: int,
                 centers, radii, thresholds: np.ndarray):
    """One capacity tier for T thresholds: gather + sort + one cumulative
    mass, then a verdict per threshold. Returns host arrays ((B, 2) ints
    [n_in, overflow], (T, B, 2) ints [found, jstar], (T, B, 2) f32
    [mvir, d2cut]). Spans: solve.ranges, solve.gather, solve.sort (above
    the sorted form's slots), solve.scan and solve.fetch."""
    um = grid.uniform_mass
    g = slab_gather(grid, level, centers, radii, radii * radii, K, S,
                    channels=() if um is not None else ("mass",),
                    layer="solve")
    with span("solve.scan"):
        mass_s = None if um is not None else g.channels[0]
        cum, rho = enclosed_density(g.d2, mass_s, g.n_in, um,
                                    _row_ladder(grid, K))
        outs = [scan_verdict(g.d2, mass_s, g.n_in, cum, rho, thr, n_members,
                             um)
                for thr in thresholds]
    return pack_block(g.n_in, g.overflow, outs)


def solve_rvir_multi(grid: CellGrid, centers, rgtp, thresholds,
                     n_members: int = 8, k0_cap: int = 4096,
                     survey: bool | None = None,
                     progress=None) -> MultiSolveResult:
    """Batched R_Delta for every (halo, threshold) pair, shared gathers.

    ``survey`` runs the sort-free -1/-2 pre-pass (solver.survey_pass)
    first: True forces it, False turns it off, None auto-gates it
    (catalogs of SURVEY_MIN_G+ halos classify a sample and go on only if
    enough of it resolves). The -2 rule is classified per threshold
    against one shared gather, and a halo skips the sorted rounds only
    when every threshold resolved. Results are the same either way.
    ``progress(resolved, G)``, if given, is called after each round with
    the count of halos resolved at every threshold.

    Spans (children of the caller's): solve.plan (the host's set-up, each
    round's live set and capacity tiers, each tier's radii and level),
    solve.survey (the pre-pass), solve.dispatch (one gather stage: its
    _multi_stage spans and solve.apply, the verdicts and escalation).
    Counts: solve.rounds, solve.dispatches, solve.halo_gathers (halos
    over all dispatches, the survey's too), solve.giant_dispatches and
    solve.giant_slots (dispatches at K >= solver.GIANT_K and their B x
    K), solve.overflow_regathers and solve.ball_regrows (halos sent to
    another round by overflow or by a grown ball). At more than one
    threshold also, for every dispatch, the survey's classify stages
    included: multi.verdicts, the T x B (halo, threshold) verdicts it
    scans, and multi.verdicts_settled, those of them whose pair was
    resolved before the dispatch (a halo rides on until every threshold
    has resolved). Host counts, from ``resolved`` only. At one threshold
    nothing is shared (no settled pair is rescanned), so solve_rvir's
    path counts what it did."""
    with span("solve.plan"):
        thresholds = np.asarray(thresholds, np.float32)
        T = thresholds.shape[0]
        G = centers.shape[0]
        dev = grid.device
        centers = np.asarray(centers, np.float32)
        rgtp = np.asarray(rgtp, np.float32)

        code = np.zeros((T, G), np.int32)
        mvir = np.zeros((T, G), np.float32)
        rvir = np.zeros((T, G), np.float32)
        jout = np.zeros((T, G), np.int32)
        d2cut = np.zeros((T, G), np.float32)
        resolved = np.zeros((T, G), bool)

        def count_verdicts(part):
            if T > 1:
                counts[("multi.verdicts",)] += T * int(part.size)
                counts[("multi.verdicts_settled",)] += int(
                    resolved[:, part].sum())

        def settle(t, idx, c):
            code[t, idx] = c
            mvir[t, idx] = float(c)
            rvir[t, idx] = float(c)
            resolved[t, idx] = True

        kmax, _ = rvir_ladder(rgtp, grid.period_np())
        settle(slice(None), kmax == 0, -3)

        cur_k = np.ones(G, np.int32)
        cur_cap = np.full(G, k0_cap, np.int64)
        kcap = cur_cap.copy()
        minus1_open = np.ones(G, bool)
        kl = _k_limit(grid)
        k_cap_max = max(2 * kl, k0_cap)

    n_survey = 0
    if survey is not False and not resolved.all():
        # sort-free -1/-2 pre-pass over the first ladder rung; survivors
        # rescan rung 1 in the normal rounds (the scan is round-stateless)
        def classify_apply(part, packed):
            count_verdicts(part)
            w0 = packed[:, 0]
            n_in, ovf = w0 & 0x7FFFFFFF, (w0 >> 31) & 1
            ok_v = ovf == 0
            is_m1 = ok_v & (n_in < n_members) & minus1_open[part]
            minus1_open[part[n_in >= n_members]] = False
            settle(slice(None), part[is_m1], -1)
            for t in range(T):
                settle(t, part[ok_v & (((packed[:, 1] >> t) & 1) > 0)
                               & ~is_m1], -2)
            # only halos resolved at every threshold skip the sorted rounds
            return int(resolved[:, part].all(axis=0).sum())

        with span("solve.survey"):
            with span("solve.plan"):
                live = np.nonzero(~resolved.all(axis=0))[0]
                radii0 = ladder_radius(rgtp[live], np.minimum(cur_k[live],
                                                              kmax[live]))
            n_survey = survey_pass(grid, centers, radii0, live, n_members,
                                   int(min(k0_cap, kl)), thresholds,
                                   survey is None, classify_apply)

    def apply_block(part, ints, per_t, flts, k_now, cap_now):
        """One round of verdicts + escalation (kd2.c:745-839) for T
        thresholds."""
        n_in, ovf = ints[:, 0], ints[:, 1].astype(bool)
        found, jstar = per_t[:, :, 0].astype(bool), per_t[:, :, 1]  # (T, b)
        cur_k[part] = np.minimum(k_now, kmax[part])
        kcap[part] = np.maximum(kcap[part], int(cap_now))
        at_cap_k = cur_k[part] >= kmax[part]
        # -1: first ladder radius holds < nMembers (kd2.c:772-778);
        # decidable negative at any capacity, positive only w/o overflow
        is_m1 = minus1_open[part] & ~ovf & (n_in < n_members)
        minus1_open[part[n_in >= n_members]] = False

        ok = ~ovf & ~is_m1                # resolutions need no overflow
        is_m2 = ok & found & (jstar == n_members - 2)
        is_succ = ok & found & (jstar > n_members - 2)
        is_m3 = ok & ~found & at_cap_k & ~minus1_open[part]
        for t in range(T):
            settle(t, part[is_m1], -1)
            settle(t, part[is_m2[t]], -2)
            settle(t, part[is_m3[t]], -3)
            su = is_succ[t]
            idx = part[su]
            code[t, idx] = 0
            mvir[t, idx] = flts[t, su, 0]
            rvir[t, idx] = rvir_reference_bits(flts[t, su, 0], thresholds[t])
            d2cut[t, idx] = flts[t, su, 1]
            jout[t, idx] = jstar[t, su]
            resolved[t, idx] = True

        rest = ~resolved[:, part].all(axis=0)
        # overflow: more capacity, same radius (smGrowList, smooth2.c:49-55).
        # Only the overflowing halos regather, all at one capacity. so_tpu
        # presizes every halo with a footprint pass first; on the H100
        # that pass and the capacity tiers it splits a round into cost
        # more dispatches than the x4 regathers they save.
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
        counts[("solve.overflow_regathers",)] += int(grow_cap.sum())
        counts[("solve.ball_regrows",)] += int(grow_ball.sum())

    rnd = 0
    while not resolved.all():
        with span("solve.plan"):
            rnd += 1
            if rnd > 200:
                raise RuntimeError("solver failed to converge (escalation "
                                   "runaway)")
            counts[("solve.rounds",)] += 1
            live = np.nonzero(~resolved.all(axis=0))[0]
            # unify the capacity tier across a tail that fits one dispatch;
            # otherwise only within a x16 band of the largest cap
            if rnd > 1:
                capu = cur_cap[live].max()
                if live.size <= _chunk_for(grid.parts * int(min(capu, kl)),
                                           SOLVE_SLOT_BUDGET):
                    cur_cap[live] = capu
                else:
                    cur_cap[live[cur_cap[live] * 16 > capu]] = capu
            tiers = np.unique(cur_cap[live])
        for capacity in tiers:
            with span("solve.plan"):
                sel = live[cur_cap[live] == capacity]
                K = int(min(capacity, kl))
                k_eff = np.minimum(cur_k[sel], kmax[sel])
                radii = ladder_radius(rgtp[sel], k_eff)
                level, S = _pick_level_span(grid, float(radii.max()))
            for lo, part in _dispatch_chunks(sel, grid.parts * K):
                with span("solve.dispatch"):
                    count_dispatch(part, K)
                    count_verdicts(part)
                    out = _multi_stage(
                        grid, level, K, S, n_members,
                        torch.as_tensor(centers[part], device=dev),
                        torch.as_tensor(radii[lo:lo + part.size], device=dev),
                        thresholds)
                    with span("solve.apply"):
                        apply_block(part, *out, k_eff[lo:lo + part.size], K)
        if progress is not None:
            progress(int(resolved.all(axis=0).sum()), G)
    return MultiSolveResult(code=code, mvir=mvir, rvir=rvir, j=jout,
                            d2cut=d2cut, kcap=kcap, n_survey=n_survey)
