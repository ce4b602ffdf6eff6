"""How a run's ``correct`` is decided.

After the window closes, one job a snapshot, drawn from the seed while the
window runs (harness.Keep), is held to the plain reference
(sobench/reference). The mix's ``check`` says how:

- ``whole_jobs`` of the kept jobs, drawn from the seed, are checked whole:
  every halo's solve (code, j, Mvir and Rvir bits), members (the ordered
  interior list), vcm bits and derived quantities (Vc, Rq/Rh, Vmax/Rmax,
  species profiles) against the reference's brute force, and the conflict
  pass (igrp, the subsumed and ignored counts, slurped flags,
  post-conflict Mvir/Rvir, the two group counters) and the stats against
  the reference's walk over the reference's own solve;
- every other kept job on ``halos`` halos drawn from the seed, spread over
  ``strata`` bins of equal width in log Rgtp (so every capacity tier of
  the solve is in the sample) with the largest clump's center always
  among them, and its whole conflict pass and stats against the
  reference's walk over the program's solve and member lists, which the
  sample holds to the reference.

Each number is held to its limit from ``sobench/limits/<cell>.json``.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference import so_reference as ref

NUMBERS = ("solve_diff", "member_diff", "vcm_diff", "derived_err",
           "conflict_diff", "stats_err")


def seed_rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2 ** 63 - 1), stream])


def program_halo(run, h: int, species) -> ref.Halo:
    s, d = run.solve, run.derived
    m = run.members[h]
    return ref.Halo(
        code=int(s.code[h]), mvir=np.float32(s.mvir[h]),
        rvir=np.float32(s.rvir[h]), j=int(s.j[h]),
        members=(np.zeros(0, np.int64) if m is None
                 else np.asarray(m, np.int64)),
        vcm=np.asarray(s.vcm[h], np.float32), vcirc=d.vcirc[h],
        rmass=d.rmass[h], rmax=np.float32(d.rmax[h]),
        vmax=np.float32(d.vmax[h]),
        profiles={sp: d.profiles[sp][h] for sp in species})


def bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


def rel_err(a, b) -> float:
    """Largest |a - b| / max(|a|, |b|) over the elements (0 where both are
    0; 1 where one is not finite or the shapes differ)."""
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    if a.shape != b.shape:
        return 1.0
    if not (np.isfinite(a).all() and np.isfinite(b).all()):
        return 0.0 if np.array_equal(a, b) else 1.0
    top = np.maximum(np.abs(a), np.abs(b))
    with np.errstate(invalid="ignore", divide="ignore"):
        e = np.where(top > 0, np.abs(a - b) / top, 0.0)
    return float(e.max()) if e.size else 0.0


def derived_of(h: ref.Halo, eligible: bool, species) -> list:
    """The derived fields of a halo, zero where the pipeline zeroes them
    (a failed solve, or a group slurped during its own walk)."""
    f = [h.vcirc, h.rmass, h.rmax, h.vmax] + [h.profiles[sp]
                                              for sp in species]
    return [np.asarray(x, np.float32) * np.float32(eligible) for x in f]


def compare_halo(got: ref.Halo, want: ref.Halo, eligible: bool,
                 species) -> tuple:
    """(solve differs, members differ, vcm differs, derived relative
    error). vcm is compared where the member lists agree, the derived
    fields where both solves end alike (a list or a solve that differs is
    its own number's to count)."""
    solved = got.code == 0 and want.code == 0
    solve_bad = got.code != want.code or (solved and (
        got.j != want.j or bits(got.mvir) != bits(want.mvir)
        or bits(got.rvir) != bits(want.rvir)))
    member_bad = solved and not np.array_equal(got.members, want.members)
    vcm_bad = solved and not member_bad and not np.array_equal(
        bits(got.vcm), bits(want.vcm))
    err = 0.0 if got.code != want.code else max(rel_err(a, b) for a, b in zip(
        derived_of(got, eligible and solved, species),
        derived_of(want, eligible and solved, species)))
    return bool(solve_bad), bool(member_bad), bool(vcm_bad), err


def conflict_diff(got, want) -> int:
    """Particles and groups whose conflict outputs differ, and the
    difference of the two group counters."""
    return int(np.count_nonzero(got.igrp != want.igrp)
               + np.count_nonzero(got.n_subsumed != want.n_subsumed)
               + np.count_nonzero(got.n_ignored != want.n_ignored)
               + np.count_nonzero(bits(got.mvir) != bits(want.mvir))
               + np.count_nonzero(bits(got.rvir) != bits(want.rvir))
               + np.count_nonzero(got.slurped_own != want.slurped_own)
               + abs(got.groups_removed - want.groups_removed)
               + abs(got.groups_slurped - want.groups_slurped))


def stats_err(got: dict, want: dict) -> float:
    return max(rel_err(got[k], want[k]) for k in ref.STATS_FIELDS)


def empty() -> dict:
    return dict(solve_diff=0, member_diff=0, vcm_diff=0, derived_err=0.0,
                conflict_diff=0, stats_err=0.0)


def reference_conflicts(run, snap, rnd=None):
    """The reference walk over the program's solve and member lists."""
    s = run.solve
    G = s.code.shape[0]
    return ref.conflict_pass(np.arange(1, G + 1, dtype=np.int32),
                             snap.centers, s.mvir, s.rvir, s.code,
                             run.members, snap.gtp_mass, snap.n, rnd)


def walk_of(halos: list, snap, rnd=None):
    """The reference walk over a solve of every halo (``ref.Halo`` each)."""
    G = len(halos)
    return ref.conflict_pass(
        np.arange(1, G + 1, dtype=np.int32), snap.centers,
        np.array([h.mvir for h in halos], np.float32),
        np.array([h.rvir for h in halos], np.float32),
        np.array([h.code for h in halos], np.int32),
        [h.members if h.code == 0 else None for h in halos],
        snap.gtp_mass, snap.n, rnd)


def sample_halos(snap, n_check: int, strata: int, rng) -> np.ndarray:
    """``n_check`` halos drawn from ``rng``, an equal share from each of
    ``strata`` bins of equal width in log Rgtp (all of a bin that holds
    fewer), and the largest clump's center."""
    lr = np.log(np.asarray(snap.rgtp, np.float64))
    edges = np.linspace(lr.min(), lr.max(), strata + 1)
    b = np.clip(np.searchsorted(edges, lr, side="right") - 1, 0, strata - 1)
    per = max(1, n_check // strata)
    pick = [np.asarray([int(np.argmax(snap.rgtp))])]
    for k in range(strata):
        rows = np.nonzero(b == k)[0]
        if rows.size:
            pick.append(rng.choice(rows, size=min(per, rows.size),
                                   replace=False))
    return np.unique(np.concatenate(pick))


def plan(jobs, snaps, check: dict, seed: int) -> list:
    """(kept job, snapshot, halos to hold to the reference or None for
    every halo) for each kept job, drawn from the seed."""
    rng = seed_rng(seed, 1)
    whole = set(rng.choice(len(jobs), size=min(int(check.get(
        "whole_jobs", 0)), len(jobs)), replace=False).tolist())
    out = []
    for k, (i, runs) in enumerate(jobs):
        halos = None if k in whole else sample_halos(
            snaps[i], int(check["halos"]), int(check.get("strata", 1)), rng)
        out.append((runs, snaps[i], halos))
    return out


def reference_particles(snap, period, device, dtype=torch.float32,
                        vcm_acc=np.float64):
    return ref.Particles(snap.pos, snap.mass, snap.vel, snap.split, period,
                         dtype=dtype, device=device, vcm_acc=vcm_acc)


def _halos(out: dict, run, halos, wants, eligible, species) -> None:
    for h, want in zip(halos, wants):
        sb, mb, vb, de = compare_halo(program_halo(run, h, species), want,
                                      bool(eligible[h]), species)
        out["solve_diff"] += sb
        out["member_diff"] += mb
        out["vcm_diff"] += vb
        out["derived_err"] = max(out["derived_err"], de)


def _foreign(out: dict, run, snap, n_halos: int) -> bool:
    """A run that is not this snapshot's job counts as wrong throughout."""
    if (run.solve.code.shape[0] != snap.n_halos
            or run.conflicts.igrp.shape[0] != snap.n):
        out["solve_diff"] += n_halos
        out["conflict_diff"] += snap.n
        return True
    return False


def check_job(runs, snap, thresholds, halos, ps, species,
              n_members: int) -> dict:
    """The readings of one job against the reference: ``halos`` sampled,
    the walk over the program's solve."""
    out = empty()
    if len(runs) != len(thresholds):
        out["solve_diff"] += len(halos) * len(thresholds)
    for run, thr in zip(runs, thresholds):
        if _foreign(out, run, snap, len(halos)):
            continue
        rc = reference_conflicts(run, snap)
        out["conflict_diff"] += conflict_diff(run.conflicts, rc)
        out["stats_err"] = max(out["stats_err"], stats_err(
            vars(run.stats), ref.stats(snap.mass, rc)))
        wants = ref.solve_halos(ps, snap.centers[halos], snap.rgtp[halos],
                                thr, n_members, species)
        _halos(out, run, halos, wants, (run.solve.code == 0)
               & ~rc.slurped_own, species)
    return out


def check_whole_job(runs, snap, thresholds, ps, species,
                    n_members: int) -> dict:
    """The readings of one job against the reference: every halo, the walk
    over the reference's own solve."""
    out = empty()
    G = snap.n_halos
    if len(runs) != len(thresholds):
        out["solve_diff"] += G * len(thresholds)
    for run, thr in zip(runs, thresholds):
        if _foreign(out, run, snap, G):
            continue
        wants = ref.solve_halos(ps, snap.centers, snap.rgtp, thr, n_members,
                                species)
        rc = walk_of(wants, snap)
        out["conflict_diff"] += conflict_diff(run.conflicts, rc)
        out["stats_err"] = max(out["stats_err"], stats_err(
            vars(run.stats), ref.stats(snap.mass, rc)))
        codes = np.array([w.code for w in wants])
        _halos(out, run, range(G), wants, (codes == 0) & ~rc.slurped_own,
               species)
    return out


def merge(a: dict, b: dict) -> dict:
    return {k: (max(a[k], b[k]) if isinstance(a[k], float) else a[k] + b[k])
            for k in a}


def check_window(jobs, snaps, thresholds, species, n_members: int, period,
                 check: dict, seed: int, device) -> dict:
    """The readings of the kept jobs, (snapshot index, runs) each, against
    the reference, as the mix's ``check`` says."""
    readings = empty()
    for runs, snap, halos in plan(jobs, snaps, check, seed):
        ps = reference_particles(snap, period, device)
        got = (check_whole_job(runs, snap, thresholds, ps, species,
                               n_members) if halos is None else
               check_job(runs, snap, thresholds, halos, ps, species,
                         n_members))
        del ps
        readings = merge(readings, got)
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return readings


def verdict(readings: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) for every number compared."""
    table = {k: {"value": readings[k], "limit": limits[k]} for k in NUMBERS}
    ok = all(v["value"] <= v["limit"] for v in table.values())
    return ok, table
