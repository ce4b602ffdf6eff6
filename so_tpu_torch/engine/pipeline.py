"""End-to-end single-threshold SO pipeline (port of so_tpu/engine/pipeline.py).

Stage order preserves the reference's observable semantics:
  1. build the spatial index over all particles            (kdBuildTree)
  2. batched R_Delta solve for all halos                   (kdRvir)
  3. one fused gather at 2*Rvir: member lists + derived    (kdTagParticles
     quantities                                              + kdVcirc)
  4. mass-ordered conflict pass on the host                (kdSO)
  5. stats                                                 (kdOutStats)

Steps 2-3 read only particle data, which is what makes the batched form
exact; step 4 is sequential and runs in so_tpu's native C pass.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass, field

import numpy as np
import torch

from so_tpu.io.catalogs import GroupCatalog
from so_tpu.io.tipsy import ParticleSet
from so_tpu.numerics import indexx
from so_tpu.stats import RunStats, compute_stats

from ..ops.grid import build_grid
from ..profiling import PhaseTimer
from .conflicts import ConflictState, resolve_conflicts
from .derived import DerivedResult
from .fused import members_and_derived
from .solver import SolveResult, solve_rvir

# options of so_tpu that this package does not run yet -> ROADMAP.md item
NOT_PORTED = {
    "-pot": 9,
    "--survey": 10,
    "--deltas": 11,
    "--checkpoint": 12,
    "--profile": 13,
    "--mesh": 16,
    "--distributed": 16,
}


def not_ported(option: str) -> str:
    return (f"{option} is not yet in so_tpu_torch "
            f"(ROADMAP.md section 1, item {NOT_PORTED[option]})")


def resolve_device(device) -> torch.device:
    """The run's device. A CUDA request without a usable card raises:
    the port never moves a run to the CPU unless asked to."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch sees no CUDA "
                           "device; pass --device cpu to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@dataclass
class SOParams:
    """Engine parameters (CLI defaults mirror so.c:213-263)."""
    threshold: float = 178.0           # density in box units (already * Omega)
    n_members: int = 8
    period: tuple = (1.0, 1.0, 1.0)
    center: tuple = (0.0, 0.0, 0.0)
    b_pot: bool = False                # not ported: raises
    species: tuple = ()                # subset of (DARK, GAS, STAR, MARK)
    grav: float = 1.0
    verbose: bool = False
    profile_dir: str | None = None     # not ported: raises
    checkpoint: str | None = None      # not ported: raises
    survey: bool | None = None         # True (forced pre-pass) raises;
    #                                    None/False run the plain solve
    device: str = "cuda"               # "cuda" or "cpu"


@dataclass
class SORun:
    """Everything the writers and stats need."""
    catalog: GroupCatalog              # with final centers
    solve: SolveResult                 # pre-conflict Mvir/Rvir/j/vcm
    conflicts: ConflictState           # final igrp / counters / mutated Mvir,Rvir
    derived: DerivedResult
    stats: RunStats
    order: np.ndarray                  # processing order (ascending GTP mass)
    solve_seconds: float = 0.0
    members: list | None = None        # per-halo sorted interior lists
    phases: dict = field(default_factory=dict)   # PhaseTimer seconds

    # catalog-facing columns (post-conflict)
    @property
    def mvir(self):
        return self.conflicts.mvir

    @property
    def rvir(self):
        return self.conflicts.rvir


def _check_ported(params: SOParams) -> None:
    for on, option in ((params.b_pot, "-pot"),
                       (params.checkpoint is not None, "--checkpoint"),
                       (params.profile_dir is not None, "--profile"),
                       (params.survey is True, "--survey")):
        if on:
            raise NotImplementedError(not_ported(option))


def run_so(particles: ParticleSet, catalog: GroupCatalog,
           params: SOParams) -> SORun:
    _check_ported(params)
    dev = resolve_device(params.device)
    timer = PhaseTimer(device=dev)
    with timer.phase("grid build"):
        grid = build_grid(
            particles.pos, particles.mass, vel=particles.vel,
            ptype=particles.ptype_all(), mark=particles.mark,
            period=params.period, center=params.center, device=dev)

    centers = np.asarray(catalog.pos, np.float32).copy()
    rgtp = np.asarray(catalog.rgtp, np.float32)

    t0 = _time.perf_counter()
    with timer.phase("R_Delta solve"):
        solve = solve_rvir(grid, centers, rgtp, params.threshold,
                           n_members=params.n_members)
    run = _post_solve(grid, particles, catalog, centers, solve, params, timer)
    run.solve_seconds = _time.perf_counter() - t0
    run.phases = dict(timer.phases)

    if params.verbose:
        timer.report(items={"R_Delta solve": catalog.n,
                            "members + derived (fused)": catalog.n})
    return run


def _scatter_derived(src, ok_rows, eligible, n, species):
    """Fused-stage rows (over the solved subset) -> catalog-order
    DerivedResult with ineligible rows zeroed."""
    out = DerivedResult.zeros(n, species)
    keep = eligible[ok_rows]
    dst = ok_rows[keep]
    out.vcirc[dst] = src.vcirc[keep]
    out.rmass[dst] = src.rmass[keep]
    out.rmax[dst] = src.rmax[keep]
    out.vmax[dst] = src.vmax[keep]
    for sp in species:
        out.profiles[sp][dst] = src.profiles[sp][keep]
    return out


def _post_solve(grid, particles, catalog, centers, solve, params,
                timer) -> SORun:
    ok = solve.code == 0
    with timer.phase("members + derived (fused)"):
        # member lists AND derived quantities from ONE gather at 2*Rvir
        # (the interior is a sorted prefix of the kdVcirc ball;
        # kd2.c:511-514 vs 823)
        members_ok, vcm_ok, derived_all = members_and_derived(
            grid, centers[ok], solve.rvir[ok], solve.j[ok], solve.mvir[ok],
            host_mv=(particles.vel, particles.mass),
            n_members=params.n_members, species=tuple(params.species),
            grav=params.grav)
        members = [None] * catalog.n
        for slot, h in enumerate(np.nonzero(ok)[0]):
            members[h] = members_ok[slot]
        solve.vcm[ok] = vcm_ok  # _VcmParticles (kd2.c:595-609)

    with timer.phase("conflict protocol"):
        # ascending input-mass order (kdSortMass, kd2.c:843-861)
        order = indexx(np.asarray(catalog.gtp_mass, np.float32))
        conflicts = resolve_conflicts(catalog.index, centers, solve.mvir,
                                      solve.rvir, solve.code, order, members,
                                      particles.n)

    eligible = ok & ~conflicts.slurped_own  # kdSO eligibility (kd2.c:884)
    with timer.phase("derived quantities"):
        # zero the ineligible (slurped-own) rows — kdVcirc skip, kd2.c:884
        derived = _scatter_derived(derived_all, np.nonzero(ok)[0], eligible,
                                   catalog.n, tuple(params.species))

    with timer.phase("stats"):
        stats = compute_stats(np.asarray(particles.mass), conflicts.igrp,
                              conflicts.n_subsumed, conflicts.n_ignored,
                              conflicts.mvir, conflicts.groups_removed,
                              conflicts.groups_slurped)

    return SORun(catalog=catalog, solve=solve, conflicts=conflicts,
                 derived=derived, stats=stats, order=order, members=members)
