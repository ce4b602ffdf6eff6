"""End-to-end SO pipeline (port of so_tpu/engine/pipeline.py).

Stage order preserves the reference's observable semantics:
  1. build the spatial index over all particles            (kdBuildTree)
  2. optional -pot recentring, batched over all halos      (kd2.c:749-761)
  3. batched R_Delta solve for all halos                   (kdRvir)
  4. one fused gather at 2*Rvir: member lists + derived    (kdTagParticles
     quantities                                              + kdVcirc)
  5. mass-ordered conflict pass on the host                (kdSO)
  6. stats                                                 (kdOutStats)

Steps 2-4 read only particle data, which is what makes the batched form
exact; step 5 is sequential and runs in the port's native C pass.
run_so_multi solves several thresholds against shared gathers and runs
steps 4-6 once per threshold. Given a mesh (parallel.make_mesh), both
shard the grid over its devices (parallel.build_sharded_grid); every
stage then gathers through the sharded grid, unchanged. A --distributed
run (parallel/driver.py) drives the same stages on each rank, with the
hooks of _post_solve for the pieces a particle segment cannot do alone.
"""

from __future__ import annotations

import os
import time as _time
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import checkpoint
from ..io.catalogs import GroupCatalog
from ..io.tipsy import ParticleSet
from ..numerics import indexx
from ..ops.grid import CellGrid, build_grid
from ..parallel.mesh import build_sharded_grid
from ..profiling import PhaseTimer, profile_trace, span
from ..stats import RunStats, compute_stats
from .conflicts import ConflictState, resolve_conflicts
from .derived import DerivedResult, compute_derived
from .fused import members_and_derived
from .multi import solve_rvir_multi
from .recenter import recenter_most_bound
from .solver import SolveResult, solve_rvir

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
    b_pot: bool = False                # -pot most-bound recentring
    species: tuple = ()                # subset of (DARK, GAS, STAR, MARK)
    grav: float = 1.0
    verbose: bool = False
    profile_dir: str | None = None     # torch.profiler trace output
    checkpoint: str | None = None      # solve-state save/resume (.npz)
    survey: bool | None = None         # sort-free -1/-2 pre-pass: True
    #                                    forces (--survey), False disables,
    #                                    None auto-gates by sampling
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


def _run_device(params, mesh) -> torch.device:
    """The run's device: the mesh's first device, else params.device."""
    return mesh.device if mesh is not None else resolve_device(params.device)


def _grid_and_centers(particles, catalog, params, dev, timer, grid, mesh):
    """Grid build (unless given; sharded over ``mesh`` if one is given) and
    the optionally recentred centers."""
    if grid is None:
        with timer.phase("grid build"):
            h = particles.header
            kw = dict(vel=particles.vel,
                      phi=particles.phi if params.b_pot else None,
                      mark=particles.mark, period=params.period,
                      center=params.center,
                      species_counts=(h.nsph, h.ndark, h.nstar))
            grid = (build_grid(particles.pos, particles.mass, device=dev,
                               **kw) if mesh is None else
                    build_sharded_grid(particles.pos, particles.mass,
                                       mesh=mesh, **kw))
    centers = np.asarray(catalog.pos, np.float32).copy()
    rgtp = np.asarray(catalog.rgtp, np.float32)
    if params.b_pot:
        with timer.phase("recenter (-pot)"):
            centers = recenter_most_bound(grid, centers, rgtp)
            catalog.pos = centers
    return grid, centers, rgtp


def run_so(particles: ParticleSet, catalog: GroupCatalog, params: SOParams,
           grid: CellGrid | None = None, mesh=None) -> SORun:
    """The single-threshold pipeline. ``grid`` may be a prebuilt grid of
    these particles on the run's device (with phi for -pot); ``mesh``
    shards the grid over the mesh's devices instead, and the run uses them
    (params.device is not read). The run is one span, "run_so", the root
    of its phases' spans (profiling)."""
    dev = _run_device(params, mesh)
    timer = PhaseTimer(device=dev)
    with profile_trace(params.profile_dir, dev), span("run_so"):
        grid, centers, rgtp = _grid_and_centers(particles, catalog, params,
                                                dev, timer, grid, mesh)
        t0 = _time.perf_counter()
        ck = params.checkpoint
        ck_members = digest = None
        if ck is not None:
            # guards resume against a different snapshot/catalog/params
            digest = checkpoint.input_digest(
                particles, centers, rgtp, params.threshold, params.n_members,
                params.period, params.center)
        if ck is not None and os.path.exists(ck):
            with timer.phase("checkpoint resume"):
                solve, ck_members, ck_centers = checkpoint.load_solve(
                    ck, digest)
                centers = np.asarray(ck_centers, np.float32)
                catalog.pos = centers
        else:
            with timer.phase("R_Delta solve"):
                solve = solve_rvir(grid, centers, rgtp, params.threshold,
                                   n_members=params.n_members,
                                   survey=params.survey)
        run = _post_solve(grid, particles, catalog, centers, solve, params,
                          timer, members=ck_members)
        run.solve_seconds = _time.perf_counter() - t0
        if ck is not None and ck_members is None:
            with timer.phase("checkpoint save"):
                checkpoint.save_solve(ck, run.solve, run.members, centers,
                                      digest=digest)
        run.phases = dict(timer.phases)

    if params.verbose:
        timer.report(items={"R_Delta solve": catalog.n,
                            "members + derived (fused)": catalog.n})
    return run


def run_so_multi(particles: ParticleSet, catalog: GroupCatalog,
                 params: SOParams, thresholds,
                 grid: CellGrid | None = None, mesh=None) -> list[SORun]:
    """Multi-threshold pipeline: one grid and one shared-gather solve
    (engine.multi), then the full post-solve per threshold; each SORun
    equals an independent run_so at that threshold. ``grid`` and ``mesh``
    as in run_so; the root span is "run_so_multi", each threshold's
    post-solve a "multi.post" span."""
    dev = _run_device(params, mesh)
    timer = PhaseTimer(device=dev)
    with profile_trace(params.profile_dir, dev), span("run_so_multi"):
        grid, centers, rgtp = _grid_and_centers(particles, catalog, params,
                                                dev, timer, grid, mesh)
        t0 = _time.perf_counter()
        with timer.phase("R_Delta solve (multi)"):
            multi = solve_rvir_multi(grid, centers, rgtp, thresholds,
                                     n_members=params.n_members,
                                     survey=params.survey)
        runs = _post_solve_multi(grid, particles, catalog, centers, multi,
                                 params, timer, t0)
    if params.verbose:
        timer.report()
    return runs


def _post_solve_multi(grid, particles, catalog, centers, multi, params,
                      timer, t0: float, **hooks) -> list[SORun]:
    """_post_solve once per threshold of ``multi`` (a MultiSolveResult),
    each in a "multi.post" span; ``hooks`` are _post_solve's arguments for
    a --distributed rank, ``t0`` the perf_counter the runs' solve_seconds
    count from."""
    runs: list[SORun] = []
    for t in range(multi.code.shape[0]):
        with span("multi.post"):
            run = _post_solve(grid, particles, catalog, centers,
                              multi.at(t), params, timer, **hooks)
        run.solve_seconds = _time.perf_counter() - t0
        runs.append(run)
    for run in runs:
        run.phases = dict(timer.phases)
    return runs


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
                timer, members=None, vcm_fn=None, n_particles=None,
                stats_fn=None, conflict_fn=None,
                member_filter=None) -> SORun:
    """Members, conflicts, derived quantities and stats. ``members`` comes
    from a checkpoint on resume: only the derived pass then gathers.

    The other arguments serve a --distributed rank, which holds only its
    segment of the particles (parallel.driver): ``vcm_fn`` and
    ``member_filter`` go to members_and_derived (``particles``' vel and
    mass are then not read), ``conflict_fn`` takes resolve_conflicts'
    place with the GLOBAL particle count ``n_particles``, and
    ``stats_fn(conflicts)`` compute_stats'. The defaults are the
    single-process run."""
    ok = solve.code == 0
    derived_all = None
    if members is None:
        with timer.phase("members + derived (fused)"):
            # member lists AND derived quantities from ONE gather at
            # 2*Rvir (the interior is a sorted prefix of the kdVcirc ball;
            # kd2.c:511-514 vs 823)
            members_ok, vcm_ok, derived_all = members_and_derived(
                grid, centers[ok], solve.rvir[ok], solve.d2cut[ok],
                solve.j[ok], solve.mvir[ok],
                host_mv=(None if vcm_fn is not None else
                         (particles.vel, particles.mass)),
                n_members=params.n_members, species=tuple(params.species),
                grav=params.grav, vcm_fn=vcm_fn, member_filter=member_filter)
            with span("fused.members_list"):
                members = [None] * catalog.n
                for slot, h in enumerate(np.nonzero(ok)[0]):
                    members[h] = members_ok[slot]
                solve.vcm[ok] = vcm_ok  # _VcmParticles (kd2.c:595-609)

    with timer.phase("conflict protocol"):
        # ascending input-mass order (kdSortMass, kd2.c:843-861)
        with span("conflicts.order"):
            order = indexx(np.asarray(catalog.gtp_mass, np.float32))
        conflicts = (conflict_fn or resolve_conflicts)(
            catalog.index, centers, solve.mvir, solve.rvir, solve.code,
            order, members,
            particles.n if n_particles is None else n_particles)

    eligible = ok & ~conflicts.slurped_own  # kdSO eligibility (kd2.c:884)
    with timer.phase("derived quantities"):
        if derived_all is not None:
            # zero the ineligible (slurped-own) rows — kdVcirc skip,
            # kd2.c:884
            derived = _scatter_derived(derived_all, np.nonzero(ok)[0],
                                       eligible, catalog.n,
                                       tuple(params.species))
        else:
            derived = compute_derived(grid, centers, solve.rvir, solve.mvir,
                                      solve.j, eligible,
                                      n_members=params.n_members,
                                      species=tuple(params.species),
                                      grav=params.grav)

    with timer.phase("stats"):
        stats = (stats_fn(conflicts) if stats_fn is not None else
                 compute_stats(np.asarray(particles.mass), conflicts.igrp,
                               conflicts.n_subsumed, conflicts.n_ignored,
                               conflicts.mvir, conflicts.groups_removed,
                               conflicts.groups_slurped))

    return SORun(catalog=catalog, solve=solve, conflicts=conflicts,
                 derived=derived, stats=stats, order=order, members=members)
