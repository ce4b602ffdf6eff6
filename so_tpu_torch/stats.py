"""Run statistics — reference: kdOutStats (kd2.c:1334-1415). (Copy of
so_tpu/stats.py, so the port imports nothing of the JAX package.)

The subsume/ignore bookkeeping is load-bearing science QA (mass-deviation
check between halo-mass sum and tagged-particle-mass sum); the text blocks
are reproduced verbatim for both stderr and the .sovcirc '#' comments
(including the stderr/file wording difference on the last line:
"Mass Deviation (particles/groups-1)" vs "Percentage difference",
kd2.c:1390-1391 vs 1412-1413).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class RunStats:
    cum_particles_subsumed: int
    particles_subsumed: int
    cum_mass_subsumed: float
    mass_subsumed: float
    cum_particles_ignored: int
    particles_ignored: int
    cum_mass_ignored: float
    mass_ignored: float
    groups_removed: int
    groups_slurped: int
    particle_mass_sum: float
    halo_mass_sum: float

    @property
    def mass_deviation(self) -> float:
        with np.errstate(divide="ignore", invalid="ignore"):
            return float(np.float64(self.halo_mass_sum)
                         / np.float64(self.particle_mass_sum) - 1.0)


def compute_stats(mass: np.ndarray, igrp: np.ndarray, n_subsumed: np.ndarray,
                  n_ignored: np.ndarray, mvir: np.ndarray,
                  groups_removed: int, groups_slurped: int) -> RunStats:
    from .native import stats_pass_native

    out = stats_pass_native(mass, igrp, n_subsumed, n_ignored)
    if out is not None:
        # single C sweep with sequential f64 accumulation (the
        # reference's kdOutStats association, kd2.c:1334-1415) — ~10
        # numpy passes cost multiple seconds at 10^7+ particles on
        # memory-bandwidth-poor hosts
        f, i = out
        return RunStats(
            cum_particles_subsumed=int(i[0]), particles_subsumed=int(i[1]),
            cum_mass_subsumed=float(f[0]), mass_subsumed=float(f[1]),
            cum_particles_ignored=int(i[2]), particles_ignored=int(i[3]),
            cum_mass_ignored=float(f[2]), mass_ignored=float(f[3]),
            groups_removed=int(groups_removed),
            groups_slurped=int(groups_slurped),
            particle_mass_sum=float(f[4]),
            halo_mass_sum=float(np.maximum(mvir.astype(np.float64),
                                           0.0).sum()))
    mass64 = mass.astype(np.float64)
    subbed = n_subsumed > 0
    ignored = n_ignored > 0
    return RunStats(
        cum_particles_subsumed=int(n_subsumed.sum()),
        particles_subsumed=int(subbed.sum()),
        cum_mass_subsumed=float((mass64 * n_subsumed).sum()),
        mass_subsumed=float(mass64[subbed].sum()),
        cum_particles_ignored=int(n_ignored.sum()),
        particles_ignored=int(ignored.sum()),
        cum_mass_ignored=float((mass64 * n_ignored).sum()),
        mass_ignored=float(mass64[ignored].sum()),
        groups_removed=int(groups_removed),
        groups_slurped=int(groups_slurped),
        particle_mass_sum=float(mass64[igrp > 0].sum()),
        halo_mass_sum=float(np.maximum(mvir.astype(np.float64), 0.0).sum()),
    )


_BODY = """{p}STATS:
{p} PARTICLES:
{p}  Particles subsumed into larger groups (cumulative):  {s.cum_particles_subsumed}
{p}  Particles subsumed into larger groups at least once: {s.particles_subsumed}
{p}  Mass subsumed into larger groups (cumulative):       {cms:g}
{p}  Mass subsumed into larger groups at least once:      {ms:g}
{p}  Particles retained by small groups in the face of adversity (cumulative):  {s.cum_particles_ignored}
{p}  Particles retained by small groups in the face of adversity at least once: {s.particles_ignored}
{p}  Mass retained by smaller groups in the face of adversity (cumulative):     {cmi:g}
{p}  Mass retained by smaller groups in the face of adversity at least once:    {mi:g}
{p} GROUPS:
{p}  Groups subsumed into larger groups (cumulative):  {s.groups_removed}
{p}  Groups 'slurped' into larger groups (cumulative): {s.groups_slurped}
"""


def format_stats(s: RunStats, for_file: bool) -> str:
    p = "#" if for_file else ""
    head = "" if for_file else "\n"
    body = head + _BODY.format(p=p, s=s, cms=s.cum_mass_subsumed,
                               ms=s.mass_subsumed, cmi=s.cum_mass_ignored,
                               mi=s.mass_ignored)
    if for_file:
        body += ("#  Total Mass of .sogrp particles in halos: %g\n"
                 "#  Total Mass of Groups:                    %g\n"
                 "#  Percentage difference:                   %g\n"
                 % (s.particle_mass_sum, s.halo_mass_sum, s.mass_deviation))
    else:
        body += ("  Total Mass of .sogrp particles in halos: %g\n"
                 "  Total Mass of groups:                    %g\n"
                 "  Mass Deviation (particles/groups-1):     %g\n"
                 % (s.particle_mass_sum, s.halo_mass_sum, s.mass_deviation))
    return body
