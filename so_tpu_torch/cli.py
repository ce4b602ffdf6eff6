"""Command-line entry point (port of so_tpu/cli.py, the single-threshold set).

Takes the reference's flags with so_tpu's semantics and defaults:
-i -o -z -O -L -s -rho -delta -m -p -c -cx -cy -cz -std -M -u -list -grp
-gtp -subsumed -ignored -stat -mark -dark -gas -star -all, plus --tipsy
and --verbose. ``--device {cuda,cpu}`` (default cuda) picks the device;
without a usable CUDA card a cuda run fails instead of moving to the CPU.

so_tpu options that are not ported yet (-pot, --survey, --deltas,
--checkpoint, --profile, --mesh, --distributed) exit with status 1 and a
one-line message naming their ROADMAP.md item.
"""

from __future__ import annotations

import sys
import time as _time

import numpy as np

from so_tpu.cosmology import rhovir_over_rhobar
from so_tpu.io.catalogs import read_gtp_list, read_mark, read_stat
from so_tpu.io.tipsy import DARK, GAS, STAR, MARK, read_tipsy
from so_tpu.io.writers import (SPECIES_EXT, write_array_file,
                               write_profile_file, write_sogtp,
                               write_sovcirc_header, write_sovcirc_rows)
from so_tpu.stats import format_stats
from so_tpu.units import unit_conversions
from so_tpu.version import __version__

from .engine.pipeline import SOParams, not_ported, run_so

BANNER = (f"so_tpu_torch {__version__} (PyTorch/CUDA SO engine; "
          "reference parity: SO 1.7)")

USAGE = """USAGE:
python -m so_tpu_torch -i <SKID .gtp file> [-o <outfilebase>]
      [([-dark] [-gas] [-star]) || [-all])]
      [-mark <markfile>]  [-std]  [-grp] [-gtp] [-subsumed] [-ignored]
      [-list <File containing group indexes>]
      [-stat <SKID .stat file containing most-bound-particle positions>]
      [-delta <fThreshold>] [-M <fMinGTPMass>] [-m <mMinSOMembers>]
      [-O <fOmega0>]  [-L]  [-z <fRedshift>]  [-s <nSmooth>]
      [-p <xyzPeriod>]  [-c <xyzCenter>]
      [-cx <xCenter>]  [-cy <yCenter>]  [-cz <zCenter>]
      [-u <fMassUnit> <fMpcUnit>]
      [--tipsy <snapshot>] [--verbose] [--device {cuda,cpu}]

Spherical-overdensity halo characterization on PyTorch (CUDA kernels on
an NVIDIA GPU, or the plain torch versions with --device cpu). Flags and
outputs follow so_tpu; see `python -m so_tpu` for their descriptions.
Not yet in this package: -pot, --survey, --deltas, --checkpoint,
--profile, --mesh, --distributed.
"""


def usage(out=sys.stderr) -> "NoReturn":
    out.write(USAGE)
    raise SystemExit(1)


def refuse(option: str) -> "NoReturn":
    sys.stderr.write(not_ported(option) + "\n")
    raise SystemExit(1)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    print(BANNER, file=sys.stderr)

    # defaults — so.c:213-263
    b_standard = False
    b_threshold = False
    f_threshold = 0.0
    f_min_mass = 0.0
    n_members = 8
    f_redshift = -9.9999
    b_redshift = False
    f_mass_unit = -9.9
    f_mpc_unit = -9.9
    f_omega = 1.0
    f_lambda = 0.0
    b_lambda = False
    b_periodic = 1
    f_period = [1.0, 1.0, 1.0]
    f_center = [0.0, 0.0, 0.0]
    grav = 1.0                  # fixed and unused — so.c:245-247
    b_dark = b_gas = b_star = b_mark = False
    b_grp = b_gtp = b_subsumed = b_ignored = False
    gtp_file = list_file = out_base = mark_file = stat_file = None
    tipsy_file = None
    verbose = False
    device = "cuda"

    def need(i):
        if i >= len(argv):
            usage()
        return argv[i]

    def ffloat(s):
        # the reference parses every numeric flag into a C float (so.c:200);
        # round through float32 so downstream double math sees the same value
        return float(np.float32(float(s)))

    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-i":
            i += 1; gtp_file = need(i); i += 1
        elif a == "-o":
            i += 1; out_base = need(i); i += 1
        elif a == "-z":
            i += 1; b_redshift = True; f_redshift = ffloat(need(i)); i += 1
        elif a == "-O":
            i += 1; f_omega = ffloat(need(i)); i += 1
        elif a == "-L":
            i += 1; b_lambda = True
        elif a == "-s":
            i += 1; int(need(i)); i += 1   # nSmooth: parsed, unused
        elif a == "-rho":
            sys.stderr.write("-rho option is no longer availible.  Use -delta instead.\n")
            usage()
        elif a == "-delta":
            i += 1; f_threshold = ffloat(need(i)); b_threshold = True; i += 1
        elif a == "-m":
            i += 1; n_members = int(need(i)); i += 1
        elif a == "-p":
            i += 1; v = ffloat(need(i)); f_period = [v, v, v]; b_periodic = 1; i += 1
        elif a == "-c":
            i += 1; v = ffloat(need(i)); f_center = [v, v, v]; i += 1
        elif a == "-cx":
            i += 1; f_center[0] = ffloat(need(i)); i += 1
        elif a == "-cy":
            i += 1; f_center[1] = ffloat(need(i)); i += 1
        elif a == "-cz":
            i += 1; f_center[2] = ffloat(need(i)); i += 1
        elif a == "-std":
            b_standard = True; i += 1
        elif a == "-M":
            i += 1; f_min_mass = ffloat(need(i)); i += 1
        elif a == "-u":
            i += 1; f_mass_unit = ffloat(need(i)); i += 1
            f_mpc_unit = ffloat(need(i)); i += 1
        elif a == "-list":
            i += 1; list_file = need(i); i += 1
        elif a == "-grp":
            b_grp = True; i += 1
        elif a == "-gtp":
            b_gtp = True; i += 1
        elif a == "-subsumed":
            b_subsumed = True; i += 1
        elif a == "-ignored":
            b_ignored = True; i += 1
        elif a == "-stat":
            i += 1; stat_file = need(i); i += 1
        elif a == "-mark":
            i += 1; mark_file = need(i); b_mark = True; i += 1
        elif a == "-dark":
            b_dark = True; i += 1
        elif a == "-gas":
            b_gas = True; i += 1
        elif a == "-star":
            b_star = True; i += 1
        elif a == "-all":
            b_dark = b_gas = b_star = True; i += 1
        elif a == "--tipsy":
            i += 1; tipsy_file = need(i); i += 1
        elif a == "--verbose":
            verbose = True; i += 1
        elif a == "--device":
            i += 1; device = need(i); i += 1
            if device not in ("cuda", "cpu"):
                sys.stderr.write("--device expects cuda or cpu\n")
                raise SystemExit(1)
        elif a in ("-pot", "--survey", "--deltas", "--checkpoint",
                   "--profile", "--mesh", "--distributed"):
            refuse(a)
        else:
            usage()

    if gtp_file is None:
        usage()
    if out_base is None:
        out_base = "so"
    if b_lambda:
        f_lambda = 1.0 - f_omega

    def checked(fn, *a, name=None):
        """File-error contract of kdCheckFile (kd2.c:24-30): message + exit 1."""
        try:
            return fn(*a)
        except (FileNotFoundError, IsADirectoryError, PermissionError):
            sys.stderr.write(f"ERROR opening file {name or a[0]}\n")
            raise SystemExit(1)

    # snapshot from stdin (so.c:457) or --tipsy
    src = tipsy_file if tipsy_file is not None else sys.stdin.buffer
    particles = checked(read_tipsy, src, b_standard,
                        name=tipsy_file or "stdin")
    h = particles.header
    # the reference stores the header time in a float (kd->fTime, kd2.h:119);
    # the redshift default and the .sogtp header inherit that rounding
    f_time = float(np.float32(h.time))
    sys.stderr.write(f"nDark:{h.ndark} nGas:{h.nsph} nStar:{h.nstar}\n")
    sys.stderr.write(f"Read {particles.n} particles from TIPSY file.\n")

    if b_mark:
        particles.mark, nmark = checked(read_mark, mark_file, particles.n)
        sys.stderr.write(f"{nmark} mark particles read from {mark_file}\n")

    if not b_redshift:
        f_redshift = float(np.float32(1.0 / f_time - 1.0))   # so.c:470-472

    if not b_threshold:
        f_threshold = rhovir_over_rhobar(f_omega, b_lambda, f_redshift) * f_omega
    else:
        f_threshold *= f_omega            # so.c:479-481

    run_time = _time.time()
    catalog = checked(read_gtp_list, gtp_file, list_file, f_min_mass,
                      b_standard)
    sys.stderr.write(f"Read {catalog.n} groups to process.\n")

    if stat_file is not None:
        nrep = checked(read_stat, catalog, stat_file, name=stat_file)
        sys.stderr.write(f"Replaced {nrep} group centers.\n")
        if nrep != catalog.n:
            sys.stderr.write("ERROR in reading .stat file!\n")
            raise SystemExit(1)

    species = tuple(sp for sp, on in
                    ((DARK, b_dark), (GAS, b_gas), (STAR, b_star), (MARK, b_mark))
                    if on)
    units = unit_conversions(f_mass_unit, f_mpc_unit, f_redshift)

    params = SOParams(threshold=float(np.float32(f_threshold)),
                      n_members=n_members,
                      period=tuple(f_period), center=tuple(f_center),
                      species=species, grav=grav, verbose=verbose,
                      device=device)
    run = run_so(particles, catalog, params)

    with open(f"{out_base}.sovcirc", "w") as fp_out:
        write_sovcirc_header(fp_out, run_time, gtp_file, list_file,
                             stat_file, np.float32(f_threshold), b_threshold,
                             f_redshift, f_omega, f_lambda, b_periodic,
                             f_period, f_center, f_min_mass, n_members, False,
                             f_mass_unit, f_mpc_unit)
        # stats to stderr and the catalog file (kdOutStats)
        sys.stderr.write(format_stats(run.stats, for_file=False))
        fp_out.write(format_stats(run.stats, for_file=True))
        for sp in (DARK, GAS, STAR, MARK):
            if sp in species:
                write_profile_file(f"{out_base}.{SPECIES_EXT[sp]}", fp_out,
                                   run_time, sp, catalog.index,
                                   run.derived.profiles[sp], units)
        write_sovcirc_rows(fp_out, catalog.index, run.mvir, run.rvir,
                           run.derived.rmass, run.derived.rmax,
                           run.derived.vmax, run.derived.vcirc, units)
    if b_grp:
        write_array_file(f"{out_base}.sogrp", run.conflicts.igrp)
    if b_gtp:
        write_sogtp(f"{out_base}.sogtp", f_time, catalog.n_in_gtp,
                    catalog.index, run.mvir, run.rvir, catalog.pos,
                    run.solve.vcm, b_standard)
    if b_subsumed:
        write_array_file(f"{out_base}.sosub", run.conflicts.n_subsumed)
    if b_ignored:
        write_array_file(f"{out_base}.soign", run.conflicts.n_ignored)

    sec = int(run.solve_seconds)
    usec = int((run.solve_seconds - sec) * 1e6)
    sys.stderr.write("SO CPU Time:")
    sys.stderr.write("   %d.%06d\n\n" % (sec, usec))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
