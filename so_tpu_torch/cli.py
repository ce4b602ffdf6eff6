"""Command-line entry point (port of so_tpu/cli.py).

Takes the reference's flags with so_tpu's semantics and defaults:
-i -o -z -O -L -s -rho -delta -m -p -c -cx -cy -cz -std -M -u -list -grp
-gtp -subsumed -ignored -pot -stat -mark -dark -gas -star -all, plus
so_tpu's --tipsy, --verbose, --deltas, --survey, --checkpoint, --profile,
--mesh and --distributed. ``--device {cuda,cuda:N,cpu}`` (default cuda)
picks the device; without a usable CUDA card a cuda run fails instead of
moving to the CPU. ``--mesh HxP`` shards the run over H x P devices
(parallel/mesh.py): the first H * P CUDA devices, or H * P times the CPU
with --device cpu.

``--distributed`` makes the process one rank of a torch.distributed group
(parallel/driver.py): start the same command on every rank with
torchrun's variables set (``torchrun --nproc-per-node W -m so_tpu_torch
... --distributed``, or MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK and
LOCAL_RANK by hand). Each rank reads only its segment of the --tipsy
snapshot; "cuda" is the card LOCAL_RANK. ``--dist-backend`` names the
torch.distributed backend: by default "gloo" with --device cpu and
"cpu:gloo,cuda:nccl" (NCCL for the card's tensors, one card a rank) on a
card; "gloo" lets several ranks share a card.
"""

from __future__ import annotations

import sys
import time as _time

import numpy as np

from .cosmology import rhovir_over_rhobar
from .engine.pipeline import SOParams, run_so, run_so_multi
from .io.catalogs import read_gtp_list, read_mark, read_stat
from .io.tipsy import DARK, GAS, STAR, MARK, read_header, read_tipsy
from .io.writers import (SPECIES_EXT, write_array_file, write_profile_file,
                         write_sogtp, write_sovcirc_header,
                         write_sovcirc_rows)
from .parallel import make_mesh
from .stats import format_stats
from .units import unit_conversions
from .version import BANNER

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
      [-u <fMassUnit> <fMpcUnit>]  [-pot]
      [--tipsy <snapshot>] [--verbose] [--device {cuda,cuda:N,cpu}]
      [--deltas <d1,d2,...>] [--survey] [--checkpoint <state.npz>]
      [--profile <logdir>] [--mesh HxP]
      [--distributed [--dist-backend <torch.distributed backend>]]

Spherical-overdensity halo characterization on PyTorch (CUDA kernels on
an NVIDIA GPU, or the plain torch versions with --device cpu). Flags and
outputs follow so_tpu; see `python -m so_tpu` for their descriptions.
--distributed runs one rank of a torchrun job (MASTER_ADDR, MASTER_PORT,
WORLD_SIZE, RANK, LOCAL_RANK), reading only its snapshot segment.
"""


def usage(out=None) -> "NoReturn":
    """Write the usage text to ``out`` (sys.stderr as it is at the call)
    and exit 1."""
    (sys.stderr if out is None else out).write(USAGE)
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
    b_pot = b_survey = False
    deltas = checkpoint = profile_dir = mesh_shape = None
    b_distributed = False
    dist_backend = None

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
        elif a == "-pot":
            b_pot = True; i += 1
            if stat_file is not None:
                usage()
        elif a == "-subsumed":
            b_subsumed = True; i += 1
        elif a == "-ignored":
            b_ignored = True; i += 1
        elif a == "-stat":
            i += 1; stat_file = need(i); i += 1
            if b_pot:
                usage()
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
            if device not in ("cuda", "cpu") and not (
                    device.startswith("cuda:") and device[5:].isdigit()):
                sys.stderr.write("--device expects cuda, cuda:N or cpu\n")
                raise SystemExit(1)
        elif a == "--profile":
            i += 1; profile_dir = need(i); i += 1
        elif a == "--checkpoint":
            i += 1; checkpoint = need(i); i += 1
        elif a == "--deltas":
            # one full output set per threshold (<base>.d<delta>.*), all
            # solved against shared gathers (engine/multi.py)
            i += 1; deltas = [ffloat(x) for x in need(i).split(",")]; i += 1
        elif a == "--survey":
            b_survey = True; i += 1
        elif a == "--mesh":
            # halo x part device mesh (parallel/mesh.py run_so_sharded)
            i += 1
            try:
                mesh_shape = tuple(int(x) for x in need(i).split("x"))
            except ValueError:
                mesh_shape = ()
            if len(mesh_shape) != 2 or min(mesh_shape) < 1:
                sys.stderr.write("--mesh expects HxP, e.g. --mesh 2x4\n")
                raise SystemExit(1)
            i += 1
        elif a == "--distributed":
            # one rank of a torch.distributed job (parallel/driver.py)
            b_distributed = True; i += 1
        elif a == "--dist-backend":
            i += 1; dist_backend = need(i); i += 1
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

    is_p0 = True
    transport = None
    if b_distributed:
        # each rank reads its own segment of the snapshot: here the header
        # only (the counts)
        if tipsy_file is None:
            sys.stderr.write("--distributed requires --tipsy <file> "
                             "(snapshot segments are seek-read per rank)\n")
            raise SystemExit(1)
        if mesh_shape is not None:
            # the rank's mesh comes from the process layout
            sys.stderr.write("--distributed cannot be combined with --mesh\n")
            raise SystemExit(1)
        from .parallel.distributed import (TorchTransport, default_backend,
                                           init_distributed, rank_device)

        backend = dist_backend or default_backend(device)
        if not init_distributed(backend):
            sys.stderr.write(
                "--distributed: no coordinator configured (set MASTER_ADDR, "
                "MASTER_PORT, WORLD_SIZE, RANK and LOCAL_RANK, or start "
                "the ranks with torchrun)\n")
            raise SystemExit(1)
        dev = rank_device(device)
        transport = TorchTransport()
        is_p0 = transport.pid == 0
        sys.stderr.write(f"--distributed: rank {transport.pid} of "
                         f"{transport.nproc} on {dev}, backend {backend}\n")
        with open(tipsy_file, "rb") as fp:
            h = checked(read_header, fp, b_standard, name=tipsy_file)
        particles = None
        n_particles = h.nbodies
    else:
        # snapshot from stdin (so.c:457) or --tipsy
        src = tipsy_file if tipsy_file is not None else sys.stdin.buffer
        particles = checked(read_tipsy, src, b_standard,
                            name=tipsy_file or "stdin")
        h = particles.header
        n_particles = particles.n
    # the reference stores the header time in a float (kd->fTime, kd2.h:119);
    # the redshift default and the .sogtp header inherit that rounding
    f_time = float(np.float32(h.time))
    if is_p0:
        sys.stderr.write(f"nDark:{h.ndark} nGas:{h.nsph} nStar:{h.nstar}\n")
        sys.stderr.write(f"Read {n_particles} particles from TIPSY file.\n")

    mask = None
    if b_mark:
        # the mask of every particle; a rank keeps its segment's
        mask, nmark = checked(read_mark, mark_file, n_particles)
        if particles is not None:
            particles.mark = mask
        if is_p0:
            sys.stderr.write(f"{nmark} mark particles read from "
                             f"{mark_file}\n")

    if not b_redshift:
        f_redshift = float(np.float32(1.0 / f_time - 1.0))   # so.c:470-472

    if not b_threshold:
        f_threshold = rhovir_over_rhobar(f_omega, b_lambda, f_redshift) * f_omega
    else:
        f_threshold *= f_omega            # so.c:479-481

    run_time = _time.time()
    catalog = checked(read_gtp_list, gtp_file, list_file, f_min_mass,
                      b_standard)
    if is_p0:
        sys.stderr.write(f"Read {catalog.n} groups to process.\n")

    if stat_file is not None:
        nrep = checked(read_stat, catalog, stat_file, name=stat_file)
        if is_p0:
            sys.stderr.write(f"Replaced {nrep} group centers.\n")
        if nrep != catalog.n:
            sys.stderr.write("ERROR in reading .stat file!\n")
            raise SystemExit(1)

    species = tuple(sp for sp, on in
                    ((DARK, b_dark), (GAS, b_gas), (STAR, b_star), (MARK, b_mark))
                    if on)
    units = unit_conversions(f_mass_unit, f_mpc_unit, f_redshift)

    if checkpoint is not None and mesh_shape is not None:
        # the sharded run has no resume: refuse rather than run
        # uncheckpointed
        sys.stderr.write("--mesh with --checkpoint is not supported yet\n")
        raise SystemExit(1)
    if checkpoint is not None and deltas is not None:
        # run_so_multi never reads params.checkpoint: refuse rather than
        # run uncheckpointed
        sys.stderr.write("--deltas with --checkpoint is not supported yet\n")
        raise SystemExit(1)
    # --survey forces the classifier pre-pass; without it the engine
    # auto-gates the pass by sampling (engine/solver.py SURVEY_*)
    params = SOParams(threshold=float(np.float32(f_threshold)),
                      n_members=n_members,
                      period=tuple(f_period), center=tuple(f_center),
                      b_pot=b_pot, species=species, grav=grav,
                      verbose=verbose, profile_dir=profile_dir,
                      checkpoint=checkpoint,
                      survey=True if b_survey else None, device=device)

    mesh = None
    if mesh_shape is not None:
        n_dev = mesh_shape[0] * mesh_shape[1]
        try:
            mesh = make_mesh(*mesh_shape, devices=(
                ["cpu"] * n_dev if device == "cpu" else None))
        except RuntimeError as e:
            sys.stderr.write(f"--mesh {mesh_shape[0]}x{mesh_shape[1]}: "
                             f"{e}\n")
            raise SystemExit(1)

    def write_particle_array(path, run, field):
        """A per-particle tipsy-array file. Under --distributed the
        conflict state holds the rank's segment only and every rank writes
        its byte range (called on every rank)."""
        vals = getattr(run.conflicts, field)
        if transport is not None:
            from .parallel.driver import write_array_file_segments

            write_array_file_segments(path, vals, run.conflicts.n_global,
                                      transport)
        else:
            write_array_file(path, vals)

    def write_outputs(base, run, threshold, threshold_user):
        """Catalog files by rank 0, per-particle files by every rank."""
        if is_p0:
            with open(f"{base}.sovcirc", "w") as fp_out:
                write_sovcirc_header(fp_out, run_time, gtp_file, list_file,
                                     stat_file, np.float32(threshold),
                                     threshold_user, f_redshift, f_omega,
                                     f_lambda, b_periodic, f_period,
                                     f_center, f_min_mass, n_members, b_pot,
                                     f_mass_unit, f_mpc_unit)
                # stats to stderr and the catalog file (kdOutStats)
                sys.stderr.write(format_stats(run.stats, for_file=False))
                fp_out.write(format_stats(run.stats, for_file=True))
                for sp in (DARK, GAS, STAR, MARK):
                    if sp in species:
                        write_profile_file(f"{base}.{SPECIES_EXT[sp]}",
                                           fp_out, run_time, sp,
                                           catalog.index,
                                           run.derived.profiles[sp], units)
                write_sovcirc_rows(fp_out, catalog.index, run.mvir,
                                   run.rvir, run.derived.rmass,
                                   run.derived.rmax, run.derived.vmax,
                                   run.derived.vcirc, units)
        if b_grp:
            write_particle_array(f"{base}.sogrp", run, "igrp")
        if b_gtp and is_p0:
            write_sogtp(f"{base}.sogtp", f_time, catalog.n_in_gtp,
                        catalog.index, run.mvir, run.rvir, catalog.pos,
                        run.solve.vcm, b_standard)
        if b_subsumed:
            write_particle_array(f"{base}.sosub", run, "n_subsumed")
        if b_ignored:
            write_particle_array(f"{base}.soign", run, "n_ignored")

    if deltas is not None:
        thresholds = [float(np.float32(d * np.float32(f_omega)))
                      for d in deltas]
        if transport is not None:
            from .parallel.driver import run_so_multi_distributed

            runs = run_so_multi_distributed(
                tipsy_file, catalog, params, thresholds,
                standard=b_standard, mark_mask=mask, transport=transport)
        else:
            runs = run_so_multi(particles, catalog, params, thresholds,
                                mesh=mesh)
        for d, thr, run in zip(deltas, thresholds, runs):
            dstr = ("%g" % d).replace("+", "")
            write_outputs(f"{out_base}.d{dstr}", run, thr, True)
        solve_seconds = runs[-1].solve_seconds if runs else 0.0
    else:
        if transport is not None:
            from .parallel.driver import run_so_distributed

            run = run_so_distributed(tipsy_file, catalog, params,
                                     standard=b_standard, mark_mask=mask,
                                     transport=transport)
        else:
            run = run_so(particles, catalog, params, mesh=mesh)
        write_outputs(out_base, run, f_threshold, b_threshold)
        solve_seconds = run.solve_seconds

    if transport is not None:
        # every rank's writes finish before any rank leaves the group
        import torch.distributed as dist

        transport.barrier()
        dist.destroy_process_group()
    if is_p0:
        sec = int(solve_seconds)
        usec = int((solve_seconds - sec) * 1e6)
        sys.stderr.write("SO CPU Time:")
        sys.stderr.write("   %d.%06d\n\n" % (sec, usec))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
