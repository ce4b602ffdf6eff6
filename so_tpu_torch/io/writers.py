"""Output writers for all eight reference products (copy of
so_tpu/io/writers.py, so the port imports nothing of the JAX package).

  .sovcirc  — parameter header + stats comments + per-group catalog rows
              (so.c:484-511, kdOutStats kd2.c:1393-1413, kdWriteOut
              kd2.c:970-1008)
  .sodark/.sogas/.sostar/.somark — 16-bin cumulative radial mass profiles
              (kdWriteProfile kd2.c:901-968)
  .sogrp    — tipsy-array ASCII of per-particle group ids in original file
              order (kdWriteArray kd2.c:1244-1264)
  .sogtp    — tipsy star-file catalog, one entry per *input* GTP group
              (kdWriteGTP kd2.c:1267-1332)
  .sosub/.soign — tipsy-array ASCII of per-particle subsume/ignore counters
              (kdWriteConflict kd2.c:1216-1241)

All numeric text uses C %g semantics (Python's %g matches); float32 unit
multiplications are done in float32 first, as C float*float arithmetic does.
"""

from __future__ import annotations

import time as _time

import numpy as np

from ..io.tipsy import DARK, GAS, STAR, MARK, STAR_DTYPE, TipsyHeader, write_header
from ..units import UnitConversions
from ..version import SOVCIRC_HEADER_VERSION

SPECIES_NAMES = {DARK: "dark", GAS: "gas", STAR: "star", MARK: "marked"}
SPECIES_EXT = {DARK: "sodark", GAS: "sogas", STAR: "sostar", MARK: "somark"}


def _g(x) -> str:
    return "%g" % float(x)


def write_sovcirc_header(fp, run_time: float, gtp_file: str,
                         list_file: str | None, stat_file: str | None,
                         threshold: float, threshold_user: bool,
                         redshift: float, omega: float, lam: float,
                         b_periodic: int, period, center,
                         f_min_mass: float, n_members: int, b_pot: bool,
                         f_mass_unit: float, f_mpc_unit: float) -> None:
    """Parameter header — so.c:487-511 (stale version string included)."""
    fp.write(f"{SOVCIRC_HEADER_VERSION}\n")
    fp.write("# Run on %s\n" % _time.ctime(run_time))
    fp.write("# Input .gtp file: %s\n" % gtp_file)
    if list_file is not None:
        fp.write("# Groups list from file: %s\n" % list_file)
    if stat_file is not None:
        fp.write("# Group potential centers from file: %s\n" % stat_file)
    if threshold_user:
        fp.write("# fThreshold = %g  (set by user)\n" % float(threshold))
    else:
        fp.write("# fThreshold = %g  (VIRIAL DENSITY)\n" % float(threshold))
    fp.write("# fRedshift: %g   fOmega: %g   fLambda: %g\n"
             % (float(np.float32(redshift)), float(np.float32(omega)),
                float(np.float32(lam))))
    fp.write("# bPeriodic: %d  fPeriod[i]: %g %g %g   fCenter[i]: %g %g %g\n"
             % (b_periodic, *[float(np.float32(p)) for p in period],
                *[float(np.float32(c)) for c in center]))
    fp.write("# fMinMass: %g  nMembers: %d  bPot: %d\n"
             % (float(np.float32(f_min_mass)), n_members, int(b_pot)))
    if f_mass_unit < 0.0:
        fp.write("# fMassUnit: UNSPECIFIED  fMpcUnit: UNSPECIFIED\n#\n")
    else:
        fp.write("# fMassUnit: %g  fMpcUnit: %g\n#\n"
                 % (float(np.float32(f_mass_unit)), float(np.float32(f_mpc_unit))))


def write_profile_file(path: str, fp_main, run_time: float, species: int,
                       index: np.ndarray, profile: np.ndarray,
                       units: UnitConversions) -> None:
    """One .so<species> profile file — kdWriteProfile (kd2.c:901-968)."""
    name = SPECIES_NAMES[species]
    fp_main.write("# Radial mass profile for %s particles written to %s\n"
                  % (name, path))
    nbins = profile.shape[1]
    with open(path, "w") as fp:
        fp.write("# Radial mass profile for %s particles\n" % name)
        fp.write("# Run on %s\n" % _time.ctime(run_time))
        fp.write("# grp# Mass(R = %4.2f ... 2 Rvir)\n" % (2.0 / nbins))
        vals = (profile.astype(np.float32) * units.massunit).astype(np.float32)
        for i in range(index.shape[0]):
            fp.write("%d " % int(index[i]))
            fp.write(" ".join(_g(v) for v in vals[i]))
            fp.write(" \n")


def write_sovcirc_rows(fp, index: np.ndarray, mvir: np.ndarray,
                       rvir: np.ndarray, rmass: np.ndarray, rmax: np.ndarray,
                       vmax: np.ndarray, vcirc: np.ndarray,
                       units: UnitConversions) -> None:
    """Catalog rows — kdWriteOut (kd2.c:993-1007). Error rows (negative
    Mvir) keep Mvir/Rvir unconverted; derived columns always convert."""
    nv = vcirc.shape[1]
    fp.write("#\n# grp# Mvir Rvir R(0.25Mvir) R(0.5Mvir)  R(Vc_max)  Vc_max"
             "  Vc(R = %4.2f ... 2 Rvir)\n" % (2.0 / nv))
    f32 = np.float32
    for i in range(index.shape[0]):
        if mvir[i] < 0.0:
            fp.write("%i %s %s " % (int(index[i]), _g(mvir[i]), _g(rvir[i])))
        else:
            fp.write("%i %s %s " % (int(index[i]),
                                    _g(f32(mvir[i]) * units.massunit),
                                    _g(f32(rvir[i]) * units.kpcunit)))
        fp.write("%s %s %s %s " % (_g(f32(rmass[i, 0]) * units.kpcunit),
                                   _g(f32(rmass[i, 1]) * units.kpcunit),
                                   _g(f32(rmax[i]) * units.kpcunit),
                                   _g(f32(vmax[i]) * units.kmsecunit)))
        fp.write(" ".join(_g(f32(vcirc[i, k]) * units.kmsecunit)
                          for k in range(nv)))
        fp.write(" \n")


def write_array_file(path: str, values: np.ndarray) -> None:
    """Tipsy-array ASCII: count then one value per line (kd2.c:1244-1264).

    Uses the native writer when available (1e9-line .sogrp files are pure
    I/O; it streams through a 1 MB text buffer). The Python fallback
    streams in bounded chunks too — a 1024^3 run is ~10 GB of text, which
    must never be materialized at once."""
    from ..native import write_int_array_native

    if write_int_array_native(path, values):
        return
    CHUNK = 1 << 20
    with open(path, "w") as fp:
        fp.write("%d\n" % values.shape[0])
        for lo in range(0, values.shape[0], CHUNK):
            blk = np.asarray(values[lo:lo + CHUNK]).astype(np.int64)
            fp.write("\n".join(map(str, blk.tolist())))
            fp.write("\n")


def int_array_text_length(values: np.ndarray) -> int:
    """Exact byte length of values formatted as "%d\n" lines (no header).

    Integer-threshold digit counting (no float log10 — exact at powers of
    ten); vectorized, so per-host segment offsets for a 1e9-line .sogrp
    are O(ten passes) over the segment."""
    v = np.asarray(values, np.int64)
    n = v.shape[0]
    total = 2 * n                    # 1 digit + newline minimum
    total += int((v < 0).sum())      # sign characters
    a = np.abs(v)
    t = 10
    while True:
        extra = int((a >= t).sum())
        if not extra:
            break
        total += extra
        t *= 10
    return total


def write_int_array_segment(path: str, values: np.ndarray,
                            offset: int) -> None:
    """Write "%d\n" lines at a byte offset of an EXISTING file — the
    per-host segment write for .sogrp/.sosub/.soign in multi-controller
    runs (process 0 pre-creates the file with the count header and sizes
    it; int_array_text_length gives each host its exact offset)."""
    from ..native import write_int_array_segment_native

    if write_int_array_segment_native(path, values, offset):
        return
    CHUNK = 1 << 20
    with open(path, "r+b") as fp:
        fp.seek(offset)
        for lo in range(0, values.shape[0], CHUNK):
            blk = np.asarray(values[lo:lo + CHUNK]).astype(np.int64)
            fp.write(("\n".join(map(str, blk.tolist())) + "\n").encode())


def write_sogtp(path: str, snapshot_time: float, n_in_gtp: int,
                index: np.ndarray, mvir: np.ndarray, rvir: np.ndarray,
                pos: np.ndarray, vcm: np.ndarray, standard: bool) -> None:
    """Output GTP catalog — kdWriteGTP (kd2.c:1267-1332).

    One star record per input GTP entry, matched by an advancing pointer
    over the (index-ordered) processed group list: entry i uses group data
    only when the next unconsumed group's index equals i+1; otherwise it is
    zeroed with tform = i+1 (the reference's exact pointer-walk, including
    its behavior for out-of-order -list files).
    """
    rec = np.zeros(n_in_gtp, dtype=STAR_DTYPE[False])
    rec["tform"] = np.arange(1, n_in_gtp + 1, dtype=np.float32)
    gptr = 0
    ngroups = index.shape[0]
    for i in range(n_in_gtp):
        if gptr < ngroups and int(index[gptr]) == i + 1:
            rec["mass"][i] = max(float(mvir[gptr]), 0.0)
            rec["pos"][i] = pos[gptr]
            rec["vel"][i] = vcm[gptr]
            rec["eps"][i] = rvir[gptr]
            rec["tform"][i] = float(index[gptr])
            gptr += 1
    with open(path, "wb") as fp:
        write_header(fp, TipsyHeader(time=snapshot_time, nbodies=n_in_gtp,
                                     ndim=3, nsph=0, ndark=0, nstar=n_in_gtp),
                     standard)
        fp.write(rec.astype(STAR_DTYPE[standard], copy=False).tobytes())
