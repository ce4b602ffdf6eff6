"""The golden scenarios and their fixtures, for the port: a copy of
tests/scenarios.py (SCENARIOS, OUTPUT_FILES, generate_inputs) and of the
fixture writers of tests/fixtures.py (make_clumpy_box, make_zoom_box,
write_snapshot, write_gtp) on so_tpu_torch.io.tipsy, so a run on a machine
without the JAX package (chip_smoke.py's goldens phase) writes the same
bytes from the same seeds. Needs numpy and so_tpu_torch only.
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from so_tpu_torch.io.tipsy import (DARK_DTYPE, GAS_DTYPE,  # noqa: E402
                                   STAR_DTYPE, TipsyHeader, write_tipsy)


def make_clumpy_box(rng, n_background=8000, clumps=(), box=1.0, time=1.0,
                    species="dark", mass=None, vel_scale=0.05):
    """Positions/velocities/masses for a unit box with r^-2 clumps.

    clumps: list of dicts {center (3,), n, rmax, mass_total}.
    Returns dict of float32 arrays (pos, vel, mass, phi).
    """
    pos = [rng.uniform(-box / 2, box / 2, (n_background, 3))]
    npart = n_background
    for c in clumps:
        r = c["rmax"] * rng.uniform(0.0005, 1.0, c["n"])  # rho ~ r^-2
        u = rng.normal(size=(c["n"], 3))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        p = np.asarray(c["center"])[None, :] + r[:, None] * u
        p = (p + box / 2) % box - box / 2
        pos.append(p)
        npart += c["n"]
    pos = np.concatenate(pos).astype(np.float32)
    vel = (rng.normal(size=(npart, 3)) * vel_scale).astype(np.float32)
    if mass is None:
        mtot_clumps = sum(c.get("mass_total", 0.0) for c in clumps)
        m_bg = max(1e-8, (1.0 - mtot_clumps)) / n_background
        masses = [np.full(n_background, m_bg, np.float32)]
        for c in clumps:
            masses.append(np.full(c["n"], c["mass_total"] / c["n"], np.float32))
        mass = np.concatenate(masses).astype(np.float32)
    phi = rng.uniform(-2.0, -0.1, npart).astype(np.float32)
    return dict(pos=pos, vel=vel, mass=mass, phi=phi)


def make_zoom_box(rng, n_hi, n_lo, n_halos, zoom_half=0.15, verbose=False):
    """Zoom-in multi-species box (BASELINE.md scale-ladder config): a
    high-resolution sub-volume (gas+dark+star, light particles, clustered
    r^-2 halos) embedded in a low-resolution background of heavy dark
    particles — particle masses span ~2 orders of magnitude. Stresses the
    iOrder species windows (reference kd2.c:135-141), per-species
    cumulative profiles (kd2.c:458-496), and density scans dominated by
    occasional heavyweight background hits rather than uniform-mass counts.

    Unit periodic box, total mass 1: hi-res particles (half clumped in
    r^-2 halos, half uniform) inside the zoom cube |x_i| < zoom_half, and
    heavy lo-res dark particles filling the rest of the volume.

    Returns (data dict for write_snapshot, split, centers, rgtp). The
    hi-res block is shuffled then split gas/dark/star 20/70/10; the dark
    block is hi-res dark followed by all lo-res particles (tipsy species
    order gas, dark, star is preserved by construction).
    """
    n_clumped = n_hi // 2
    n_zbg = n_hi - n_clumped
    sizes = rng.pareto(1.5, n_halos) + 1.0
    sizes = np.maximum((sizes / sizes.sum() * n_clumped).astype(np.int64), 24)
    margin = 0.02
    centers = rng.uniform(-(zoom_half - margin), zoom_half - margin,
                          (n_halos, 3)).astype(np.float32)

    # mass budget: clumps 0.05 (the zoom overdensity), hi-res uniform
    # matches mean density inside the zoom cube, lo-res takes the rest
    m_clump_tot = 0.05
    v_zoom = (2.0 * zoom_half) ** 3
    m_zbg_tot = v_zoom
    m_p_hi = m_clump_tot / float(sizes.sum())
    # r^-2 clumps: M(<r) = m_c r / rmax, so the Delta=178 crossing sits at
    # R/rmax = sqrt(3 m_p_hi / (4 pi 178 coef^3)) independent of clump
    # size; pick coef so R/rmax ~ 0.4 (crossing well inside the clump,
    # >~100 members for a mean-size halo, near-nMembers for the smallest)
    coef = (3.0 * m_p_hi / (4.0 * np.pi * 178.0 * 0.16)) ** (1.0 / 3.0)
    rmax = (coef * sizes.astype(np.float64) ** (1.0 / 3.0)).astype(np.float32)

    chunks = [rng.uniform(-zoom_half, zoom_half, (n_zbg, 3)).astype(np.float32)]
    for c, n, rm in zip(centers, sizes, rmax):
        r = rm * rng.uniform(0.001, 1.0, n)
        u = rng.normal(size=(n, 3))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        chunks.append(c[None, :] + (r[:, None] * u).astype(np.float32))
    pos_hi = np.concatenate(chunks)
    mass_hi = np.concatenate([
        np.full(n_zbg, m_zbg_tot / n_zbg, np.float32),
        np.full(int(sizes.sum()), m_p_hi, np.float32)])
    # shuffle so the gas/dark/star windows are spatially mixed
    perm = rng.permutation(pos_hi.shape[0])
    pos_hi, mass_hi = pos_hi[perm], mass_hi[perm]
    n_hi_tot = pos_hi.shape[0]

    # lo-res: uniform outside the zoom cube (rejection sample)
    pos_lo = np.empty((0, 3), np.float32)
    while pos_lo.shape[0] < n_lo:
        cand = rng.uniform(-0.5, 0.5, (int(n_lo * 1.2) + 64, 3)
                           ).astype(np.float32)
        outside = np.abs(cand).max(axis=1) >= zoom_half
        pos_lo = np.concatenate([pos_lo, cand[outside]])[:n_lo]
    m_lo = (1.0 - m_clump_tot - m_zbg_tot) / n_lo
    mass_lo = np.full(n_lo, m_lo, np.float32)

    ngas = int(0.2 * n_hi_tot)
    nstar = int(0.1 * n_hi_tot)
    ndark_hi = n_hi_tot - ngas - nstar
    # species order: gas | dark(hi) + dark(lo) | star
    pos = np.concatenate([pos_hi[:ngas], pos_hi[ngas:ngas + ndark_hi],
                          pos_lo, pos_hi[ngas + ndark_hi:]])
    mass = np.concatenate([mass_hi[:ngas], mass_hi[ngas:ngas + ndark_hi],
                           mass_lo, mass_hi[ngas + ndark_hi:]])
    n_tot = pos.shape[0]
    data = dict(
        pos=pos.astype(np.float32),
        vel=(rng.normal(size=(n_tot, 3)) * 0.05).astype(np.float32),
        mass=mass.astype(np.float32),
        phi=rng.uniform(-2.0, -0.1, n_tot).astype(np.float32))
    split = (ngas, ndark_hi + n_lo, nstar)
    if verbose:
        print(f"zoom box: {n_tot} particles (gas {ngas}, dark {ndark_hi}"
              f"+{n_lo} lo-res, star {nstar}), mass ratio lo/hi = "
              f"{m_lo / m_p_hi:.1f}, {n_halos} halos, rmax "
              f"[{rmax.min():.4g}, {rmax.max():.4g}]", flush=True)
    return data, split, centers, rmax


def write_snapshot(path, data, time=1.0, standard=False, split=None):
    """Write particles as a tipsy snapshot. split=(ngas, ndark, nstar) or
    all-dark by default."""
    n = data["pos"].shape[0]
    ngas, ndark, nstar = split if split is not None else (0, n, 0)
    assert ngas + ndark + nstar == n

    def fill(dt, sl, extra):
        rec = np.zeros(sl.stop - sl.start, dtype=dt)
        rec["mass"] = data["mass"][sl]
        rec["pos"] = data["pos"][sl]
        rec["vel"] = data["vel"][sl]
        rec["phi"] = data["phi"][sl]
        for k, v in extra.items():
            rec[k] = v
        return rec

    gas = fill(GAS_DTYPE[False], slice(0, ngas),
               {"temp": 1e4, "rho": 1.0, "hsmooth": 0.01, "metals": 0.01}) if ngas else None
    dark = fill(DARK_DTYPE[False], slice(ngas, ngas + ndark), {"eps": 0.01}) if ndark else None
    star = fill(STAR_DTYPE[False], slice(ngas + ndark, n),
                {"metals": 0.02, "tform": 0.5, "eps": 0.01}) if nstar else None
    hdr = TipsyHeader(time=time, nbodies=n, ndim=3, nsph=ngas, ndark=ndark,
                      nstar=nstar)
    write_tipsy(path, hdr, gas, dark, star, standard)
    return hdr


def write_gtp(path, centers, rgtp, masses, time=1.0, standard=False):
    """Write a star-only GTP catalog of candidate centers."""
    centers = np.asarray(centers, np.float32)
    n = centers.shape[0]
    rec = np.zeros(n, dtype=STAR_DTYPE[False])
    rec["mass"] = np.asarray(masses, np.float32)
    rec["pos"] = centers
    rec["eps"] = np.asarray(rgtp, np.float32)
    rec["tform"] = np.arange(1, n + 1, dtype=np.float32)
    hdr = TipsyHeader(time=time, nbodies=n, ndim=3, nsph=0, ndark=0, nstar=n)
    write_tipsy(path, hdr, None, None, rec, standard)


def _basic(outdir, standard=False):
    rng = np.random.default_rng(42)
    clumps = [
        dict(center=(0.1, 0.1, 0.1), n=3000, rmax=0.08, mass_total=0.2),
        dict(center=(-0.2, 0.25, -0.3), n=1500, rmax=0.05, mass_total=0.08),
        dict(center=(0.12, 0.12, 0.12), n=800, rmax=0.03, mass_total=0.04),
        dict(center=(0.4, -0.4, 0.0), n=600, rmax=0.04, mass_total=0.03),
    ]
    data = make_clumpy_box(rng, n_background=10000, clumps=clumps)
    write_snapshot(f"{outdir}/snap.bin", data, time=1.0, standard=standard)
    centers = [c["center"] for c in clumps] + [(-0.45, -0.45, -0.45)]
    write_gtp(f"{outdir}/cat.gtp", centers, [0.05, 0.04, 0.025, 0.03, 0.02],
              [0.2, 0.08, 0.04, 0.03, 0.001], time=1.0, standard=standard)


def _species(outdir):
    rng = np.random.default_rng(7)
    clumps = [
        dict(center=(-0.1, 0.0, 0.2), n=2400, rmax=0.06, mass_total=0.15),
        dict(center=(0.3, 0.3, -0.2), n=1200, rmax=0.05, mass_total=0.07),
    ]
    data = make_clumpy_box(rng, n_background=9000, clumps=clumps)
    n = data["pos"].shape[0]
    # interleave species by shuffling particle order, then split gas/dark/star
    perm = rng.permutation(n)
    for k in data:
        data[k] = data[k][perm]
    ngas, nstar = n // 5, n // 7
    write_snapshot(f"{outdir}/snap.bin", data, time=0.5,
                   split=(ngas, n - ngas - nstar, nstar))
    write_gtp(f"{outdir}/cat.gtp", [c["center"] for c in clumps],
              [0.04, 0.035], [0.15, 0.07], time=0.5)
    # mark file: every 3rd particle (1-based indices; kd2.c:158-164)
    idx = np.arange(1, n + 1, 3)
    with open(f"{outdir}/mark.txt", "w") as f:
        f.write(f"{n} {ngas} {nstar}\n")
        f.write("\n".join(str(i) for i in idx) + "\n")


def _flags(outdir):
    rng = np.random.default_rng(13)
    clumps = [
        dict(center=(0.0, 0.0, 0.0), n=2500, rmax=0.07, mass_total=0.2),
        dict(center=(0.3, -0.25, 0.1), n=1500, rmax=0.05, mass_total=0.1),
        dict(center=(-0.3, 0.3, -0.3), n=1000, rmax=0.04, mass_total=0.05),
        dict(center=(0.15, 0.4, 0.4), n=800, rmax=0.04, mass_total=0.04),
    ]
    data = make_clumpy_box(rng, n_background=8000, clumps=clumps)
    write_snapshot(f"{outdir}/snap.bin", data, time=0.8)
    write_gtp(f"{outdir}/cat.gtp", [c["center"] for c in clumps],
              [0.05, 0.04, 0.03, 0.03], [0.2, 0.1, 0.05, 0.04], time=0.8)
    # out-of-order -list subset exercises the .sogtp pointer walk
    with open(f"{outdir}/list.txt", "w") as f:
        f.write("3\n1\n4\n")
    # SKID-style .stat lines for every group: 2 ints + 16 floats + x y z
    centers = [(0.002, 0.001, -0.003), (0.301, -0.252, 0.102),
               (-0.298, 0.301, -0.301), (0.149, 0.401, 0.402)]
    with open(f"{outdir}/stat.txt", "w") as f:
        for g, c in enumerate(centers, 1):
            f.write(f"{g} 10 " + " ".join("0.5" for _ in range(16))
                    + f" {c[0]} {c[1]} {c[2]}\n")


def _errors(outdir, standard=False):
    rng = np.random.default_rng(99)
    clumps = [dict(center=(0.2, 0.2, 0.2), n=2000, rmax=0.06, mass_total=0.25)]
    data = make_clumpy_box(rng, n_background=6000, clumps=clumps)
    write_snapshot(f"{outdir}/snap.bin", data, time=1.0, standard=standard)
    # group 1: normal; group 2: void center, tiny rgtp (-1);
    # group 3: void center, big rgtp so >= nMembers sparse particles (-2);
    # group 4: tiny rgtp inside the clump: dense forever at huge -delta (-3 run)
    write_gtp(f"{outdir}/cat.gtp",
              [(0.2, 0.2, 0.2), (-0.4, -0.4, -0.4), (-0.35, 0.4, -0.4),
               (0.2, 0.2, 0.2)],
              [0.05, 0.004, 0.2, 0.01],
              [0.25, 0.001, 0.002, 0.003], time=1.0, standard=standard)


def _slurp(outdir):
    rng = np.random.default_rng(5)
    # A: extended massive clump with deliberately tiny GTP mass (processed
    # first) -> huge Rvir; B: modest clump centered inside A's Rvir but with
    # dist(A,B) > Rvir_B -> B slurped by A at its first owned particle.
    clumps = [
        dict(center=(0.0, 0.0, 0.0), n=5000, rmax=0.12, mass_total=0.45),
        dict(center=(0.055, 0.0, 0.0), n=700, rmax=0.012, mass_total=0.02),
    ]
    data = make_clumpy_box(rng, n_background=6000, clumps=clumps)
    write_snapshot(f"{outdir}/snap.bin", data, time=1.0)
    write_gtp(f"{outdir}/cat.gtp", [(0.0, 0.0, 0.0), (0.055, 0.0, 0.0)],
              [0.08, 0.01], [0.01, 0.02], time=1.0)


def _ties(outdir):
    rng = np.random.default_rng(21)
    clumps = [
        dict(center=(0.05, 0.05, 0.05), n=1800, rmax=0.05, mass_total=0.12),
        dict(center=(0.08, 0.05, 0.05), n=900, rmax=0.03, mass_total=0.05),
        dict(center=(-0.3, -0.3, 0.3), n=900, rmax=0.03, mass_total=0.05),
        dict(center=(0.02, 0.08, 0.05), n=900, rmax=0.03, mass_total=0.05),
    ]
    data = make_clumpy_box(rng, n_background=7000, clumps=clumps)
    write_snapshot(f"{outdir}/snap.bin", data, time=1.0)
    # three equal GTP masses -> processing order decided by NR indexx ties
    write_gtp(f"{outdir}/cat.gtp", [c["center"] for c in clumps],
              [0.04, 0.025, 0.025, 0.025], [0.12, 0.05, 0.05, 0.05], time=1.0)


def _period(outdir):
    rng = np.random.default_rng(31)
    # clump straddling the periodic boundary; off-center box via -c
    clumps = [
        dict(center=(1.98, 1.0, 1.0), n=2500, rmax=0.1, mass_total=0.3),
        dict(center=(1.0, 1.0, 1.0), n=1200, rmax=0.08, mass_total=0.1),
    ]
    data = make_clumpy_box(rng, n_background=8000, clumps=clumps, box=2.0)
    data["pos"] = ((data["pos"] + 1.0) % 2.0).astype(np.float32)  # [0,2) box
    write_snapshot(f"{outdir}/snap.bin", data, time=1.0)
    write_gtp(f"{outdir}/cat.gtp", [(1.98, 1.0, 1.0), (1.0, 1.0, 1.0)],
              [0.07, 0.06], [0.3, 0.1], time=1.0)


def _period_axes(outdir):
    rng = np.random.default_rng(37)
    # distinct per-axis centers (-cx/-cy/-cz, so.c per-axis parsing); one
    # clump wraps the x boundary of the shifted box
    cx, cy, cz = 1.0, 0.5, -0.25
    c = np.array([cx, cy, cz], np.float32)
    # clump centers in the FINAL (per-axis-shifted) frame; generate in the
    # zero-centered frame and shift+wrap the whole box afterwards
    final_centers = [(cx + 0.98, cy, cz),
                     (cx - 0.4, cy + 0.3, cz - 0.2)]
    clumps = [
        dict(center=tuple(np.asarray(fc) - c), n=n, rmax=rm, mass_total=mt)
        for fc, n, rm, mt in zip(final_centers, (2200, 1100), (0.09, 0.06),
                                 (0.25, 0.1))
    ]
    data = make_clumpy_box(rng, n_background=7000, clumps=clumps, box=2.0)
    data["pos"] = (((data["pos"] + c) - (c - 1.0)) % 2.0
                   + (c - 1.0)).astype(np.float32)
    write_snapshot(f"{outdir}/snap.bin", data, time=1.0)
    write_gtp(f"{outdir}/cat.gtp", final_centers,
              [0.07, 0.05], [0.25, 0.1], time=1.0)


def _uniform(outdir):
    # every particle carries the same f32 mass (the plain N-body regime):
    # exercises the uniform-mass ladder fast path against the reference,
    # where quarter/half-mass crossings land EXACTLY on particle
    # boundaries (member counts divisible by 4) and the Mvir
    # add-then-subtract ulp (kd2.c:810-818) decides the slot
    rng = np.random.default_rng(271)
    clumps = [
        dict(center=(0.1, 0.1, 0.1), n=2800, rmax=0.07, mass_total=0.2),
        dict(center=(-0.2, 0.25, -0.3), n=1400, rmax=0.05, mass_total=0.1),
        dict(center=(0.35, -0.35, 0.3), n=800, rmax=0.04, mass_total=0.05),
    ]
    data = make_clumpy_box(rng, n_background=9000, clumps=clumps)
    n = data["pos"].shape[0]
    data["mass"] = np.full(n, np.float32(1.0 / n))
    write_snapshot(f"{outdir}/snap.bin", data, time=1.0)
    write_gtp(f"{outdir}/cat.gtp",
              [c["center"] for c in clumps] + [(-0.45, -0.45, -0.45)],
              [0.05, 0.04, 0.03, 0.02], [0.2, 0.1, 0.05, 0.001], time=1.0)


def _zoom(outdir):
    # zoom-in multi-species regime (BASELINE.md scale ladder): hi-res
    # gas/dark/star clumps in a heavy lo-res dark background — particle
    # masses span ~2 orders of magnitude across the iOrder species
    # windows, so serial-f32 mass accumulations mix unequal addends
    # (this regime caught the Mvir add-then-subtract ulp, kd2.c:810-818)
    rng = np.random.default_rng(1789)
    data, split, centers, rmax = make_zoom_box(rng, 20000, 4000, 32)
    write_snapshot(f"{outdir}/snap.bin", data, time=1.0, split=split)
    write_gtp(f"{outdir}/cat.gtp", centers, rmax,
              rng.uniform(0.001, 1.0, centers.shape[0]), time=1.0)


SCENARIOS = {
    # name: (generator, reference CLI args after -i/-o, needs_std_io)
    "basic": (_basic, ["-grp", "-gtp", "-subsumed", "-ignored", "-all"], False),
    "std": (lambda d: _basic(d, standard=True), ["-std", "-grp", "-gtp"], True),
    "species": (_species, ["-all", "-mark", "{dir}/mark.txt", "-grp", "-z", "0.5",
                           "-O", "0.3", "-L"], False),
    "flags_list": (_flags, ["-delta", "500", "-M", "0.045", "-list",
                            "{dir}/list.txt", "-m", "16", "-u", "2.2e16", "50",
                            "-grp", "-gtp"], False),
    "flags_stat": (_flags, ["-stat", "{dir}/stat.txt", "-grp", "-gtp"], False),
    "flags_pot": (_flags, ["-pot", "-grp"], False),
    "errors": (_errors, ["-grp", "-gtp"], False),
    "errors_m3": (_errors, ["-delta", "1e-4", "-grp"], False),
    # error codes under XDR: the reference's -std read paths (kd2.c:330-335,
    # 368-371) interacting with unconverted error rows (kd2.c:996-1000)
    "errors_std": (lambda d: _errors(d, standard=True),
                   ["-std", "-grp", "-gtp"], True),
    "errors_m3_std": (lambda d: _errors(d, standard=True),
                      ["-std", "-delta", "1e-4", "-grp"], True),
    # -u unit conversion + user -delta under -std (kd2.c:981-991 with XDR IO)
    "units_std": (lambda d: _basic(d, standard=True),
                  ["-std", "-delta", "500", "-u", "2.2e16", "50",
                   "-grp", "-gtp"], True),
    "slurp": (_slurp, ["-grp", "-gtp", "-subsumed", "-ignored"], False),
    "zoom": (_zoom, ["-all", "-grp", "-gtp", "-subsumed", "-ignored"], False),
    "uniform": (_uniform, ["-all", "-grp", "-gtp", "-subsumed", "-ignored"],
                False),
    "ties": (_ties, ["-grp", "-subsumed", "-ignored"], False),
    "period": (_period, ["-p", "2.0", "-c", "1.0", "-grp"], False),
    # per-axis centers (-cx/-cy/-cz, so.c:338-360) with a boundary clump,
    # plus a small -m (nMembers=4, below the classifier window)
    "period_axes": (_period_axes,
                    ["-p", "2.0", "-cx", "1.0", "-cy", "0.5", "-cz", "-0.25",
                     "-m", "4", "-grp", "-gtp"], False),
}

OUTPUT_FILES = ["sovcirc", "sogrp", "sogtp", "sosub", "soign",
                "sodark", "sogas", "sostar", "somark"]


def generate_inputs(name: str, outdir: str) -> list[str]:
    gen, args, _std = SCENARIOS[name]
    os.makedirs(outdir, exist_ok=True)
    gen(outdir)
    return [a.format(dir=outdir) for a in args]
