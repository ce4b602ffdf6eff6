"""Write tests/torch_refs/: so_tpu's own outputs on chip_smoke.py's boxes,
which the smoke's "so_tpu at scale" phase holds the card to.

    python tests/make_torch_refs.py        (CPU, with JAX; ~5 min on 8 cores)

Each box is built by the functions chip_smoke.py itself uses (make_box,
particles_and_catalog, giant_config, giant_inputs, write_zoom_inputs), so
both sides see the same arrays; chip_smoke checks the inputs' sha256 that
the manifest records. so_tpu runs at its defaults on the CPU with
SO_TPU_PALLAS unset (the XLA gather) and SO_TPU_DEBUG set, whose stage
lines give the largest capacity K it dispatched:

  standard_uniform, standard_species   run_so at Delta 178 on the standard
                                       box (2^21 particles, 16,384 halos)
  giant_general, giant_uniform         run_so at Delta 178 on the giant box
                                       (5e6 particles, 64 centers)
  zoom                                 so_tpu's CLI with -all -grp -gtp
                                       -subsumed -ignored on
                                       compare_reference_zoom.py's box

<box>.npz holds chip_smoke.run_record of the run (zoom: chip_smoke.
cli_record of the CLI's files); manifest.json the commit, and for each
box the command that wrote it, its seconds, its inputs' sha256, its
largest K and any cut of scale (``reduced``), and the sha256 of so_tpu's
sources (so_tpu_sources_sha256), which a CPU test holds the tree to.
``--out DIR --box NAME`` writes one box elsewhere; tests call
``write_box`` at a reduced size.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

BOXES = ("standard_uniform", "standard_species", "giant_general",
         "giant_uniform", "zoom")


def so_tpu_sources_sha256(root: str = ROOT) -> str:
    """One sha256 over so_tpu's sources, so_tpu/**/*.py and
    so_tpu/native/*.c, in the order of their sorted paths: for each file
    its path relative to ``root`` (POSIX form), a NUL, its byte count as
    8 little-endian bytes, then its bytes. The manifest records it, and
    tests/test_torch_parity_refs.py fails when the tree's differs."""
    import glob
    import hashlib

    pkg = os.path.join(root, "so_tpu")
    paths = (glob.glob(os.path.join(pkg, "**", "*.py"), recursive=True)
             + glob.glob(os.path.join(pkg, "native", "*.c")))
    rels = sorted(os.path.relpath(p, root).replace(os.sep, "/")
                  for p in paths)
    h = hashlib.sha256()
    for rel in rels:
        with open(os.path.join(root, rel), "rb") as f:
            data = f.read()
        h.update(rel.encode() + b"\0" + len(data).to_bytes(8, "little"))
        h.update(data)
    return h.hexdigest()


def so_tpu_inputs(ps, catalog):
    """so_tpu's ParticleSet and GroupCatalog holding the port's arrays."""
    from so_tpu.io.catalogs import GroupCatalog
    from so_tpu.io.tipsy import ParticleSet, TipsyHeader

    h = ps.header
    return (ParticleSet(TipsyHeader(time=h.time, nbodies=h.nbodies,
                                    ndim=h.ndim, nsph=h.nsph, ndark=h.ndark,
                                    nstar=h.nstar),
                        ps.pos, ps.vel, ps.mass, ps.phi, ps.temp),
            GroupCatalog(index=catalog.index, pos=catalog.pos.copy(),
                         rgtp=catalog.rgtp, gtp_mass=catalog.gtp_mass,
                         n_in_gtp=catalog.n_in_gtp,
                         gtp_time=catalog.gtp_time))


def debug_ks(text):
    """(largest gather capacity of so_tpu's solve stage lines, of any stage
    line, the solve's whole-box dispatches) in SO_TPU_DEBUG output. A
    fused solve line gives its second tier's capacity as K2; a whole-box
    line gives the particle count as K and is counted apart."""
    solve, every, wbox = [], [], 0
    for ln in text.splitlines():
        m = re.match(r"so_tpu\[(\w+)\]: (\S+)", ln)
        if m is None:
            continue
        if m.group(2) in ("wbox", "multi-wbox"):
            wbox += 1
            continue
        ks = [int(k) for k in re.findall(r" K2?=(\d+)", ln)]
        every += ks
        if m.group(1) == "solve":
            solve += ks
    return max(solve, default=0), max(every, default=0), wbox


@contextlib.contextmanager
def so_tpu_debug():
    """so_tpu on the CPU with the XLA gather, its stage lines captured."""
    old = {k: os.environ.pop(k, None) for k in ("SO_TPU_PALLAS",
                                                "SO_TPU_DEBUG")}
    os.environ["SO_TPU_DEBUG"] = "1"
    err = io.StringIO()
    try:
        with contextlib.redirect_stderr(err):
            yield err
    finally:
        for k, v in old.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def write_box(name, ps, catalog, species, out_dir):
    """so_tpu's run_so at Delta 178 on one box, written as out_dir/<name>.npz;
    returns its manifest entry."""
    from so_tpu.engine import SOParams, run_so

    jps, jcat = so_tpu_inputs(ps, catalog)
    t0 = time.perf_counter()
    with so_tpu_debug() as err:
        out = run_so(jps, jcat, SOParams(threshold=chip_smoke.THR,
                                         species=species))
    sec = time.perf_counter() - t0
    rec = chip_smoke.run_record(out)
    np.savez_compressed(os.path.join(out_dir, f"{name}.npz"), **rec)
    k_solve, k_any, wbox = debug_ks(err.getvalue())
    return dict(seconds=round(sec, 1), particles=int(ps.n),
                halos=int(catalog.n), solved=int((out.solve.code == 0).sum()),
                inputs_sha256=chip_smoke.inputs_sha256(ps, catalog),
                largest_solve_K=k_solve, largest_K=k_any,
                wbox_dispatches=wbox, reduced=None)


def write_zoom(out_dir, n_hi, n_lo, n_halos):
    """so_tpu's CLI on compare_reference_zoom.py's box, its files written
    as out_dir/zoom.npz; returns its manifest entry."""
    from so_tpu.cli import main as so_main

    with tempfile.TemporaryDirectory() as work:
        sha = chip_smoke.write_zoom_inputs(work, n_hi, n_lo, n_halos)
        t0 = time.perf_counter()
        with so_tpu_debug() as err:
            rc = so_main(["-i", f"{work}/cat.gtp", "-o", f"{work}/got",
                          "--tipsy", f"{work}/snap.bin"]
                         + chip_smoke.ZOOM_FLAGS)
        sec = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"so_tpu's CLI failed:\n{err.getvalue()}")
        rec = chip_smoke.cli_record(f"{work}/got")
        n = os.path.getsize(f"{work}/snap.bin")
    np.savez_compressed(os.path.join(out_dir, "zoom.npz"), **rec)
    k_solve, k_any, wbox = debug_ks(err.getvalue())
    return dict(seconds=round(sec, 1), snapshot_bytes=n, halos=n_halos,
                inputs_sha256=sha, largest_solve_K=k_solve, largest_K=k_any,
                wbox_dispatches=wbox, reduced=None)


def box_inputs(name):
    """(ParticleSet, catalog, species) of a run_so box, as chip_smoke.py
    builds it."""
    from so_tpu_torch.io.tipsy import DARK, GAS, STAR

    if name.startswith("standard_"):
        species = (DARK, GAS, STAR) if name == "standard_species" else ()
        box = chip_smoke.make_standard_box()
        ps, catalog = chip_smoke.particles_and_catalog(box, species,
                                                       chip_smoke.SEED)
        return ps, catalog(), species
    giant = chip_smoke.giant_config()
    mass = dict(giant["masses"])[name.split("_")[1]]
    ps, catalog = chip_smoke.giant_inputs(giant, mass)
    return ps, catalog(), ()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=chip_smoke.REF_DIR)
    ap.add_argument("--box", action="append", choices=BOXES)
    a = ap.parse_args(argv)
    import jax

    jax.config.update("jax_platforms", "cpu")
    os.makedirs(a.out, exist_ok=True)
    path = os.path.join(a.out, "manifest.json")
    manifest = dict(boxes={})
    if os.path.exists(path):
        with open(path) as f:
            manifest = json.load(f)
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                            capture_output=True, text=True).stdout.strip()
    manifest.update(so_tpu_commit=commit or None, jax=jax.__version__,
                    platform=jax.devices()[0].platform,
                    so_tpu_sources_sha256=so_tpu_sources_sha256())
    command = "python tests/make_torch_refs.py" + "".join(
        f" --box {b}" for b in a.box or ())
    for name in a.box or BOXES:
        t0 = time.perf_counter()
        if name == "zoom":
            entry = write_zoom(a.out, **chip_smoke.ZOOM_BOX)
        else:
            entry = write_box(name, *box_inputs(name), a.out)
        manifest["boxes"][name] = dict(entry, command=command)
        print(f"{name}: {entry} ({time.perf_counter() - t0:.1f} s with the "
              "box)", flush=True)
        with open(path, "w") as f:
            json.dump(manifest, f, indent=1, sort_keys=True)
            f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
