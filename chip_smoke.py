#!/usr/bin/env python3
"""Drive so_tpu_torch's main path once on one CUDA card, end to end.

    python3 chip_smoke.py        (from the root of a checkout; needs a card)

Phases, each printing its own lines and seconds; any failure raises and the
script exits nonzero:

  1. environment: torch/CUDA versions, the card's name and power limit
  2. build: nvcc compiles so_tpu_torch/csrc/*.cu into so_tpu_torch/_build/
  3. kernels against their plain torch versions on the card, at main-path
     shapes: K1 (slab gather) at B=4096, K=4096, chunk 256 and 128, with
     0, 1, 2 and 5 float channels, on the 2^21-particle payload; K2 (serial
     f32 row cumsum) at (16384, 4096). Equality is exact (tolerance 0).
  4. the main path, run_so on "cuda", on bench.py's standard box (2^21
     particles, 16,384 halos, seed 12345, Delta 178): uniform masses, then
     masses from uniform(0.5, 1.5)/N with three species (puts K2 on the
     path); one cold and WARM_RUNS warm runs of each, with the median and
     range of the warm phase seconds. Both kernels' launch counters,
     zeroed just before, must grow.
  5. GPU against CPU: the same pipeline with device="cpu" on a 2^18 /
     2,048-halo box of each kind must give identical bits (codes, Mvir,
     Rvir, j, d2cut, membership, conflict counters, derived quantities);
     a few halos are also checked against tests/reference_oracle.py.
  6. CLI: python -m so_tpu_torch on a tipsy snapshot + .gtp of the 2^18
     box with -grp -gtp -all; every output file must exist and hold groups.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
THR = 178.0
SEED = 12345
WARM_RUNS = 5      # timed runs of each standard box after its cold run


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps):
    """Mean milliseconds per call on the card (CUDA events, after one warm
    call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def max_abs_err(a, b):
    """Largest |a-b| over entries finite in both; infinities and NaNs must
    sit at the same places (raises otherwise)."""
    import torch

    a, b = a.float(), b.float()
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    if not torch.equal(fa, fb) or not torch.equal(a[~fa].nan_to_num(0.0),
                                                  b[~fb].nan_to_num(0.0)):
        raise AssertionError("non-finite entries differ")
    return float((a[fa] - b[fb]).abs().max()) if fa.any() else 0.0


def assert_same_bits(name, a, b):
    import torch

    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    if not torch.equal(a, b):
        raise AssertionError(f"{name}: kernel and plain version differ")


def phase_env():
    import torch

    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ""
    if not card:
        raise RuntimeError("nvidia-smi gave no card: " + smi.stderr)
    log(card)
    return card


def phase_build():
    from so_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    path = _cuda.build()
    _cuda.library()
    log(f"[build] {path.name} in {time.perf_counter() - t0:.3f} s")


def make_standard_box():
    import numpy as np

    from bench import make_box

    t0 = time.perf_counter()
    pos, mass, vel, centers, rgtp = make_box(np.random.default_rng(SEED),
                                             1 << 21, 16384)
    log(f"[box] standard: {pos.shape[0]} particles, {centers.shape[0]} "
        f"halos, made in {time.perf_counter() - t0:.1f} s")
    return pos, mass, vel, centers, rgtp


def phase_kernels(box):
    """K1 and K2 against their plain versions at main-path shapes."""
    import dataclasses

    import numpy as np
    import torch

    from so_tpu_torch.engine.solver import ladder_radius, _pick_level_span
    from so_tpu_torch.ops import seqsum, slab_gather
    from so_tpu_torch.ops.gather import cell_ranges
    from so_tpu_torch.ops.grid import build_grid

    dev = torch.device("cuda")
    pos, mass, vel, centers, rgtp = box
    grid = build_grid(pos, mass, vel=vel, device=dev)
    B, K = min(4096, centers.shape[0]), 4096
    c = torch.as_tensor(centers[:B], device=dev)
    radii_np = ladder_radius(rgtp[:B], np.ones(B, np.int32))  # first rung
    r = torch.as_tensor(radii_np, device=dev)
    level, S = _pick_level_span(grid, float(radii_np.max()))
    rows = {}
    for chunk in (256, 128):
        g = grid if chunk == grid.chunk else dataclasses.replace(
            grid, chunk=chunk, soa8t=grid.soa8t[:, :grid.n + chunk]
            .contiguous())
        st, cnt, q, total = cell_ranges(g, level, c, r, r * r, S,
                                        align=chunk)
        desc = slab_gather.chunk_descriptors(st, cnt, q, K, chunk)
        for chans, want_idx in (((), False), (("mass",), False),
                                (("mass", "meta"), True),
                                (("mass", "mvx", "mvy", "mvz", "meta"), True)):
            args = (g.soa8t, *desc, c, g.period, r * r, K, chunk, chans,
                    want_idx)
            got = slab_gather.slab_gather_rows(*args)
            want = slab_gather.slab_gather_plain(*args)
            torch.cuda.synchronize()
            err = 0.0
            for name, a, b in zip(("d2", "channels", "idx"), got, want):
                if a is None:
                    continue
                assert_same_bits(f"K1 {name}", a, b)
                err = max(err, max_abs_err(a, b))
            ms = cuda_ms(lambda: slab_gather.slab_gather_rows(*args), 20)
            plain_ms = cuda_ms(lambda: slab_gather.slab_gather_plain(*args), 3)
            tag = f"chunk={chunk} nch={len(chans)} idx={int(want_idx)}"
            log(f"[K1] B={B} K={K} level={level} S={S} {tag}: exact, "
                f"max_abs_err {err} kernel {ms:.4f} ms plain {plain_ms:.4f} "
                f"ms ({int((total > K).sum())} rows past K)")
            rows[(chunk, len(chans))] = dict(max_abs_err=err, ms=ms,
                                             plain_ms=plain_ms, shape=
                                             f"B={B} K={K} {tag}")
    k1 = rows[(256, 1)]       # the general-mass solve stage's shape

    x = torch.rand((16384, 4096), generator=torch.Generator(device=dev)
                   .manual_seed(SEED), device=dev)
    got = seqsum.seq_cumsum(x)
    want = seqsum.seq_cumsum_plain(x)
    torch.cuda.synchronize()
    assert_same_bits("K2", got, want)
    err = max_abs_err(got, want)
    ms = cuda_ms(lambda: seqsum.seq_cumsum(x), 5)
    plain_ms = cuda_ms(lambda: seqsum.seq_cumsum_plain(x), 1)
    log(f"[K2] (16384, 4096): exact, max_abs_err {err} kernel {ms:.4f} ms "
        f"plain {plain_ms:.4f} ms")
    k2 = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
              shape="B=16384 K=4096")
    del grid, x, got, want
    torch.cuda.empty_cache()
    return k1, k2


def particles_and_catalog(box, species, seed):
    """(ParticleSet, catalog factory) for a make_box box: uniform masses,
    or masses from uniform(0.5, 1.5)/N split over gas/dark/star."""
    import numpy as np

    from so_tpu.io.catalogs import GroupCatalog
    from so_tpu.io.tipsy import ParticleSet, TipsyHeader

    pos, mass, vel, centers, rgtp = box
    rng = np.random.default_rng(seed + 1)     # catalog masses, as bench.py
    gtp_mass = rng.uniform(0.001, 1.0, centers.shape[0]).astype(np.float32)
    n = pos.shape[0]
    if species:
        mass = (rng.uniform(0.5, 1.5, n) / n).astype(np.float32)
        perm = rng.permutation(n)             # species spatially mixed
        pos, vel, mass = pos[perm], vel[perm], mass[perm]
        split = (n // 5, n - n // 5 - n // 7, n // 7)
    else:
        split = (0, n, 0)
    hdr = TipsyHeader(time=1.0, nbodies=n, ndim=3, nsph=split[0],
                      ndark=split[1], nstar=split[2])
    ps = ParticleSet(hdr, pos, vel, mass, np.zeros(n, np.float32),
                     np.zeros(n, np.float32))
    G = centers.shape[0]

    def catalog():
        return GroupCatalog(index=np.arange(1, G + 1, dtype=np.int32),
                            pos=centers.copy(), rgtp=rgtp, gtp_mass=gtp_mass,
                            n_in_gtp=G, gtp_time=1.0)
    return ps, catalog


def run(ps, catalog, species, device):
    from so_tpu_torch.engine.pipeline import SOParams, run_so

    t0 = time.perf_counter()
    out = run_so(ps, catalog(), SOParams(threshold=THR, species=species,
                                         device=device))
    return out, time.perf_counter() - t0


def check_run(tag, out, n_halos):
    import numpy as np

    code = out.solve.code
    ok = code == 0
    if not ok.any():
        raise AssertionError(f"{tag}: no halo solved")
    for f in ("mvir", "rvir", "d2cut"):
        v = getattr(out.solve, f)
        if v.shape != (n_halos,) or not np.isfinite(v).all() \
                or (v[ok] <= 0).any():
            raise AssertionError(f"{tag}: bad {f}")
    sizes = np.array([0 if m is None else m.size for m in out.members])
    if not np.array_equal(sizes[ok], out.solve.j[ok]):
        raise AssertionError(f"{tag}: member lists do not hold j rows")
    for f in ("vcirc", "rmass", "rmax", "vmax"):
        if not np.isfinite(getattr(out.derived, f)).all():
            raise AssertionError(f"{tag}: non-finite {f}")
    return np.bincount(-code[code <= 0], minlength=4).tolist()


def phase_main_path(box):
    from so_tpu.io.tipsy import DARK, GAS, STAR
    from so_tpu_torch.ops import seqsum, slab_gather

    runs = [("uniform", (), SEED), ("species", (DARK, GAS, STAR), SEED)]
    inputs = [(tag, sp, *particles_and_catalog(box, sp, seed))
              for tag, sp, seed in runs]
    slab_gather.launches = 0
    seqsum.launches = 0
    for tag, sp, ps, catalog in inputs:
        warm = []
        for rep in ["cold"] + [f"warm {i + 1}" for i in range(WARM_RUNS)]:
            out, e2e = run(ps, catalog, sp, "cuda")
            ph = out.phases
            post = sum(v for k, v in ph.items()
                       if k not in ("grid build", "R_Delta solve"))
            n = out.catalog.n
            codes = check_run(tag, out, n)
            log(f"[main {tag} {rep}] particles={ps.n} halos={n} "
                f"ok/-1/-2/-3={codes} grid {ph['grid build']:.4f} s "
                f"solve {ph['R_Delta solve']:.4f} s "
                f"({n / ph['R_Delta solve']:.0f} solves/s) post-solve "
                f"{post:.4f} s e2e {e2e:.4f} s ({n / e2e:.0f} halos/s)")
            if rep != "cold":
                warm.append(dict(ph, **{"post-solve": post, "e2e": e2e}))
        med = {k: statistics.median(w[k] for w in warm) for k in warm[0]}
        e2es = [w["e2e"] for w in warm]
        log(f"[main {tag} median of {len(warm)} warm] e2e {med['e2e']:.4f} s "
            f"(range {min(e2es):.4f}-{max(e2es):.4f}; {n / med['e2e']:.0f} "
            f"halos/s) solve {med['R_Delta solve']:.4f} s "
            f"({n / med['R_Delta solve']:.0f} solves/s) phases "
            + ", ".join(f"{k} {v:.4f}" for k, v in med.items()
                        if k not in ("e2e", "R_Delta solve")))
    counts = dict(K1=slab_gather.launches, K2=seqsum.launches)
    log(f"[main] launches in the main-path runs: {counts}")
    if min(counts.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never ran: {counts}")
    return counts


def phase_gpu_vs_cpu(small):
    import numpy as np

    from so_tpu.io.tipsy import DARK, GAS, STAR

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from reference_oracle import oracle_rvir

    for tag, sp in (("uniform", ()), ("species", (DARK, GAS, STAR))):
        ps, catalog = particles_and_catalog(small, sp, SEED + 7)
        g, tg = run(ps, catalog, sp, "cuda")
        c, tc = run(ps, catalog, sp, "cpu")
        pairs = [(f"solve.{f}", getattr(g.solve, f), getattr(c.solve, f))
                 for f in ("code", "mvir", "rvir", "j", "d2cut", "vcm")]
        pairs += [(f"conflicts.{f}", getattr(g.conflicts, f),
                   getattr(c.conflicts, f))
                  for f in ("igrp", "n_subsumed", "n_ignored", "mvir",
                            "rvir")]
        pairs += [(f"derived.{f}", getattr(g.derived, f),
                   getattr(c.derived, f))
                  for f in ("vcirc", "rmass", "rmax", "vmax")]
        pairs += [(f"profile {s}", g.derived.profiles[s],
                   c.derived.profiles[s]) for s in sp]
        for name, a, b in pairs:
            if a.dtype != b.dtype or a.tobytes() != b.tobytes():
                raise AssertionError(f"{tag}: {name} differs GPU vs CPU")
        for h, (ma, mb) in enumerate(zip(g.members, c.members)):
            if (ma is None) != (mb is None) or (
                    ma is not None and not np.array_equal(ma, mb)):
                raise AssertionError(f"{tag}: members of halo {h} differ")
        # a few halos against the brute-force oracle (tests/)
        picks = np.nonzero(g.solve.code == 0)[0][:4].tolist() + \
            np.nonzero(g.solve.code != 0)[0][:2].tolist()
        for h in picks:
            want = oracle_rvir(ps.pos, ps.mass, small[3][h], small[4][h],
                               (1.0, 1.0, 1.0), THR, 8)
            if g.solve.code[h] != want["code"] or (
                    want["code"] == 0 and abs(g.solve.mvir[h] - want["mvir"])
                    > 2e-5 * abs(want["mvir"])):
                raise AssertionError(f"{tag}: halo {h} disagrees with the "
                                     f"oracle: {want}")
        log(f"[gpu-vs-cpu {tag}] particles={ps.n} halos={catalog().n}: "
            f"{len(pairs)} fields and all member lists bit-identical; "
            f"{len(picks)} halos agree with the oracle; cuda {tg:.3f} s, "
            f"cpu {tc:.3f} s")


def phase_cli(small):
    import numpy as np

    from so_tpu.io.tipsy import (DARK_DTYPE, GAS_DTYPE, STAR_DTYPE,
                                 TipsyHeader, write_tipsy)

    pos, mass, vel, centers, rgtp = small
    out = os.path.join(HERE, "so_tpu_torch", "_build", "chip_smoke_cli")
    os.makedirs(out, exist_ok=True)
    n = pos.shape[0]
    ngas, nstar = n // 5, n // 7
    ndark = n - ngas - nstar
    recs = []
    for dt, sl in ((GAS_DTYPE, slice(0, ngas)),
                   (DARK_DTYPE, slice(ngas, ngas + ndark)),
                   (STAR_DTYPE, slice(ngas + ndark, n))):
        r = np.zeros(sl.stop - sl.start, dtype=dt[False])
        r["mass"], r["pos"], r["vel"] = mass[sl], pos[sl], vel[sl]
        recs.append(r)
    write_tipsy(f"{out}/snap.bin", TipsyHeader(time=1.0, nbodies=n, ndim=3,
                                               nsph=ngas, ndark=ndark,
                                               nstar=nstar), *recs, False)
    G = centers.shape[0]
    gtp = np.zeros(G, dtype=STAR_DTYPE[False])
    gtp["mass"] = np.random.default_rng(SEED + 2).uniform(0.001, 1.0, G)
    gtp["pos"], gtp["eps"] = centers, rgtp
    gtp["tform"] = np.arange(1, G + 1)
    write_tipsy(f"{out}/cat.gtp", TipsyHeader(time=1.0, nbodies=G, ndim=3,
                                              nsph=0, ndark=0, nstar=G),
                None, None, gtp, False)
    cmd = [sys.executable, "-m", "so_tpu_torch", "-i", f"{out}/cat.gtp",
           "-o", f"{out}/got", "--tipsy", f"{out}/snap.bin", "-grp", "-gtp",
           "-all", "-delta", "178"]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                       timeout=600)
    if r.returncode != 0:
        raise RuntimeError("CLI failed:\n" + r.stderr[-3000:])
    for ext in ("sovcirc", "sogrp", "sogtp", "sodark", "sogas", "sostar"):
        p = f"{out}/got.{ext}"
        if not os.path.exists(p) or os.path.getsize(p) == 0:
            raise AssertionError(f"CLI wrote no {p}")
    rows = [ln.split() for ln in open(f"{out}/got.sovcirc")
            if ln.strip() and not ln.startswith("#")]
    found = sum(1 for t in rows if float(t[1]) > 0)
    igrp = np.loadtxt(f"{out}/got.sogrp", dtype=np.int64)
    if found == 0 or len(rows) != G or igrp[0] != n \
            or (igrp[1:] > 0).sum() == 0:
        raise AssertionError(f"CLI found no groups ({found} of {len(rows)})")
    log(f"[cli] python -m so_tpu_torch -grp -gtp -all: {found} of {G} "
        f"groups found, {(igrp[1:] > 0).sum()} particles grouped, "
        f"{time.perf_counter() - t0:.1f} s")


def main():
    if not os.path.isdir(os.path.join(HERE, "so_tpu_torch")):
        sys.stderr.write("chip_smoke.py: run it from the root of a checkout "
                         "(so_tpu_torch/ not found beside it)\n")
        return 2
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke.py: torch sees no CUDA device\n")
        return 2
    t_all = time.perf_counter()
    timings = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        timings[name] = time.perf_counter() - t0
        log(f"[phase] {name}: {timings[name]:.1f} s")
        return out

    timed("environment", phase_env)
    timed("build", phase_build)
    box = timed("standard box", make_standard_box)
    k1, k2 = timed("kernels", phase_kernels, box)
    counts = timed("main path", phase_main_path, box)
    del box
    from bench import make_box

    small = make_box(np.random.default_rng(SEED), 1 << 18, 2048)
    timed("gpu vs cpu", phase_gpu_vs_cpu, small)
    timed("cli", phase_cli, small)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")

    kernels = [
        dict(name="slab_gather", route="cuda",
             source="so_tpu_torch/csrc/slab_gather.cu",
             replaces="so_tpu/ops/pallas_gather.py:325",
             launches=counts["K1"], **k1),
        dict(name="seqsum", route="cuda",
             source="so_tpu_torch/csrc/seqsum.cu",
             replaces="so_tpu/ops/seqsum.py:18",
             launches=counts["K2"], **k2),
    ]
    log(f"[done] {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
