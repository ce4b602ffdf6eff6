#!/usr/bin/env python3
"""Drive so_tpu_torch's main path once on one CUDA card, end to end.

    python3 chip_smoke.py        (from the root of a checkout; needs a card)

Phases, each printing its own lines and seconds; any failure raises and the
script exits nonzero:

  1. environment: torch/CUDA versions, the card's name and power limit,
     its maximum SM clock (the chain term of K2's bound: 4 cycles a
     dependent f32 add)
  2. build: nvcc compiles so_tpu_torch/csrc/*.cu into so_tpu_torch/_build/
  3. kernels against their plain torch versions on the card, at main-path
     shapes: K1 (slab gather), both forms, on the 2^21-particle payload
     with 48 particles moved onto the first halo's center (equal d2, +0.0):
     the slotted form at B=4096, K=4096, chunk 256 and 128, with 0, 1, 2
     and 5 float channels; the sorted form there too and, at chunk 256, at
     (16384, 512), (1024, 2^14) and (3, 8192) with 0, 1 and 3 channels
     (+idx), d2, every channel, idx and n_in bit for bit. Each [K1] line
     gives the form's ms by CUDA events around the calls and its device ms
     (the calls replayed from one CUDA graph), its bound, and for the
     sorted form the route it replaces (the slotted kernel, the count of
     finite d2, torch.sort and the gathers) as "unfused". K2 (serial
     f32 row cumsum) over its dispatch ladder (K2_LADDER: the solve's
     2^26-slot tiers from (16384, 2^12) to (8, 2^23), the fused pass's
     2^25-slot tiers at K = 2^12 and 2^22, the survey prefix's (16384, 16),
     and (1000, 4097)), with and without a random n_valid, each shape's
     kernel ms by CUDA events around the calls (as K1 and K3, the
     wrapper's host cost included) and its device ms (the calls replayed
     from one CUDA graph), beside its bytes and chain bounds (k2_study.py
     holds the measurements that chose K2's forms). K3 (run-level piece
     gather) against its plain version and against K1 on the giant box
     (below), B = 8 and 64 halos about the clump, K = 2^18 and 2^21, d2
     only / mass / mass + meta + idx, with K1's time beside K3's and the
     device ms of both (k3_study.py holds the measurements that chose K3's
     design). The cell enumeration (ops/ranges.slab_ranges: the kernel of
     csrc/cell_ranges.cu, one launch) against its plain version on the
     standard box's grid, at (16,384 halos, the first ladder rung, K =
     4096: K1's descriptors) and (the 8 largest halos, radii 0.08-0.2,
     level 1, S = 7, K = 2^21: K3's): (cnt, q, total) everywhere, st where
     cnt > 0 and the descriptors below n_total / n_pieces; its ms, device
     ms, the plain version's ms and its bytes bound (ranges_bytes).
     Equality is exact (tolerance 0). K1's and K3's bytes bounds
     count each payload row once however many of the batch's balls hold
     it (gather_reads).
  4. the main path, run_so on "cuda", on bench.py's standard box (2^21
     particles, 16,384 halos, seed 12345, Delta 178): uniform masses, then
     masses from uniform(0.5, 1.5)/N with three species (puts K2 on the
     path); one cold and WARM_RUNS warm runs of each, with the median and
     range of the warm phase seconds. The launch counters of K1, its
     sorted form, K2 and the cell enumeration, zeroed just before, must
     grow.
  5. GPU against CPU: the same pipeline with device="cpu" on a 2^18 /
     2,048-halo box of each kind must give identical bits (codes, Mvir,
     Rvir, j, d2cut, membership, conflict counters, derived quantities);
     a few halos are also checked against tests/reference_oracle.py.
  6. CLI: python -m so_tpu_torch on a tipsy snapshot + .gtp of the 2^18
     box with -grp -gtp -all; every output file must exist and hold groups.
  7. -pot: run_so(b_pot=True) on the three-species standard box, phi from
     np.random.default_rng(SEED); one cold and POT_WARM_RUNS warm runs,
     with the recenter phase's seconds. On the 2^18 box the CUDA and CPU
     runs must give identical centers and fields.
  8. --deltas: run_so_multi on the three-species standard box at Delta
     200, 340, 667 (R_200m, R_vir at z=0 for Omega_m=0.3, R_200c, in mean
     density units), against an independent run_so per threshold on one
     prebuilt grid: codes, Mvir, Rvir, j, members and igrp bit-identical;
     the multi solve's seconds beside the sum of the single solves.
  9. --survey: solve_rvir on bench.py's dense box (2^23 particles, 65,536
     halos), uniform and three-species masses, with the pre-pass forced,
     auto-gated and off: identical results, and the forced pass must
     resolve halos; solve seconds and the halos the classifier resolved.
     Then the classifier itself, card against CPU: the packed -1/-2
     verdicts of every 16th dense-box halo at its first ladder radius
     (4,096 halos, four thresholds), bit for bit, for both mass kinds;
     at least one -2 verdict must be among them.
 10. the CLI's new paths, in process on a tipsy file of the 2^18 box with
     three-species masses and phi: -pot, --deltas 200,340,667, a
     --checkpoint run done twice (the second resumes and writes the same
     bytes but for the headers' run time), and --profile (a
     torch.profiler Chrome trace).
 11. giant: scripts/compare_reference_giant.py's configuration (seed
     515151: one r^-2 clump of 1.6e6 particles on 3.4e6 uniform ones, 4
     giant centers on the clump and 60 small ones), run_so on "cuda" with
     general, then uniform masses. K1 and K3 must run in both, K2 in the
     general one; K3's launches per (B, K) are logged, and the general
     run must dispatch K3 at 2^21 slots or more; the 4 giant halos' code,
     Mvir and Rvir must match tests/reference_oracle.py (rel 2e-5). The
     general run is repeated
     with the in-ball counts K2's callers pass dropped (chains over all K
     slots): every field must be identical. Then the same configuration at
     200,000 / 120,000 / 12 with gather.PIECE_K_MIN lowered to 2^12, so
     K3 serves most dispatches, on "cuda" and "cpu": identical bits.
 12. --mesh: run_so_sharded (so_tpu_torch/parallel) on 1x4 and 2x2 meshes
     of cuda:0 over the standard box, uniform and three-species masses,
     each against the card's run_so on the same inputs (uniform: every
     field and member list bit for bit, a list allowed to differ only in
     its order within equal d2; three species: codes, j and member sets
     exact, Mvir, Rvir and d2cut to rtol 2e-6), with cold and warm solve
     and e2e seconds beside the single-device run's; run_so_multi_sharded
     at Delta 200, 340, 667 on the 2x2 mesh against run_so_multi; the
     reduced giant box (PIECE_K_MIN 2^12) on a 1x2 mesh against run_so;
     and the CLI's --mesh 1x1 against the plain CLI on phase 6's files.
     Each [mesh] line counts the halos whose bits or member order differ
     and the equal-d2 pairs in their balls.
 13. --distributed: the standard box (both mass kinds) written as a tipsy
     snapshot and .gtp; the port's CLI in this process on cuda:0 with
     -grp -gtp -subsumed -ignored is the witness; then
     `python -m so_tpu_torch ... --distributed` as one rank (the default
     backend: NCCL for the card's tensors, gloo for host arrays) and as
     two ranks sharing cuda:0 (--dist-backend gloo; NCCL refuses two
     ranks on one card), spawned with torchrun's variables and a free
     port. Every output file must equal the witness's but for the run
     time; every rank reports its K1/K1s/K2/K3 launches ([dist] lines;
     K1s on every rank, K2 in the general-mass runs), with the SO CPU
     Time (solve through stats), e2e seconds and rank 0's phase seconds
     beside the witness's. After phase 10, two ranks on the
     2^18 files of phase 10: --deltas 200,340,667 and -pot against phase
     10's files, and -pot --checkpoint twice (the second resumes from the
     two rank shards) with the same bytes.
 14. 512^3: so_tpu's largest catalog (experiments/scale512.py),
     make_box(rng(12345), 512**3, 65536), uniform masses: run_so at Delta
     178 (phase seconds, solves/s, e2e, launches, peak device memory and
     host peak RSS); the 4 largest solved and 4 random halos against
     tests/reference_oracle.py (rel 2e-5); run_so_multi at 178/200/500 on
     a prebuilt grid, whose 178 run equals run_so's in every field and
     member list.
 15. survey box: bench.py's make_box(rng(12345), 2**25, 1_000_000) (46.1M
     particles): solve_rvir with survey None, True and False (the gate's
     verdict, n_survey, seconds, peak device memory; identical results),
     then run_so end to end with its phase seconds and peak device memory;
     its 8 largest and 8 random other solved halos (seed 12345) against
     tests/reference_oracle.py (rel 2e-5), four at a time.
 16. goldens: the 17 reference scenarios (tests/goldens; inputs from
     tests/torch_scenarios.py, which imports nothing of so_tpu) through the
     port's CLI in this process on "cuda", held by tests/torch_compare.py
     to tests/test_torch_golden.py's rules (catalogs to float tolerance,
     .sogrp/.sosub/.soign exactly, .sogtp field by field); the set runs at
     the default routes, then with gather.PIECE_K_MIN at 512 (K3 and
     sort_in_ball on every gather above 512 slots; K3 must run). One
     [golden] line per scenario and route: seconds and launches.
 17. so_tpu at scale: the card against so_tpu's own outputs, written on
     the CPU by tests/make_torch_refs.py into tests/torch_refs (the
     inputs' sha256 checked against its manifest): the cold main-path runs
     of phase 4 (standard box, both mass kinds) and the giant runs of
     phase 11 (both mass kinds), not run again, by compare_to_ref: code,
     Mvir, Rvir, j, vcm, the conflict pass's arrays, member sets, Vc and
     profiles bit for bit; d2cut, rmass, rmax and vmax so_tpu's or, for a
     halo where they differ (so_tpu's d2 sum is contracted into FMAs on
     the CPU), the per-op numpy witness's (D2Witness), so_tpu's then
     equal to the fused witness's. Then
     scripts/compare_reference_zoom.py's box (7.3M particles, 4,096
     halos) through the port's CLI on "cuda" with its flags, every file
     held to so_tpu's by that script's rules.
 18. surface: so_tpu's library entry points beside the CLI on the
     standard box (after phase 13): extract_members_sharded on a 1x2 mesh
     of cuda:0 against the CellGrid's extract_members, at the default
     routes and with PIECE_K_MIN at 512 (K3); scan_sorted at (16384,
     4096) on both mass kinds against its plain version and against
     solve_rvir; ragged_ball_gather for 4,096 halos, card against CPU,
     both sort modes; the batched Delta_vir and Romberg against the host
     scalars (phase_surface's docstring has the rules). One [surface]
     line a check, with its seconds and launches.

Phases 4, 7-10, each sharded run of 12, each rank of 13 (a fresh process)
each giant run, each run or solve of 14 and 15, each CLI run of 16, the
zoom run of 17 and each check of 18 zero every kernel's launch counter
before they start and fail unless their kernels grew, K1's sorted form
among them and, with any gather kernel, the cell enumeration's (9's
card-against-CPU check runs after its count is read), and log K2's
launches per (B, K). The line before
the last is a JSON object with one entry per kernel (launches summed
over those phases; bounds from this run's inputs at the card's 3.35 TB/s
and 67 TFLOP/s f32 and, for K2, its longest chain of dependent adds; every
entry has its graph-replayed "device_ms"; K1's adds the sorted form's
"sorted_ms", "sorted_device_ms", "sorted_bound_ms", "unfused_ms" and
"sorted_launches", K2's and the cell enumeration's their giant-row
figures under "giant_rows"); the
last line is
{"ok": true, "device": {...}}.
The card's name and power limit are printed by phase 1.
"""

import json
import os
import statistics
import subprocess
import sys
import time
import types

HERE = os.path.dirname(os.path.abspath(__file__))
THR = 178.0
SEED = 12345
WARM_RUNS = 5      # timed runs of each standard box after its cold run
POT_WARM_RUNS = 3  # timed -pot runs after its cold run
DELTAS = (200.0, 340.0, 667.0)
MULTI_ROUNDS = 3   # timed multi-vs-singles rounds after the cold multi run
SURVEY_ROUNDS = 3  # timed rounds of the three survey modes after a warm-up
GIANT_SEED = 515151
MESH_SHAPES = ((1, 4), (2, 2))   # --mesh phase: meshes of cuda:0
MESH_WARM_RUNS = 2  # timed runs of each mesh after its cold run
# launches summed over the paths; K1 counts both of its forms, K1s the
# sorted form's share, "ranges" the cell enumeration's
LAUNCHES = {"K1": 0, "K1s": 0, "K2": 0, "K3": 0, "ranges": 0}
K2_SHAPES = {}             # K2 launches per (B, K), summed over the paths
# run_record, ParticleSet and centers of the runs that the "so_tpu at
# scale" phase holds to tests/torch_refs, by box name
AT_SCALE = {}
REF_DIR = os.path.join(HERE, "tests", "torch_refs")
# run_record's fields that read a particle's d2 bits: XLA:CPU contracts
# so_tpu's d2 sum into FMAs, the port rounds every op (ROADMAP section 3,
# "Intended"), so a halo where one differs is held to the per-op witness
# and so_tpu's value there to the fused one
D2_FIELDS = ("d2cut", "rmass", "rmax", "vmax")
# compare_reference_zoom.py's configuration (main, :64-71) and flags (:47)
ZOOM_BOX = dict(n_hi=6 << 20, n_lo=1 << 20, n_halos=4096)
ZOOM_FLAGS = ["-all", "-grp", "-gtp", "-subsumed", "-ignored"]
ZOOM_FLOAT = ("sovcirc", "sodark", "sogas", "sostar")
ZOOM_EXACT = ("sogrp", "sosub", "soign")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12      # H100 SXM f32 outside the tensor cores
FADD = {"cycles": 4.0, "sm_hz": None}   # one dependent f32 add; phase_env
                                        # reads the SM clock


def bound(nbytes, ops, chain=0):
    """(bound_ms, bound_by): the least time for the bytes a function must
    move, the f32 operations it must do (at the card's peak rates) and its
    longest chain of dependent adds (FADD cycles each at the SM clock)."""
    terms = {"bytes": nbytes / HBM_BYTES_PER_S,
             "operations": ops / F32_OPS_PER_S,
             "chain": chain * FADD["cycles"] / FADD["sm_hz"] if chain else 0}
    by = max(terms, key=terms.get)
    return terms[by] * 1e3, by


def k2_bound(B, K, n_valid=None):
    """bound() of one K2 call: the valid slots read once (and the counts),
    every slot written once, one add per valid slot, and the longest row's
    chain."""
    if n_valid is None:
        n, longest, extra = B * K, K, 0
    else:
        nv = n_valid.clamp(0, K)
        n, longest, extra = int(nv.sum()), int(nv.max()), 8 * B
    return bound(4 * (n + B * K) + extra, n, longest)


def make_box(rng, n_particles, n_halos):
    """Clustered box: half the mass in r^-2 halos, half uniform.
    (A copy of bench.py:35-59, so this script needs nothing of the JAX
    side.)"""
    import numpy as np

    n_clumped = n_particles // 2
    n_bg = n_particles - n_clumped
    # halo sizes: power-law-ish distribution over the requested halo count
    sizes = rng.pareto(1.5, n_halos) + 1.0
    sizes = np.maximum((sizes / sizes.sum() * n_clumped).astype(np.int64), 24)
    centers = rng.uniform(-0.5, 0.5, (n_halos, 3)).astype(np.float32)
    # rmax such that the clump is a genuine overdensity (edge density well
    # above the Delta=178 threshold for a particle mass of 1/N)
    rmax = (0.0012 * sizes.astype(np.float64) ** (1 / 3)).astype(np.float32)

    chunks = [rng.uniform(-0.5, 0.5, (n_bg, 3)).astype(np.float32)]
    for c, n, rm in zip(centers, sizes, rmax):
        r = rm * rng.uniform(0.001, 1.0, n)
        u = rng.normal(size=(n, 3))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        p = c[None, :] + (r[:, None] * u).astype(np.float32)
        chunks.append(((p + 0.5) % 1.0 - 0.5).astype(np.float32))
    pos = np.concatenate(chunks)
    n_tot = pos.shape[0]
    mass = np.full(n_tot, 1.0 / n_tot, np.float32)
    vel = np.zeros((n_tot, 3), np.float32)
    rgtp = np.maximum(rmax, 0.001).astype(np.float32)
    return pos, mass, vel, centers, rgtp


def make_giant_box(rng, n_bg, n_clump):
    """One r^-2 mega-clump holding half the box mass + uniform bg.
    (A copy of scripts/compare_reference_giant.py:61-72.)"""
    import numpy as np

    c = np.array([0.1, -0.05, 0.2], np.float32)
    rmax = 0.08
    r = rmax * rng.uniform(0.0005, 1.0, n_clump)
    u = rng.normal(size=(n_clump, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    clump = ((c[None, :] + (r[:, None] * u).astype(np.float32) + 0.5)
             % 1.0 - 0.5).astype(np.float32)
    bg = rng.uniform(-0.5, 0.5, (n_bg, 3)).astype(np.float32)
    pos = np.concatenate([bg, clump])
    return pos, c, rmax


def giant_config(n_bg=3_400_000, n_clump=1_600_000, n_small=60):
    """scripts/compare_reference_giant.py's configuration (main, :148-182):
    positions, the 4 giant + n_small centers, rgtp, catalog masses and
    the general and uniform particle masses, all from GIANT_SEED."""
    import numpy as np

    rng = np.random.default_rng(GIANT_SEED)
    pos, c, _ = make_giant_box(rng, n_bg, n_clump)
    n = pos.shape[0]
    giant_c = np.stack([c, c + np.float32(0.004), c - np.float32(0.003),
                        c + np.array([0.006, -0.002, 0.001], np.float32)])
    small_c = rng.uniform(-0.45, 0.45, (n_small, 3)).astype(np.float32)
    centers = np.concatenate([giant_c, small_c]).astype(np.float32)
    rgtp = np.concatenate([np.full(4, 0.02, np.float32),
                           rng.uniform(0.01, 0.05, n_small)
                           .astype(np.float32)])
    cat_mass = rng.uniform(0.001, 1.0, centers.shape[0]).astype(np.float32)
    mass_u = np.full(n, np.float32(1.0 / n), np.float32)
    mass_g = rng.uniform(0.5, 1.5, n).astype(np.float32) / np.float32(n)
    return dict(pos=pos, centers=centers, rgtp=rgtp, cat_mass=cat_mass,
                masses=(("general", mass_g), ("uniform", mass_u)))


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


def graph_ms(fn, reps):
    """Mean device milliseconds per call: reps calls captured in one CUDA
    graph, timed by CUDA events around a replay (after a warm replay), so
    a launch-bound call is timed without the Python wrapper's cost."""
    import torch

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    g.replay()
    t1.record()
    torch.cuda.synchronize()
    ms = t0.elapsed_time(t1) / reps
    del g
    torch.cuda.empty_cache()
    return ms


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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    mhz = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ""
    if not mhz.endswith("MHz"):
        raise RuntimeError("nvidia-smi gave no SM clock: " + smi.stderr)
    FADD["sm_hz"] = float(mhz.split()[0]) * 1e6
    ns = FADD["cycles"] / FADD["sm_hz"] * 1e9
    log(f"[env] clocks.max.sm {mhz}: one dependent f32 add = "
        f"{FADD['cycles']:g} cycles = {ns:.4f} ns (the chain term of K2's "
        "bound)")
    return card


def phase_build():
    from so_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    path = _cuda.build()
    _cuda.library()
    log(f"[build] {path.name} in {time.perf_counter() - t0:.3f} s")


def gather_bound(reads, live, per_desc, B, K, chans, want_idx, n_in=None):
    """bound() of one K1/K3 call on this run's data. ``reads`` is
    gather_reads()': the 3 position rows of each distinct payload row a
    halo's runs put below K, read once however many halos' balls hold it;
    the rows the channels need of each distinct in-ball row, read once;
    ~23 f32 operations per (halo, candidate) pair (three min-image axes,
    the sum, the test: each halo does its own). Also the ``per_desc``
    int32 fields of each live descriptor (``live``, the per-halo counts,
    themselves read) read once, and every output slot written once. With
    ``n_in`` (the sorted form): the counts written too, and the
    compare-exchanges of each halo's bitonic network at its padded size n,
    n/2 x log2 n x (log2 n + 1)/2, as operations."""
    import torch

    from so_tpu_torch.ops.slab_gather import CHANNEL_ROWS

    cand, rows_read, hit_rows = reads
    rows = len({CHANNEL_ROWS[c] for c in chans}
               | ({3} if {"mvx", "mvy", "mvz"} & set(chans) else set()))
    nbytes = (4 * 3 * rows_read + 4 * rows * hit_rows
              + 4 * (per_desc * int(live.sum()) + live.numel())
              + 4 * B * K * (1 + len(chans) + int(want_idx)))
    ops = 23 * cand
    if n_in is not None:
        lg = torch.ceil(torch.log2(n_in.clamp(min=1).double()))
        ops += int((torch.exp2(lg) / 2 * lg * (lg + 1) / 2).sum())
        nbytes += 8 * B
    return bound(nbytes, ops)


def gather_reads(n_cols, chunk, st, cnt, q, K, idx):
    """(candidates, distinct rows, distinct in-ball rows) of one gather:
    (halo, row) pairs inside their runs at slots below K; the payload rows
    among them, each counted once (the union of the runs' reachable rows:
    row st + i of a run sits at slot q + st % chunk + i); and the distinct
    rows of ``idx``, the gather's source rows (-1 off-ball)."""
    import torch

    reach = torch.clamp(torch.minimum(cnt, K - q - st % chunk), min=0)
    live = reach > 0
    edge = torch.zeros(n_cols + 1, dtype=torch.int64, device=st.device)
    one = torch.ones_like(st[live])
    edge.scatter_add_(0, st[live], one)
    edge.scatter_add_(0, (st + reach)[live], -one)
    seen = torch.zeros(n_cols + 1, dtype=torch.bool, device=st.device)
    seen[idx.long().flatten() + 1] = True          # -1 lands on entry 0
    return (int(reach.sum()), int((torch.cumsum(edge, 0)[:-1] > 0).sum()),
            int(seen[1:].sum()))


def make_standard_box():
    import numpy as np

    t0 = time.perf_counter()
    pos, mass, vel, centers, rgtp = make_box(np.random.default_rng(SEED),
                                             1 << 21, 16384)
    log(f"[box] standard: {pos.shape[0]} particles, {centers.shape[0]} "
        f"halos, made in {time.perf_counter() - t0:.1f} s")
    return pos, mass, vel, centers, rgtp


FULL_CHANS = ("mass", "mvx", "mvy", "mvz", "meta")
# the sorted form's shapes beside (4096, 4096): (B, K, ladder rung)
SORTED_SHAPES = [(16384, 512, 1), (1024, 1 << 14, 6), (3, 8192, 6)]


def k1_case(g, level, S, c, r, K, chans, want_idx, slotted, tag):
    """One K1 shape on the card: the sorted form (and, with ``slotted``,
    the slotted one) bit for bit against its plain version, and timed: ms
    by CUDA events, device ms by graph replay, the bound; for the sorted
    form also the route it replaces. Returns the record of the [K1] line
    it logs."""
    import torch

    from so_tpu_torch.ops import slab_gather
    from so_tpu_torch.ops.gather import cell_ranges

    B, chunk = c.shape[0], g.chunk
    st, cnt, q, total = cell_ranges(g, level, c, r, r * r, S, align=chunk)
    desc = slab_gather.chunk_descriptors(st, cnt, q, K, chunk)
    args = (g.soa8t, *desc, c, g.period, r * r, K, chunk, chans, want_idx)
    reps = 20
    rec = dict(shape=f"B={B} K={K} {tag}", library_ms=None)
    line = f"[K1] B={B} K={K} level={level} S={S} {tag}:"
    err = 0.0
    reads = gather_reads(g.soa8t.shape[1], chunk, st, cnt, q, K,
                         slab_gather.slab_gather_rows(
                             g.soa8t, *desc, c, g.period, r * r, K, chunk,
                             (), True)[2])
    if slotted:
        got = slab_gather.slab_gather_rows(*args)
        want = slab_gather.slab_gather_plain(*args)
        torch.cuda.synchronize()
        for name, a, b in zip(("d2", "channels", "idx"), got, want):
            if a is not None:
                assert_same_bits(f"K1 {name}", a, b)
                err = max(err, max_abs_err(a, b))
        del got, want
        bms, by = gather_bound(reads, desc[3], 3, B, K, chans, want_idx)
        rec.update(
            ms=cuda_ms(lambda: slab_gather.slab_gather_rows(*args), reps),
            device_ms=graph_ms(lambda: slab_gather.slab_gather_rows(*args),
                               reps),
            plain_ms=cuda_ms(lambda: slab_gather.slab_gather_plain(*args), 3),
            bound_ms=bms, bound_by=by)
        line += (f" slotted exact, kernel {rec['ms']:.4f} ms (events) "
                 f"{rec['device_ms']:.4f} ms (graph) plain "
                 f"{rec['plain_ms']:.4f} ms bound {bms:.4f} ms ({by});")
    got = slab_gather.slab_gather_sorted_rows(*args)
    want = slab_gather.slab_gather_sorted_plain(*args)
    torch.cuda.synchronize()
    pairs = [("d2", got[0], want[0]), ("n_in", got[3], want[3])]
    pairs += [(f"channel {i}", a, b)
              for i, (a, b) in enumerate(zip(got[1], want[1]))]
    if want_idx:
        pairs.append(("idx", got[2], want[2]))
    if len(got[1]) != len(chans) or len(want[1]) != len(chans):
        raise AssertionError("K1 sorted: wrong channel count")
    for name, a, b in pairs:
        assert_same_bits(f"K1 sorted {name}", a, b)
        err = max(err, max_abs_err(a, b))
    n_in = got[3]
    ties = int(((got[0][:, 1:] == got[0][:, :-1])
                & torch.isfinite(got[0][:, 1:])).sum())
    del got, want, pairs

    def unfused():
        return slab_gather.sort_rows(*slab_gather.slab_gather_rows(*args))

    sbms, sby = gather_bound(reads, desc[3], 3, B, K, chans, want_idx,
                             n_in)
    rec.update(
        max_abs_err=err,
        sorted_ms=cuda_ms(
            lambda: slab_gather.slab_gather_sorted_rows(*args), reps),
        sorted_device_ms=graph_ms(
            lambda: slab_gather.slab_gather_sorted_rows(*args), reps),
        unfused_ms=cuda_ms(unfused, reps),
        unfused_device_ms=graph_ms(unfused, reps),
        sorted_bound_ms=sbms, sorted_bound_by=sby)
    log(f"{line} sorted exact (d2, channels, idx, n_in; {ties} equal-d2 "
        f"neighbours), max_abs_err {err}, kernel {rec['sorted_ms']:.4f} ms "
        f"(events) {rec['sorted_device_ms']:.4f} ms (graph) bound "
        f"{sbms:.4f} ms ({sby}); unfused route {rec['unfused_ms']:.4f} ms "
        f"(events) {rec['unfused_device_ms']:.4f} ms (graph); in-ball "
        f"{int(n_in.sum())} of {reads[0]} "
        f"candidates, largest n_in {int(n_in.max())}, "
        f"{int((total > K).sum())} rows past K")
    if slotted and ties == 0 and B == 4096:
        raise AssertionError("K1 sorted: the shape holds no equal d2")
    return rec


def phase_kernels(box):
    """K1's two forms against their plain versions at main-path shapes."""
    import dataclasses

    import numpy as np
    import torch

    from so_tpu_torch.engine.solver import ladder_radius, _pick_level_span
    from so_tpu_torch.ops.grid import build_grid

    dev = torch.device("cuda")
    pos, mass, vel, centers, rgtp = box
    pos = pos.copy()
    pos[:48] = centers[0]       # equal d2 (and +0.0) in the first halo
    grid = build_grid(pos, mass, vel=vel, device=dev)

    def balls(B, rung):
        radii = ladder_radius(rgtp[:B], np.full(B, rung, np.int32))
        return (torch.as_tensor(centers[:B], device=dev),
                torch.as_tensor(radii, device=dev),
                *_pick_level_span(grid, float(radii.max())))

    rows = {}
    c, r, level, S = balls(min(4096, centers.shape[0]), 1)   # first rung
    for chunk in (256, 128):
        g = grid if chunk == grid.chunk else dataclasses.replace(
            grid, chunk=chunk, soa8t=grid.soa8t[:, :grid.n + chunk]
            .contiguous())
        for chans, want_idx in (((), False), (("mass",), False),
                                (("mass", "meta"), True), (FULL_CHANS, True)):
            tag = f"chunk={chunk} nch={len(chans)} idx={int(want_idx)}"
            rows[(chunk, len(chans))] = k1_case(
                g, level, S, c, r, 4096, chans, want_idx, True, tag)
    for B, K, rung in SORTED_SHAPES:
        c, r, level, S = balls(B, rung)
        for chans, want_idx in (((), False), (("mass",), False),
                                (("mass", "meta"), True),
                                (("mass", "meta", "mvx"), True)):
            tag = (f"chunk={grid.chunk} nch={len(chans)} "
                   f"idx={int(want_idx)}")
            k1_case(grid, level, S, c, r, K, chans, want_idx, B == 3, tag)
    k1 = rows[(256, 1)]       # the general-mass solve stage's shape
    del grid
    torch.cuda.empty_cache()
    return k1



def ranges_equal(tag, got, want, kernel):
    """slab_ranges' output against its plain version's where the plain
    version defines it: (cnt, q, total) everywhere, st where cnt > 0, the
    descriptor counts, and the descriptors below each halo's n_total (K1)
    or n_pieces (K3). Raises on the first difference; returns the number
    of descriptors compared."""
    import torch

    (st, cnt, q, tot), desc = got
    (pst, pcnt, pq, ptot), pdesc = want
    pairs = [("cnt", cnt, pcnt), ("q", q, pq), ("total", tot, ptot),
             ("st where cnt > 0", st[pcnt > 0], pst[pcnt > 0])]
    F = 5 if kernel == "K3" else 3
    pairs += [(f"descriptor count {i}", a, b)
              for i, (a, b) in enumerate(zip(desc[F:], pdesc[F:]))]
    below = (torch.arange(desc[0].shape[1], device=st.device)[None, :]
             < pdesc[F][:, None])
    pairs += [(f"descriptor {i}", a[below], b[below])
              for i, (a, b) in enumerate(zip(desc[:F], pdesc[:F]))]
    for name, a, b in pairs:
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"{tag}: {name} differs from the plain "
                                 f"version")
    return int(pdesc[F].sum())


def ranges_bytes(grid, level, c, r, S, kernel, n_desc):
    """The bytes one slab_ranges launch must move: the balls (centers,
    radii, r2_mask) read once, two starts entries for each cell that
    passes the span and distance tests (the cells whose slab it looks up),
    st, cnt, q and total written whole, the descriptors below n_total or
    n_pieces and the descriptor counts. The cells that pass are counted by
    the plain enumeration over a starts array of one row a cell."""
    import dataclasses

    import torch

    from so_tpu_torch.ops.ranges import cell_ranges_plain

    B, C = c.shape[0], S ** 3
    starts = list(grid.starts)
    starts[level] = torch.arange(grid.ncell(level) ** 3 + 1,
                                 dtype=torch.int64, device=c.device)
    one_row = dataclasses.replace(grid, starts=tuple(starts))
    passed = int((cell_ranges_plain(one_row, level, c, r, r * r, S)[1]
                  > 0).sum())
    F, nd = (5, 2) if kernel == "K3" else (3, 1)
    return 20 * B + 16 * passed + 24 * B * C + 8 * B + 4 * F * n_desc \
        + 4 * nd * B


def ranges_case(grid, level, S, c, r, K, tag):
    """One shape of the cell enumeration on the card: slab_ranges (the
    kernel, one launch) against slab_ranges_plain on the same tensors,
    and timed: ms by CUDA events, device ms by graph replay, the plain
    route's ms and the bytes bound. Returns the record of the [ranges]
    line it logs."""
    import torch

    from so_tpu_torch.ops import ranges
    from so_tpu_torch.ops.gather import PIECE_K_MIN

    kernel = "K3" if K > PIECE_K_MIN else "K1"
    B = c.shape[0]
    args = (grid, level, c, r, r * r, S, grid.chunk, K, kernel)
    n0 = ranges.launches
    got = ranges.slab_ranges(*args)
    want = ranges.slab_ranges_plain(*args)
    torch.cuda.synchronize()
    if ranges.launches != n0 + 1:
        raise AssertionError(f"{tag}: slab_ranges made "
                             f"{ranges.launches - n0} launches, not one")
    n_desc = ranges_equal(tag, got, want, kernel)
    del got, want
    nbytes = ranges_bytes(grid, level, c, r, S, kernel, n_desc)
    bms, by = bound(nbytes, 0)
    rec = dict(
        shape=f"B={B} S={S} K={K} {kernel}", library_ms=None,
        descriptors=n_desc, bytes=nbytes,
        ms=cuda_ms(lambda: ranges.slab_ranges(*args), 50),
        device_ms=graph_ms(lambda: ranges.slab_ranges(*args), 50),
        plain_ms=cuda_ms(lambda: ranges.slab_ranges_plain(*args), 10),
        bound_ms=bms, bound_by=by)
    log(f"[ranges] {tag} B={B} level={level} S={S} K={K} {kernel} chunk "
        f"{grid.chunk}: equal to the plain version; kernel "
        f"{rec['ms']:.4f} ms (events) {rec['device_ms']:.4f} ms (graph), "
        f"plain {rec['plain_ms']:.4f} ms; {n_desc} descriptors, {nbytes} "
        f"bytes: bound {bms:.5f} ms ({by})")
    return rec


def ranges_shapes(box, grid, seed=None):
    """The cell enumeration's two shapes on a make_box box's grid, as
    (tag, level, S, centers, radii, K): every halo of the first 16,384 at
    the first ladder rung, K = 4096 (the solve's first dispatch: K1's
    sorted form), and the 8 largest halos with radii uniform(0.08, 0.2)
    at level 1, S = 7, K = 2^21 (K3's giant tier)."""
    import numpy as np
    import torch

    from so_tpu_torch.engine.solver import _pick_level_span, ladder_radius

    _, _, _, centers, rgtp = box
    rng = np.random.default_rng(SEED if seed is None else seed)
    B = min(16384, centers.shape[0])
    radii = ladder_radius(rgtp[:B], np.full(B, 1, np.int32))
    level, S = _pick_level_span(grid, float(radii.max()))
    big = np.argsort(rgtp, kind="stable")[::-1][:8]
    dev = grid.device
    return [("first rung", level, S, torch.as_tensor(centers[:B], device=dev),
             torch.as_tensor(radii, device=dev), 4096),
            ("giant tier", 1, 7, torch.as_tensor(centers[big], device=dev),
             torch.as_tensor(rng.uniform(0.08, 0.2, 8).astype(np.float32),
                             device=dev), 1 << 21)]


def phase_ranges(box):
    """The cell enumeration (ops/ranges.slab_ranges, csrc/cell_ranges.cu)
    against its plain version on the standard box at ranges_shapes'
    shapes. Returns the first rung's record with the giant tier's under
    "giant_rows"."""
    import torch

    from so_tpu_torch.ops.grid import build_grid

    pos, mass, vel, _, _ = box
    grid = build_grid(pos, mass, vel=vel, device=torch.device("cuda"))
    recs = [ranges_case(grid, level, S, c, r, K, tag)
            for tag, level, S, c, r, K in ranges_shapes(box, grid)]
    del grid
    torch.cuda.empty_cache()
    return dict(recs[0], giant_rows=recs[1])

# K2's dispatch ladder: the solve's capacity tiers (B*K = 2^26), the fused
# pass's (2^25) at K = 2^12 and 2^22, the survey classify prefix and an
# odd shape (K % 4 != 0, B not a multiple of 32)
K2_LADDER = [(16384, 1 << 12), (4096, 1 << 14), (1024, 1 << 16),
             (256, 1 << 18), (64, 1 << 20), (16, 1 << 22), (8, 1 << 23),
             (8192, 1 << 12), (8, 1 << 22), (16384, 16), (1000, 4097)]


def phase_k2():
    """K2 over its dispatch ladder (K2_LADDER): bit for bit against its
    plain version (on the CPU for K >= 2^14), with and without a random
    n_valid; kernel ms by CUDA events around the calls, and device ms by
    one CUDA graph of the calls replayed (with n_valid too); the bytes and
    chain bounds. Returns K2's kernel-line figures at (16384, 4096), with
    the giant row's (8, 2^23) beside them."""
    import torch

    from so_tpu_torch.ops import seqsum

    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    rows_out = {}
    for i, (B, K) in enumerate(K2_LADDER):
        gen = torch.Generator(device=dev).manual_seed(SEED + 10 + i)
        x = torch.rand((B, K), generator=gen, device=dev)
        nv = torch.randint(0, K + 1, (B,), generator=gen, device=dev)
        on_cpu = K >= 1 << 14
        err, t0 = 0.0, time.perf_counter()
        for tag, n_valid in (("", None), (" n_valid", nv)):
            got = seqsum.seq_cumsum(x, n_valid=n_valid)
            if on_cpu:
                want = seqsum.seq_cumsum_plain(
                    x.cpu(), None if n_valid is None else n_valid.cpu())
                got = got.cpu()
            else:
                want = seqsum.seq_cumsum_plain(x, n_valid)
            torch.cuda.synchronize()
            assert_same_bits(f"K2 ({B}, {K}){tag}", got, want)
            err = max(err, max_abs_err(got, want))
            del got, want
        check_s = time.perf_counter() - t0
        reps = 20 if K <= 1 << 16 else 4
        ms = cuda_ms(lambda: seqsum.seq_cumsum(x), reps)
        dev_ms = graph_ms(lambda: seqsum.seq_cumsum(x), reps)
        dev_ms_nv = graph_ms(lambda: seqsum.seq_cumsum(x, n_valid=nv), reps)
        bms, by = k2_bound(B, K)
        bms_nv, by_nv = k2_bound(B, K, nv)
        rows = seqsum.rows_per_block(B, K, n_sm)
        line = (f"[K2] ({B}, {K}) rows/block {rows}: exact with and without"
                f" n_valid ({'CPU' if on_cpu else 'card'} plain, "
                f"{check_s:.1f} s), max_abs_err {err}; kernel {ms:.4f} ms "
                f"(events), device {dev_ms:.4f} ms (graph); bound "
                f"{bms:.4f} ms ({by}; bytes {bound(8 * B * K, 0)[0]:.4f}, "
                f"chain {bound(0, 0, K)[0]:.4f}) = {bms / dev_ms:.3f} of the "
                f"device time; random n_valid (mean "
                f"{float(nv.float().mean()) / K:.3f} K) device "
                f"{dev_ms_nv:.4f} ms bound {bms_nv:.4f} ms ({by_nv})")
        rec = dict(max_abs_err=err, ms=ms, device_ms=dev_ms, bound_ms=bms,
                   bound_by=by, device_ms_n_valid=dev_ms_nv,
                   shape=f"B={B} K={K}", rows=rows)
        if (B, K) in ((16384, 1 << 12), (16384, 16)):
            rec["plain_ms"] = cuda_ms(lambda: seqsum.seq_cumsum_plain(x), 1)
            lib_ms = cuda_ms(lambda: torch.cumsum(x, dim=1), reps)
            line += (f"; plain {rec['plain_ms']:.4f} ms; torch.cumsum (a "
                     f"parallel scan: other bits) {lib_ms:.4f} ms")
        log(line)
        rows_out[(B, K)] = rec
        del x, nv
        torch.cuda.empty_cache()
    k2 = dict(rows_out[(16384, 1 << 12)], library_ms=None)
    giant = rows_out[(8, 1 << 23)]
    k2["giant_rows"] = {k: giant[k] for k in (
        "shape", "ms", "device_ms", "bound_ms", "bound_by",
        "device_ms_n_valid")}
    return k2


K3_CHANNELS = (((), False), (("mass",), False), (("mass", "meta"), True))


def k3_shapes(grid, giant):
    """phase_k3's shapes on the giant box's grid, in order: per (K, B) the
    centers, radii, level, span and cell_ranges' (st, cnt, q, total). K=2^18
    at radii 0.002-0.013 about the clump's center overflows (340,000-563,000
    candidate slots: a first-rung dispatch); K=2^21 at 0.08-0.2 holds
    1.63-1.93 million (the clump and some background)."""
    import numpy as np
    import torch

    from so_tpu_torch.engine.solver import _pick_level_span
    from so_tpu_torch.ops.gather import cell_ranges

    rng = np.random.default_rng(GIANT_SEED + 1)
    for K, (r_lo, r_hi) in ((1 << 18, (0.002, 0.013)),
                            (1 << 21, (0.08, 0.2))):
        for B in (8, 64):
            c = torch.as_tensor((giant["centers"][0] + rng.normal(
                scale=0.003, size=(B, 3))).astype(np.float32),
                device=grid.device)
            r_np = rng.uniform(r_lo, r_hi, B).astype(np.float32)
            r = torch.as_tensor(r_np, device=grid.device)
            level, S = _pick_level_span(grid, float(r_np.max()))
            yield B, K, c, r, level, S, cell_ranges(grid, level, c, r, r * r,
                                                    S, align=grid.chunk)


def phase_k3(giant):
    """K3 against its plain version (tolerance 0) and against K1 (bit for
    bit) on the giant box, at giant-tier shapes (k3_shapes): B = 8 and 64
    halos about the clump, K = 2^18 and 2^21, d2 only, mass, mass + meta +
    idx. The payload's row stride is padded to 32 floats, as K3 reads it."""
    import torch

    from so_tpu_torch.ops import piece_gather, slab_gather
    from so_tpu_torch.ops.grid import build_grid

    dev = torch.device("cuda")
    grid = build_grid(giant["pos"], giant["masses"][0][1], device=dev)
    if grid.soa8t.shape[1] % 32:
        raise AssertionError("the payload's row stride is not padded")
    rows = {}
    for B, K, c, r, level, S, (st, cnt, q, total) in k3_shapes(grid, giant):
        pdesc = piece_gather.piece_descriptors(st, cnt, q, K, grid.chunk)
        cdesc = slab_gather.chunk_descriptors(st, cnt, q, K, grid.chunk)
        reads = gather_reads(grid.soa8t.shape[1], grid.chunk, st, cnt, q, K,
                             piece_gather.piece_gather_rows(
                                 grid.soa8t, *pdesc, c, grid.period, r * r,
                                 K, grid.chunk, (), True)[2])
        for chans, want_idx in K3_CHANNELS:
            tail = (c, grid.period, r * r, K, grid.chunk, chans, want_idx)
            a3 = (grid.soa8t, *pdesc, *tail)
            a1 = (grid.soa8t, *cdesc, *tail)
            got = piece_gather.piece_gather_rows(*a3)
            plain = piece_gather.piece_gather_plain(*a3)
            k1 = slab_gather.slab_gather_rows(*a1)
            torch.cuda.synchronize()
            err = 0.0
            for name, a, p, b in zip(("d2", "channels", "idx"), got, plain,
                                     k1):
                if a is None:
                    continue
                assert_same_bits(f"K3 {name}", a, p)
                assert_same_bits(f"K3 {name} against K1", a, b)
                err = max(err, max_abs_err(a, p))
            del got, plain, k1
            ms = cuda_ms(lambda: piece_gather.piece_gather_rows(*a3), 5)
            k1_ms = cuda_ms(lambda: slab_gather.slab_gather_rows(*a1), 5)
            dev_ms = graph_ms(lambda: piece_gather.piece_gather_rows(*a3), 5)
            k1_dev_ms = graph_ms(lambda: slab_gather.slab_gather_rows(*a1),
                                 5)
            plain_ms = cuda_ms(lambda: piece_gather.piece_gather_plain(*a3),
                               1)
            bms, by = gather_bound(reads, pdesc[5], 5, B, K, chans,
                                   want_idx)
            tag = f"B={B} K={K} nch={len(chans)} idx={int(want_idx)}"
            log(f"[K3] {tag} level={level} S={S}: equal to its plain "
                f"version and to K1, max_abs_err {err}; K3 {ms:.4f} ms "
                f"(events) {dev_ms:.4f} ms (graph), K1 {k1_ms:.4f} ms "
                f"(events) {k1_dev_ms:.4f} ms (graph), plain "
                f"{plain_ms:.4f} ms, bound {bms:.4f} ms ({by}) = "
                f"{bms / dev_ms:.3f} of K3's device time; reads "
                f"{reads[0]} candidates, {reads[1]} distinct rows, "
                f"{reads[2]} distinct in-ball; {int((total > K).sum())} of "
                f"{B} rows past K")
            rows[(B, K, len(chans))] = dict(
                max_abs_err=err, ms=ms, device_ms=dev_ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=None, k1_ms=k1_ms, k1_device_ms=k1_dev_ms,
                shape=tag)
            torch.cuda.empty_cache()
    del grid
    torch.cuda.empty_cache()
    return rows[(8, 1 << 21, 1)]    # a general-mass giant solve dispatch


def particles_and_catalog(box, species, seed):
    """(ParticleSet, catalog factory) for a make_box box: uniform masses,
    or masses from uniform(0.5, 1.5)/N split over gas/dark/star."""
    import numpy as np

    from so_tpu_torch.io.catalogs import GroupCatalog
    from so_tpu_torch.io.tipsy import ParticleSet, TipsyHeader

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
    phi = np.random.default_rng(SEED).uniform(-3.0, -0.1, n).astype(
        np.float32)                           # read only by -pot
    ps = ParticleSet(hdr, pos, vel, mass, phi, np.zeros(n, np.float32))
    G = centers.shape[0]

    def catalog():
        return GroupCatalog(index=np.arange(1, G + 1, dtype=np.int32),
                            pos=centers.copy(), rgtp=rgtp, gtp_mass=gtp_mass,
                            n_in_gtp=G, gtp_time=1.0)
    return ps, catalog


def run(ps, catalog, species, device, grid=None, **kw):
    from so_tpu_torch.engine.pipeline import SOParams, run_so

    kw = dict(dict(threshold=THR, species=species, device=device), **kw)
    t0 = time.perf_counter()
    out = run_so(ps, catalog(), SOParams(**kw), grid=grid)
    return out, time.perf_counter() - t0


def zero_counts():
    from so_tpu_torch.ops import piece_gather, ranges, seqsum, slab_gather

    slab_gather.launches = seqsum.launches = piece_gather.launches = 0
    ranges.launches = 0
    slab_gather.sorted_launches = 0
    seqsum.shape_launches.clear()
    piece_gather.shape_launches.clear()


def read_counts():
    from so_tpu_torch.ops import piece_gather, ranges, seqsum, slab_gather

    return dict(K1=slab_gather.launches, K1s=slab_gather.sorted_launches,
                K2=seqsum.launches, K3=piece_gather.launches,
                ranges=ranges.launches)


def gather_need(need):
    """``need`` and, where it holds a gather kernel (K1, K1s or K3), the
    cell enumeration's: every gather on the card enumerates its cells
    first."""
    need = tuple(need)
    return need + (("ranges",) if {"K1", "K1s", "K3"} & set(need) else ())


def read_k2_shapes(tag):
    """Log K2's launches per (B, K) since the last zero_counts() and add
    them to K2_SHAPES."""
    from so_tpu_torch.ops import seqsum

    hist = dict(sorted(seqsum.shape_launches.items()))
    log(f"[{tag}] K2 launches per (B, K): "
        + (", ".join(f"({b}, {k}): {n}" for (b, k), n in hist.items())
           or "none"))
    for key, n in hist.items():
        K2_SHAPES[key] = K2_SHAPES.get(key, 0) + n


def counted(tag, fn, *a, need=("K1", "K1s", "K2"), **kw):
    """Run one path with every kernel's launch counter zeroed just before;
    fail unless the path's kernels (gather_need(``need``)) grew; add the
    counts to LAUNCHES."""
    zero_counts()
    out = fn(*a, **kw)
    counts = read_counts()
    log(f"[{tag}] launches: {counts}")
    read_k2_shapes(tag)
    if any(counts[k] <= 0 for k in gather_need(need)):
        raise AssertionError(f"{tag}: a kernel of the path never ran: "
                             f"{counts}")
    for k, v in counts.items():
        LAUNCHES[k] += v
    return out


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
    from so_tpu_torch.io.tipsy import DARK, GAS, STAR

    runs = [("uniform", (), SEED), ("species", (DARK, GAS, STAR), SEED)]
    inputs = [(tag, sp, *particles_and_catalog(box, sp, seed))
              for tag, sp, seed in runs]
    zero_counts()
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
            else:
                cat = catalog()
                AT_SCALE[f"standard_{tag}"] = dict(
                    rec=run_record(out), ps=ps, centers=cat.pos,
                    sha=inputs_sha256(ps, cat))
        med = {k: statistics.median(w[k] for w in warm) for k in warm[0]}
        e2es = [w["e2e"] for w in warm]
        log(f"[main {tag} median of {len(warm)} warm] e2e {med['e2e']:.4f} s "
            f"(range {min(e2es):.4f}-{max(e2es):.4f}; {n / med['e2e']:.0f} "
            f"halos/s) solve {med['R_Delta solve']:.4f} s "
            f"({n / med['R_Delta solve']:.0f} solves/s) phases "
            + ", ".join(f"{k} {v:.4f}" for k, v in med.items()
                        if k not in ("e2e", "R_Delta solve")))
    counts = read_counts()
    log(f"[main] launches in the main-path runs: {counts}")
    read_k2_shapes("main")
    if min(counts["K1"], counts["K1s"], counts["K2"], counts["ranges"]) <= 0:
        raise AssertionError(f"a kernel of the main path never ran: {counts}")
    return counts


def assert_runs_equal(tag, g, c, sp, members=True):
    """Every field of two SORuns bit for bit (the member lists too, unless
    ``members`` is False); returns the compared pairs."""
    import numpy as np

    pairs = [(f"solve.{f}", getattr(g.solve, f), getattr(c.solve, f))
             for f in ("code", "mvir", "rvir", "j", "d2cut", "vcm")]
    pairs += [(f"conflicts.{f}", getattr(g.conflicts, f),
               getattr(c.conflicts, f))
              for f in ("igrp", "n_subsumed", "n_ignored", "mvir", "rvir")]
    pairs += [(f"derived.{f}", getattr(g.derived, f), getattr(c.derived, f))
              for f in ("vcirc", "rmass", "rmax", "vmax")]
    pairs += [(f"profile {s}", g.derived.profiles[s],
               c.derived.profiles[s]) for s in sp]
    pairs += [("catalog.pos", np.asarray(g.catalog.pos, np.float32),
               np.asarray(c.catalog.pos, np.float32))]
    for name, a, b in pairs:
        if a.dtype != b.dtype or a.tobytes() != b.tobytes():
            raise AssertionError(f"{tag}: {name} differs")
    for h, (ma, mb) in enumerate(zip(g.members, c.members)):
        if members and ((ma is None) != (mb is None) or (
                ma is not None and not np.array_equal(ma, mb))):
            raise AssertionError(f"{tag}: members of halo {h} differ")
    return pairs


def phase_gpu_vs_cpu(small):
    import numpy as np

    from so_tpu_torch.io.tipsy import DARK, GAS, STAR

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from reference_oracle import oracle_rvir

    for tag, sp in (("uniform", ()), ("species", (DARK, GAS, STAR))):
        ps, catalog = particles_and_catalog(small, sp, SEED + 7)
        g, tg = run(ps, catalog, sp, "cuda")
        c, tc = run(ps, catalog, sp, "cpu")
        pairs = assert_runs_equal(tag, g, c, sp)
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

    from so_tpu_torch.io.tipsy import (DARK_DTYPE, GAS_DTYPE, STAR_DTYPE,
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


def phase_pot(box, small):
    """-pot on the standard box (cold + warm runs), then CUDA vs CPU."""
    from so_tpu_torch.io.tipsy import DARK, GAS, STAR

    sp = (DARK, GAS, STAR)
    ps, catalog = particles_and_catalog(box, sp, SEED)
    warm = []
    for rep in ["cold"] + [f"warm {i + 1}" for i in range(POT_WARM_RUNS)]:
        out, e2e = run(ps, catalog, sp, "cuda", b_pot=True)
        codes = check_run(f"pot {rep}", out, out.catalog.n)
        moved = int((out.catalog.pos != catalog().pos).any(axis=1).sum())
        if moved == 0:
            raise AssertionError("-pot moved no center")
        rec = out.phases["recenter (-pot)"]
        log(f"[pot {rep}] halos={out.catalog.n} centers moved={moved} "
            f"ok/-1/-2/-3={codes} recenter {rec:.4f} s solve "
            f"{out.phases['R_Delta solve']:.4f} s e2e {e2e:.4f} s")
        if rep != "cold":
            warm.append((rec, e2e))
    log(f"[pot median of {len(warm)} warm] recenter "
        f"{statistics.median(w[0] for w in warm):.4f} s (range "
        f"{min(w[0] for w in warm):.4f}-{max(w[0] for w in warm):.4f}) e2e "
        f"{statistics.median(w[1] for w in warm):.4f} s")

    ps, catalog = particles_and_catalog(small, sp, SEED + 7)
    g, tg = run(ps, catalog, sp, "cuda", b_pot=True)
    c, tc = run(ps, catalog, sp, "cpu", b_pot=True)
    pairs = assert_runs_equal("pot gpu-vs-cpu", g, c, sp)
    log(f"[pot gpu-vs-cpu] particles={ps.n} halos={g.catalog.n}: "
        f"{len(pairs)} fields (centers included) and all member lists "
        f"bit-identical; cuda {tg:.3f} s, cpu {tc:.3f} s")


def phase_multi(box):
    """run_so_multi at DELTAS against run_so per threshold, one grid."""
    import numpy as np

    from so_tpu_torch.io.tipsy import DARK, GAS, STAR
    from so_tpu_torch.engine.pipeline import SOParams, run_so_multi
    from so_tpu_torch.ops.grid import build_grid

    sp = (DARK, GAS, STAR)
    ps, catalog = particles_and_catalog(box, sp, SEED)
    grid = build_grid(ps.pos, ps.mass, vel=ps.vel, ptype=ps.ptype_all(),
                      mark=ps.mark, device="cuda")
    params = SOParams(species=sp, device="cuda")

    def multi():
        t0 = time.perf_counter()
        runs = run_so_multi(ps, catalog(), params, DELTAS, grid=grid)
        return runs, time.perf_counter() - t0

    runs, e2e = multi()
    log(f"[multi cold] T={len(DELTAS)} solve (multi) "
        f"{runs[0].phases['R_Delta solve (multi)']:.4f} s e2e {e2e:.4f} s")
    rounds = []
    for rep in range(MULTI_ROUNDS):       # multi, then the singles, in turns
        runs, e2e_multi = multi()
        t_single, e2e_single = [], []
        for thr, m in zip(DELTAS, runs):
            s, e2e = run(ps, catalog, sp, "cuda", grid=grid, threshold=thr)
            t_single.append(s.phases["R_Delta solve"])
            e2e_single.append(e2e)
            if rep:
                continue
            for f in ("code", "mvir", "rvir", "j"):
                if getattr(m.solve, f).tobytes() != \
                        getattr(s.solve, f).tobytes():
                    raise AssertionError(f"multi Delta={thr}: solve.{f} "
                                         "differs from run_so")
            if m.conflicts.igrp.tobytes() != s.conflicts.igrp.tobytes():
                raise AssertionError(f"multi Delta={thr}: igrp differs")
            for h, (a, b) in enumerate(zip(m.members, s.members)):
                if (a is None) != (b is None) or (
                        a is not None and not np.array_equal(a, b)):
                    raise AssertionError(f"multi Delta={thr}: members of "
                                         f"halo {h} differ")
            log(f"[multi Delta={thr:g}] ok/-1/-2/-3="
                f"{check_run('multi', m, m.catalog.n)} equal to run_so "
                "(code, Mvir, Rvir, j, members, igrp)")
        rounds.append((runs[0].phases["R_Delta solve (multi)"],
                       sum(t_single), e2e_multi, sum(e2e_single)))
        log(f"[multi round {rep + 1}] solve (multi) {rounds[-1][0]:.4f} s, "
            f"single solves {' + '.join(f'{t:.4f}' for t in t_single)} = "
            f"{rounds[-1][1]:.4f} s; e2e multi {e2e_multi:.4f} s, singles "
            f"{rounds[-1][3]:.4f} s")
    med = [statistics.median(r[i] for r in rounds) for i in range(4)]
    log(f"[multi median of {MULTI_ROUNDS}] T={len(DELTAS)} solve (multi) "
        f"{med[0]:.4f} s vs sum of single solves {med[1]:.4f} s (ratio "
        f"{med[0] / med[1]:.3f}); e2e multi {med[2]:.4f} s vs singles "
        f"{med[3]:.4f} s")


def make_dense_box():
    """bench.py's dense box, with three-species masses beside its own."""
    import numpy as np

    t0 = time.perf_counter()
    pos, mass, _, centers, rgtp = make_box(np.random.default_rng(SEED),
                                           1 << 23, 65536)
    log(f"[box] dense: {pos.shape[0]} particles, {centers.shape[0]} halos, "
        f"made in {time.perf_counter() - t0:.1f} s")
    species_mass = (np.random.default_rng(SEED + 1).uniform(
        0.5, 1.5, pos.shape[0]) / pos.shape[0]).astype(np.float32)
    return pos, (("uniform", mass), ("species", species_mass)), centers, rgtp


def phase_survey(dense):
    """solve_rvir on the dense box with the pre-pass forced, auto, off."""
    import numpy as np

    from so_tpu_torch.engine.solver import solve_rvir
    from so_tpu_torch.ops.grid import build_grid

    pos, masses, centers, rgtp = dense
    for tag, m in masses:
        grid = build_grid(pos, m, device="cuda")
        res, times = {}, {}
        for rep in range(1 + SURVEY_ROUNDS):    # a warm-up round first
            for mode, sv in (("off", False), ("forced", True),
                             ("auto", None)):
                t0 = time.perf_counter()
                res[mode] = solve_rvir(grid, centers, rgtp, THR, survey=sv)
                if rep:
                    times.setdefault(mode, []).append(
                        time.perf_counter() - t0)
        off = res["off"]
        for mode, r in res.items():
            for f in ("code", "mvir", "rvir", "j", "d2cut"):
                if getattr(r, f).tobytes() != getattr(off, f).tobytes():
                    raise AssertionError(f"survey {tag} {mode}: {f} differs "
                                         "from the solve without the pass")
            dt = statistics.median(times[mode])
            log(f"[survey {tag} {mode}] solve median {dt:.4f} s (range "
                f"{min(times[mode]):.4f}-{max(times[mode]):.4f}; "
                f"{centers.shape[0] / dt:.0f} solves/s), classifier "
                f"resolved {r.n_survey} halos")
        if res["forced"].n_survey == 0:
            raise AssertionError(f"survey {tag}: the forced pass resolved "
                                 "no halo")
        code = off.code
        log(f"[survey {tag}] ok/-1/-2/-3="
            f"{np.bincount(-code[code <= 0], minlength=4).tolist()}; "
            "forced, auto and off identical")
        del grid


def phase_survey_vs_cpu(dense):
    """The survey classifier (_classify_stage: unsorted K1, then counts or
    the topk prefix and K2) on the card against the CPU, bit for bit."""
    import numpy as np
    import torch

    from so_tpu_torch.engine import solver
    from so_tpu_torch.ops.grid import build_grid

    pos, masses, centers, rgtp = dense
    sel = np.arange(0, centers.shape[0], 16)
    radii = solver.ladder_radius(rgtp[sel], np.ones(sel.size, np.int32))
    thresholds = np.float32((THR,) + DELTAS)
    for tag, m in masses:
        packed = {}
        for dev in ("cuda", "cpu"):
            grid = build_grid(pos, m, device=dev)
            level, S = solver._pick_level_span(grid, float(radii.max()))
            K = int(min(4096, solver._k_limit(grid)))
            packed[dev] = solver._classify_stage(
                grid, level, K, S, 8,
                torch.as_tensor(centers[sel], device=dev),
                torch.as_tensor(radii, device=dev), thresholds)
            del grid
        if packed["cuda"].tobytes() != packed["cpu"].tobytes():
            raise AssertionError(f"survey classify {tag}: card and CPU "
                                 "verdicts differ")
        m2 = [int(((packed["cuda"][:, 1] >> t) & 1).sum())
              for t in range(thresholds.size)]
        if sum(m2) == 0:
            raise AssertionError(f"survey classify {tag}: no -2 verdict "
                                 "to compare")
        log(f"[survey classify {tag}] {sel.size} halos, K={K}: packed "
            f"verdicts bit-identical on cuda and cpu; -2 calls per Delta "
            f"{dict(zip((f'{t:g}' for t in thresholds), m2))}")


def phase_cli_paths(small):
    """The CLI's new options, in process, on the 2^18 box with general
    masses and phi."""
    import numpy as np

    from so_tpu_torch.io.tipsy import (DARK_DTYPE, GAS_DTYPE, STAR_DTYPE,
                                       TipsyHeader, write_tipsy)
    from so_tpu_torch.cli import main as cli_main
    from so_tpu_torch.profiling import TRACE_FILE

    pos, mass, vel, centers, rgtp = small
    out = os.path.join(HERE, "so_tpu_torch", "_build", "chip_smoke_paths")
    os.makedirs(out, exist_ok=True)
    n = pos.shape[0]
    rng = np.random.default_rng(SEED + 3)
    mass = (rng.uniform(0.5, 1.5, n) / n).astype(np.float32)
    phi = rng.uniform(-3.0, -0.1, n).astype(np.float32)
    ngas, nstar = n // 5, n // 7
    ndark = n - ngas - nstar
    recs = []
    for dt, sl in ((GAS_DTYPE, slice(0, ngas)),
                   (DARK_DTYPE, slice(ngas, ngas + ndark)),
                   (STAR_DTYPE, slice(ngas + ndark, n))):
        r = np.zeros(sl.stop - sl.start, dtype=dt[False])
        r["mass"], r["pos"], r["vel"] = mass[sl], pos[sl], vel[sl]
        r["phi"] = phi[sl]
        recs.append(r)
    write_tipsy(f"{out}/snap.bin", TipsyHeader(time=1.0, nbodies=n, ndim=3,
                                               nsph=ngas, ndark=ndark,
                                               nstar=nstar), *recs, False)
    G = centers.shape[0]
    gtp = np.zeros(G, dtype=STAR_DTYPE[False])
    gtp["mass"] = rng.uniform(0.001, 1.0, G)
    gtp["pos"], gtp["eps"] = centers, rgtp
    gtp["tform"] = np.arange(1, G + 1)
    write_tipsy(f"{out}/cat.gtp", TipsyHeader(time=1.0, nbodies=G, ndim=3,
                                              nsph=0, ndark=0, nstar=G),
                None, None, gtp, False)
    base = ["-i", f"{out}/cat.gtp", "--tipsy", f"{out}/snap.bin", "-grp",
            "-gtp", "-all", "--device", "cuda"]

    def cli(tag, *args):
        t0 = time.perf_counter()
        if cli_main(base + list(args)) != 0:
            raise RuntimeError(f"CLI {tag} failed")
        log(f"[cli {tag}] {time.perf_counter() - t0:.2f} s")

    def found(path):
        rows = [ln.split() for ln in open(path)
                if ln.strip() and not ln.startswith("#")]
        k = sum(1 for t in rows if float(t[1]) > 0)
        if len(rows) != G or k == 0:
            raise AssertionError(f"{path}: {k} groups found of {len(rows)}")
        return k

    def body(path):
        with open(path, "rb") as fp:
            return fp.read()

    cli("-pot", "-o", f"{out}/pot", "-pot")
    log(f"[cli -pot] {found(f'{out}/pot.sovcirc')} of {G} groups found")
    cli("--deltas", "-o", f"{out}/multi", "--deltas",
        ",".join(f"{d:g}" for d in DELTAS))
    for d in DELTAS:
        log(f"[cli --deltas] Delta={d:g}: "
            f"{found(f'{out}/multi.d{d:g}.sovcirc')} groups found")
    ck = f"{out}/state.npz"
    if os.path.exists(ck):
        os.remove(ck)
    cli("--checkpoint save", "-o", f"{out}/ck1", "--checkpoint", ck)
    cli("--checkpoint resume", "-o", f"{out}/ck2", "--checkpoint", ck)
    for ext in ("sogrp", "sogtp"):
        if body(f"{out}/ck1.{ext}") != body(f"{out}/ck2.{ext}"):
            raise AssertionError(f"resumed .{ext} differs")
    # catalog and profile files differ only in their headers' run time
    for ext in ("sovcirc", "sogas", "sodark", "sostar"):
        rows = [[ln for ln in open(f"{out}/ck{i}.{ext}")
                 if not ln.startswith("#")] for i in (1, 2)]
        if rows[0] != rows[1] or not rows[0]:
            raise AssertionError(f"resumed .{ext} rows differ")
    log(f"[cli --checkpoint] the resumed run's outputs are byte-identical "
        f"but for the headers' run time ({found(f'{out}/ck2.sovcirc')} "
        "groups)")
    trace = f"{out}/trace"
    cli("--profile", "-o", f"{out}/prof", "--profile", trace)
    with open(os.path.join(trace, TRACE_FILE)) as fp:
        events = json.load(fp)["traceEvents"]
    kern = [e for e in events if e.get("cat") == "kernel"]
    ours = sorted({e["name"] for e in kern if "_kernel" in e["name"]
                   and ("slab_gather" in e["name"] or "seqsum" in e["name"])})
    log(f"[cli --profile] {os.path.getsize(os.path.join(trace, TRACE_FILE))}"
        f" bytes, {len(events)} events, {len(kern)} device kernel events, "
        f"{sum(e.get('dur', 0) for e in kern) / 1e3:.3f} ms of kernel time; "
        f"K1/K2 seen: {ours}")
    if not events:
        raise AssertionError("--profile wrote an empty trace")


def giant_inputs(giant, mass):
    """(ParticleSet, catalog factory) of the giant box: dark matter only,
    as scripts/compare_reference_giant.py writes its snapshot."""
    import numpy as np

    from so_tpu_torch.io.catalogs import GroupCatalog
    from so_tpu_torch.io.tipsy import ParticleSet, TipsyHeader

    pos, n, G = giant["pos"], giant["pos"].shape[0], giant["centers"].shape[0]
    zeros = np.zeros(n, np.float32)
    ps = ParticleSet(TipsyHeader(time=1.0, nbodies=n, ndim=3, nsph=0,
                                 ndark=n, nstar=0), pos,
                     np.zeros((n, 3), np.float32), mass, zeros, zeros)

    def catalog():
        return GroupCatalog(index=np.arange(1, G + 1, dtype=np.int32),
                            pos=giant["centers"].copy(), rgtp=giant["rgtp"],
                            gtp_mass=giant["cat_mass"], n_in_gtp=G,
                            gtp_time=1.0)
    return ps, catalog


def phase_giant(giant):
    """run_so on the giant box on "cuda", general then uniform masses, each
    with every launch counter zeroed first: K1 (its sorted form too) and K3
    must run in both, K2 in the general one; the 4 giant halos against the brute-force oracle
    (tests/reference_oracle.py)."""
    import numpy as np
    import torch

    from so_tpu_torch.ops import piece_gather

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from reference_oracle import oracle_rvir

    for tag, mass in giant["masses"]:
        ps, catalog = giant_inputs(giant, mass)
        torch.cuda.reset_peak_memory_stats()
        need = ("K1", "K1s", "K3") + (("K2",) if tag == "general" else ())
        out, e2e = counted(f"giant {tag}", run, ps, catalog, (), "cuda",
                           need=need)
        codes = check_run(f"giant {tag}", out, catalog().n)
        k3 = dict(sorted(piece_gather.shape_launches.items()))
        log(f"[giant {tag}] K3 launches per (B, K): " + ", ".join(
            f"({b}, 2^{k.bit_length() - 1}): {n}" for (b, k), n in k3.items()))
        if tag == "general" and max(k for _, k in k3) < 1 << 21:
            raise AssertionError("giant general: no K3 dispatch of 2^21 "
                                 "slots or more")
        cat = catalog()
        AT_SCALE[f"giant_{tag}"] = dict(rec=run_record(out), ps=ps,
                                        centers=cat.pos,
                                        sha=inputs_sha256(ps, cat))
        for h in range(4):
            want = oracle_rvir(ps.pos, mass, giant["centers"][h],
                               giant["rgtp"][h], (1.0, 1.0, 1.0), THR, 8)
            got = [out.solve.code[h], out.solve.mvir[h], out.solve.rvir[h]]
            if got[0] != want["code"] or any(
                    abs(g - want[f]) > 2e-5 * abs(want[f])
                    for g, f in zip(got[1:], ("mvir", "rvir"))):
                raise AssertionError(f"giant {tag}: halo {h} {got} "
                                     f"disagrees with the oracle {want}")
        ph = out.phases
        log(f"[giant {tag}] particles={ps.n} halos={catalog().n} "
            f"ok/-1/-2/-3={codes}; 4 giant halos = oracle (code, Mvir, "
            f"Rvir to 2e-5): j={out.solve.j[:4].tolist()}; largest solve "
            f"K={int(out.solve.kcap.max())}; grid {ph['grid build']:.3f} s "
            f"solve {ph['R_Delta solve']:.3f} s members + derived "
            f"{ph['members + derived (fused)']:.3f} s conflicts "
            f"{ph['conflict protocol']:.3f} s e2e {e2e:.3f} s; peak device "
            f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if tag == "general":
            giant_without_counts(ps, catalog, out)
        del out


def giant_without_counts(ps, catalog, ref):
    """The general giant run once more with the in-ball counts K2's
    callers pass dropped, so every chain runs over all K slots: every
    field must equal the run with the counts (``ref``)."""
    from so_tpu_torch.engine import derived, solver
    from so_tpu_torch.ops import seqsum

    def full(x, n_valid=None):
        return seqsum.seq_cumsum(x)

    solver.seq_cumsum = derived.seq_cumsum = full
    try:
        out, e2e = run(ps, catalog, (), "cuda")
    finally:
        solver.seq_cumsum = derived.seq_cumsum = seqsum.seq_cumsum
    pairs = assert_runs_equal("giant general, counts dropped", out, ref, ())
    log(f"[giant general, counts dropped] K2's chains over all K slots: "
        f"{len(pairs)} fields and all member lists identical to the run "
        f"with the counts; solve {out.phases['R_Delta solve']:.4f} s e2e "
        f"{e2e:.4f} s")


def phase_giant_vs_cpu():
    """The giant configuration at a CPU-sized scale, with PIECE_K_MIN
    lowered so that K3 serves most dispatches: card and CPU give the same
    bits, both mass variants."""
    from so_tpu_torch.ops import gather

    small = giant_config(200_000, 120_000, 12)
    kmin = gather.PIECE_K_MIN
    gather.PIECE_K_MIN = 1 << 12
    try:
        for tag, mass in small["masses"]:
            ps, catalog = giant_inputs(small, mass)
            zero_counts()
            g, tg = run(ps, catalog, (), "cuda")
            counts = read_counts()
            c, tc = run(ps, catalog, (), "cpu")
            if counts["K3"] <= 0:
                raise AssertionError(f"giant vs cpu {tag}: K3 never ran")
            pairs = assert_runs_equal(f"giant vs cpu {tag}", g, c, ())
            log(f"[giant vs cpu {tag}] particles={ps.n} halos="
                f"{catalog().n}, PIECE_K_MIN=2^12, launches {counts}: "
                f"{len(pairs)} fields and all member lists bit-identical; "
                f"largest solve K={int(g.solve.kcap.max())}; cuda {tg:.3f} "
                f"s, cpu {tc:.3f} s")
    finally:
        gather.PIECE_K_MIN = kmin


def seconds(fn, *a, **kw):
    """(fn's result, its wall seconds, the card synced before and after)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*a, **kw)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


SOLVE_FIELDS = ("code", "mvir", "rvir", "j", "d2cut")


def same_solve(tag, a, b, fields=SOLVE_FIELDS):
    for f in fields:
        if getattr(a, f).tobytes() != getattr(b, f).tobytes():
            raise AssertionError(f"{tag}: {f} differs")


def host_peak_gib():
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def log_run(tag, out, e2e, n_halos, counts):
    import torch

    ph = out.phases
    solve = ph.get("R_Delta solve", ph.get("R_Delta solve (multi)"))
    log(f"[{tag}] halos={n_halos} ok/-1/-2/-3="
        f"{check_run(tag, out, n_halos)}; " + ", ".join(
            f"{k} {v:.3f} s" for k, v in ph.items())
        + f"; {n_halos / solve:.0f} solves/s; e2e {e2e:.3f} s; launches "
        f"K1 {counts['K1']} K1s {counts['K1s']} K3 {counts['K3']}; largest "
        f"solve K {int(out.solve.kcap.max()) if out.solve.kcap is not None else 0}"
        f"; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, host peak "
        f"RSS {host_peak_gib():.2f} GiB")


def counted_run(tag, fn, *a, **kw):
    """fn(*a, **kw) counted(), with the device's peak memory reset first:
    (result, seconds, counts)."""
    import torch

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out, sec = counted(tag, seconds, fn, *a, **kw, need=("K1", "K1s"))
    return out, sec, read_counts()


def oracle_check(tag, ps, out, centers, rgtp, halos):
    """The halos' code, Mvir and Rvir against tests/reference_oracle.py's
    brute-force solve (rel 2e-5), four halos at a time in threads (numpy
    lets go of the GIL in its array loops and sorts)."""
    from concurrent.futures import ThreadPoolExecutor

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from reference_oracle import oracle_rvir

    def oracle(h):
        return oracle_rvir(ps.pos, ps.mass, centers[h], rgtp[h],
                           (1.0, 1.0, 1.0), THR, 8)

    with ThreadPoolExecutor(4) as pool:
        wants = list(pool.map(oracle, halos))
    for h, want in zip(halos, wants):
        got = [out.solve.code[h], out.solve.mvir[h], out.solve.rvir[h]]
        if got[0] != want["code"] or any(
                abs(g - want[f]) > 2e-5 * abs(want[f])
                for g, f in zip(got[1:], ("mvir", "rvir"))):
            raise AssertionError(f"{tag}: halo {h} {got} disagrees with the "
                                 f"oracle {want}")


def inputs_sha256(ps, cat):
    """sha256 of one run_so's inputs: the species split, the particle
    arrays and the catalog's centers, rgtp and masses."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    hdr = ps.header
    h.update(np.asarray([hdr.nsph, hdr.ndark, hdr.nstar], np.int64).tobytes())
    for a in (ps.pos, ps.vel, ps.mass, ps.phi, cat.pos, cat.rgtp,
              cat.gtp_mass):
        h.update(np.ascontiguousarray(a, np.float32).tobytes())
    return h.hexdigest()


def files_sha256(paths):
    """(sha256 of the files' bytes in turn, their newline count)."""
    import hashlib

    h, lines = hashlib.sha256(), 0
    for p in paths:
        with open(p, "rb") as f:
            while block := f.read(1 << 24):
                h.update(block)
                lines += block.count(b"\n")
    return h.hexdigest(), lines


def run_record(out):
    """Per-halo arrays of one run_so result of either package (their SORun
    fields share names), as tests/torch_refs/<box>.npz holds them: the
    solve's code, Mvir, Rvir, j, d2cut and vcm; the conflict pass's
    per-halo Mvir, Rvir and slurped flags, its two counters, the particles
    each group owns, and the sha256 of igrp, n_subsumed and n_ignored; the
    derived quantities; and each halo's member count (-1: no list) with
    the first 8 bytes of the blake2b of its ids sorted ascending (the tie
    order at equal d2 is free, docs/PARITY.md #3). Floats are f32, ints
    i64."""
    import hashlib

    import numpy as np

    def norm(a):
        a = np.asarray(a)
        return a.astype(np.float32 if a.dtype.kind == "f" else
                        bool if a.dtype.kind == "b" else np.int64)

    s, c, d = out.solve, out.conflicts, out.derived
    rec = {f: norm(getattr(s, f))
           for f in ("code", "mvir", "rvir", "j", "d2cut", "vcm")}
    G = rec["code"].shape[0]
    for f in ("mvir", "rvir", "slurped_own"):
        rec[f"conflicts.{f}"] = norm(getattr(c, f))
    rec["conflicts.groups"] = norm([c.groups_removed, c.groups_slurped])
    igrp = np.asarray(c.igrp, np.int64)
    rec["conflicts.igrp_counts"] = np.bincount(igrp, minlength=G + 1)
    for f in ("igrp", "n_subsumed", "n_ignored"):
        rec[f"conflicts.{f}_sha256"] = np.asarray(hashlib.sha256(
            np.ascontiguousarray(getattr(c, f), np.int32).tobytes())
            .hexdigest())
    for f in ("vcirc", "rmass", "rmax", "vmax"):
        rec[f] = norm(getattr(d, f))
    for sp, v in d.profiles.items():
        rec[f"profile.{sp}"] = norm(v)
    count = np.full(G, -1, np.int64)
    digest = np.zeros(G, np.uint64)
    for h, m in enumerate(out.members):
        if m is not None:
            ids = np.sort(np.asarray(m, np.int64))
            count[h] = ids.size
            digest[h] = int.from_bytes(hashlib.blake2b(
                ids.tobytes(), digest_size=8).digest(), "little")
    rec["members.count"], rec["members.digest"] = count, digest
    return rec


def fma32(a, b, c):
    """f32 fused multiply-add, fl32(a*b + c) with one rounding: the f64
    product of two f32 values is exact, the f64 sum is rounded to odd
    (TwoSum error term), and rounding an odd-rounded 53-bit value to 24
    bits is the correct single rounding. Inputs are non-negative."""
    import numpy as np

    a, b, c = (np.asarray(v, np.float64) for v in (a, b, c))
    p = a * b
    s = p + c
    bv = s - p
    err = (p - (s - bv)) + (c - bv)
    bits = s.view(np.int64).copy()
    odd = (err != 0) & ((bits & 1) == 0)
    bits[odd] += np.where(err[odd] > 0, 1, -1)
    return bits.view(np.float64).astype(np.float32)


class D2Witness:
    """The numpy witnesses of a halo's D2_FIELDS under the two d2 forms
    (tests/test_torch_solver.py's d2_forms): "per_op", each particle's d2
    as the port's kernels round it, (c - p*rint((c - x)/p)) - x per axis,
    squared and summed left to right, one rounding an op; "fused",
    XLA:CPU's fma(dz, dz, fma(dx, dx, dy*dy)) over the same differences,
    as so_tpu computes it on the CPU. Under each: d2cut the (j-1)-th of the
    sorted d2; rmass, rmax and vmax from the sorted 2*Rvir ball as
    tests/test_torch_pipeline.py's _d2_read_fields forms them (grav 1).
    Only the particles of the cells about the halo are read: a grid of
    NCELL^3 cells over the unit periodic box."""

    NCELL = 64

    def __init__(self, pos, mass, centers, rec, n_members=8):
        import numpy as np

        n = self.NCELL
        ic = np.floor((np.asarray(pos, np.float64) + 0.5) * n).astype(
            np.int64) % n
        key = (ic[:, 0] * n + ic[:, 1]) * n + ic[:, 2]
        self.order = np.argsort(key, kind="stable")
        self.start = np.searchsorted(key[self.order], np.arange(n ** 3 + 1))
        self.pos, self.mass, self.centers = pos, mass, centers
        self.rec, self.n_members = rec, n_members

    def near(self, c, r):
        """Rows of the particles in the cells that meet the cube of
        half-side r about c."""
        import numpy as np

        n = self.NCELL
        axes = []
        for a in range(3):
            lo = int(np.floor((float(c[a]) - r + 0.5) * n)) - 1
            hi = int(np.floor((float(c[a]) + r + 0.5) * n)) + 1
            axes.append(np.arange(n) if hi - lo + 1 >= n
                        else np.arange(lo, hi + 1) % n)
        cells = ((axes[0][:, None, None] * n + axes[1][None, :, None]) * n
                 + axes[2][None, None, :]).ravel()
        return np.concatenate([self.order[self.start[k]:self.start[k + 1]]
                               for k in cells])

    def __call__(self, h):
        """{"per_op": {field: value}, "fused": {field: value}} of halo h."""
        import numpy as np

        c = np.asarray(self.centers[h], np.float32)
        rvir = self.rec["rvir"][h]
        fball = np.float32(2.0) * rvir
        rows = self.near(c, 1.001 * float(fball) + 1e-6)
        p = np.float32(1.0)
        d = (c - p * np.round((c - self.pos[rows]) / p)) - self.pos[rows]
        x, y, z = d[:, 0], d[:, 1], d[:, 2]
        mass = np.asarray(self.mass, np.float32)[rows]
        return {"per_op": self.fields(x * x + y * y + z * z, mass, h),
                "fused": self.fields(fma32(z, z, fma32(x, x, y * y)), mass,
                                     h)}

    def fields(self, d2, mass, h):
        """D2_FIELDS of halo h from its rows' d2 under one form."""
        import numpy as np

        rvir, mvir = self.rec["rvir"][h], self.rec["mvir"][h]
        j = int(self.rec["j"][h])
        fball = np.float32(2.0) * rvir
        srt = np.sort(d2)
        nan = np.float32(np.nan)
        d2cut = srt[j - 1] if 1 <= j <= srt.size else nan
        ball = np.nonzero(d2 <= fball * fball)[0]
        ball = ball[np.argsort(d2[ball], kind="stable")]
        d2_s = d2[ball]
        if not d2_s.size:
            return dict(d2cut=d2cut, rmass=np.full(2, nan), rmax=nan,
                        vmax=nan)
        cum = np.cumsum(mass[ball], dtype=np.float32)
        rmass = []
        for f in (0.25, 0.5):
            ge = cum >= np.float32(f) * mvir
            rmass.append(np.sqrt(d2_s[np.argmax(ge) if ge.any() else -1]))
        with np.errstate(divide="ignore", invalid="ignore"):
            r_s = np.sqrt(d2_s)
            vc = np.sqrt(cum / r_s)
        vc[: self.n_members - 1] = -np.inf
        jm = int(np.argmax(vc))
        rmax, vmax = r_s[jm], vc[jm]
        if not np.isfinite(vmax):
            rmax = vmax = np.float32(0.0)
        return dict(d2cut=d2cut, rmass=np.asarray(rmass, np.float32),
                    rmax=rmax, vmax=vmax)


def compare_to_ref(tag, rec, ref, witness):
    """Hold one run's run_record to so_tpu's (``ref``): every field bit for
    bit, but that where a halo's D2_FIELDS differ, the run's value must
    equal ``witness(h)``'s per-op form and so_tpu's its fused form, so the
    two d2 forms account for the difference. Returns {field: the halos
    where it took the witness}; raises, listing every difference, on any
    other."""
    import numpy as np

    errs = []
    if set(rec) != set(ref):
        raise AssertionError(f"{tag}: fields {sorted(set(rec) ^ set(ref))} "
                             "on one side only")
    G = rec["code"].shape[0]
    wit, took = {}, {}
    for k in sorted(ref):
        a, b = np.asarray(rec[k]), np.asarray(ref[k])
        if a.shape != b.shape or a.dtype != b.dtype:
            errs.append(f"{k}: {a.dtype}{a.shape} against so_tpu's "
                        f"{b.dtype}{b.shape}")
            continue
        if a.ndim == 0 or a.shape[0] != G:
            if a.tobytes() != b.tobytes():
                errs.append(f"{k}: {a} against so_tpu's {b}")
            continue
        diff = np.nonzero((np.ascontiguousarray(a).view(np.uint8)
                           .reshape(G, -1) != np.ascontiguousarray(b)
                           .view(np.uint8).reshape(G, -1)).any(axis=1))[0]
        if not diff.size:
            continue
        if k not in D2_FIELDS:
            errs.append(f"{k}: {diff.size} halos differ, first "
                        f"{diff[:5].tolist()}: {a[diff[:3]].tolist()} "
                        f"against so_tpu's {b[diff[:3]].tolist()}")
            continue
        took[k] = diff.tolist()
        for h in took[k]:
            if h not in wit:
                wit[h] = witness(h)
            w = {form: np.asarray(v[k], np.float32)
                 for form, v in wit[h].items()}
            if (w["per_op"].tobytes() != a[h].tobytes()
                    or w["fused"].tobytes() != b[h].tobytes()):
                errs.append(f"{k} of halo {h}: {a[h].tolist()} against "
                            f"the per-op witness {w['per_op'].tolist()}, "
                            f"so_tpu's {b[h].tolist()} against the fused "
                            f"witness {w['fused'].tolist()}")
    if errs:
        raise AssertionError(f"{tag} against so_tpu ({len(errs)}):\n"
                             + "\n".join(errs[:20]))
    return took


def load_ref(name):
    """tests/torch_refs/<name>.npz as a dict of arrays."""
    import numpy as np

    with np.load(os.path.join(REF_DIR, f"{name}.npz")) as z:
        return {k: z[k] for k in z.files}


def write_zoom_inputs(work, n_hi, n_lo, n_halos):
    """compare_reference_zoom.py's inputs: make_zoom_box(rng(2026), ...)
    written as work/snap.bin (gas, dark, star) and work/cat.gtp with masses
    from the same generator; returns the two files' sha256."""
    import numpy as np

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from torch_scenarios import make_zoom_box, write_gtp, write_snapshot

    rng = np.random.default_rng(2026)
    data, split, centers, rmax = make_zoom_box(rng, n_hi, n_lo, n_halos)
    os.makedirs(work, exist_ok=True)
    write_snapshot(f"{work}/snap.bin", data, time=1.0, split=split)
    gtp_mass = rng.uniform(0.001, 1.0, n_halos).astype(np.float32)
    write_gtp(f"{work}/cat.gtp", centers, rmax, gtp_mass, time=1.0)
    return files_sha256([f"{work}/snap.bin", f"{work}/cat.gtp"])[0]


def cli_record(base):
    """What tests/torch_refs/zoom.npz holds of one CLI run's files
    ``base``.<ext>: each float file's text without the lines that
    compare_text skips (the run time, the paths), the .sogtp's bytes, and
    each exact file's sha256 and line count."""
    import numpy as np

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from torch_compare import SKIP_SUBSTRINGS

    rec = {}
    for ext in ZOOM_FLOAT:
        with open(f"{base}.{ext}", "rb") as f:
            text = b"".join(ln for ln in f if not any(
                s.encode() in ln for s in SKIP_SUBSTRINGS))
        rec[f"file.{ext}"] = np.frombuffer(text, np.uint8)
    with open(f"{base}.sogtp", "rb") as f:
        rec["file.sogtp"] = np.frombuffer(f.read(), np.uint8)
    for ext in ZOOM_EXACT:
        sha, lines = files_sha256([f"{base}.{ext}"])
        rec[f"sha256.{ext}"] = np.asarray(sha)
        rec[f"lines.{ext}"] = np.asarray(lines, np.int64)
    return rec


def compare_cli_files(tag, base, ref):
    """One CLI run's files ``base``.<ext> against so_tpu's (``ref``, a
    cli_record) by compare_reference_zoom.py's rules: catalogs and
    profiles to float tolerance (tests/torch_compare.compare_text), the
    .sogtp field by field, .sogrp/.sosub/.soign exactly (sha256 and line
    count). Raises listing the differences."""
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from torch_compare import compare_sogtp, compare_text

    errs = []
    for ext in ZOOM_FLOAT:
        with open(f"{base}.{ext}") as f:
            errs += compare_text(ref[f"file.{ext}"].tobytes().decode(),
                                 f.read(), f"{tag} .{ext}")
    with open(f"{base}.so_tpu.sogtp", "wb") as f:
        f.write(ref["file.sogtp"].tobytes())
    errs += compare_sogtp(f"{base}.so_tpu.sogtp", f"{base}.sogtp")
    for ext in ZOOM_EXACT:
        got = files_sha256([f"{base}.{ext}"])
        want = (str(ref[f"sha256.{ext}"]), int(ref[f"lines.{ext}"]))
        if got != want:
            errs.append(f"{tag} .{ext}: sha256, lines {got} against "
                        f"so_tpu's {want}")
    if errs:
        raise AssertionError("\n".join(errs[:20]))


def phase_goldens():
    """The 17 reference goldens (tests/goldens, scenarios of
    tests/torch_scenarios.py) through the port's CLI in this process on
    "cuda", compared by tests/test_torch_golden.py's rules: catalogs to
    float tolerance, .sogrp/.sosub/.soign exactly, .sogtp field by field.
    The set runs twice: at the default routes, then with
    gather.PIECE_K_MIN at 512, so K3 and sort_in_ball serve every gather
    above 512 slots; K3 must run in that pass. Each scenario must launch
    K1's sorted form at the default routes, K1 or K3 at 512."""
    from so_tpu_torch.ops import gather

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from torch_compare import compare_exact_file, compare_file, compare_sogtp
    from torch_scenarios import OUTPUT_FILES, SCENARIOS, generate_inputs

    base = os.path.join(HERE, "so_tpu_torch", "_build", "chip_smoke_goldens")
    args = {name: generate_inputs(name, f"{base}/{name}")
            for name in sorted(SCENARIOS)}
    kmin = gather.PIECE_K_MIN
    for route, k in (("default", kmin), ("PIECE_K_MIN 512", 512)):
        gather.PIECE_K_MIN = k
        total = dict.fromkeys(LAUNCHES, 0)
        try:
            for name, a in args.items():
                work = f"{base}/{name}"
                argv = ["-i", f"{work}/cat.gtp", "-o", f"{work}/got",
                        "--tipsy", f"{work}/snap.bin", "--device",
                        "cuda"] + a
                remove_outputs(f"{work}/got")
                zero_counts()
                _, sec, _ = cli_in_process(argv)
                counts = read_counts()
                errs = []
                for ext in OUTPUT_FILES:
                    want, got = f"{HERE}/tests/goldens/{name}/{ext}", \
                        f"{work}/got.{ext}"
                    if not os.path.exists(want):
                        continue
                    if not os.path.exists(got):
                        errs.append(f"missing output {got}")
                    elif ext == "sogtp":
                        errs += compare_sogtp(want, got, SCENARIOS[name][2])
                    elif ext in ("sogrp", "sosub", "soign"):
                        errs += compare_exact_file(want, got)
                    else:
                        errs += compare_file(want, got)
                if errs:
                    raise AssertionError(f"golden {name} ({route}):\n"
                                         + "\n".join(errs[:10]))
                if (min(counts["K1"], counts["K1s"]) if route == "default"
                        else counts["K1"] + counts["K3"]) <= 0 \
                        or counts["ranges"] <= 0:
                    raise AssertionError(f"golden {name} ({route}): a "
                                         f"gather kernel never ran: {counts}")
                for key, v in counts.items():
                    total[key] += v
                    LAUNCHES[key] += v
                log(f"[golden] {name} ({route}): equal to tests/goldens; "
                    f"{sec:.2f} s; launches K1 {counts['K1']} K1s "
                    f"{counts['K1s']} K2 {counts['K2']} K3 {counts['K3']}")
        finally:
            gather.PIECE_K_MIN = kmin
        if route != "default" and total["K3"] <= 0:
            raise AssertionError(f"goldens ({route}): K3 never ran")
        log(f"[goldens {route}] {len(args)} scenarios equal to "
            f"tests/goldens; launches {total}")


def phase_at_scale():
    """The card against so_tpu's own outputs (tests/torch_refs, written on
    the CPU by tests/make_torch_refs.py; inputs checked by their sha256):
    the run_so results of the main-path (standard box, both mass kinds)
    and giant (both mass kinds) phases by compare_to_ref, and the CLI with
    compare_reference_zoom.py's flags on its zoom box, run here on "cuda",
    by compare_cli_files."""
    import torch

    with open(os.path.join(REF_DIR, "manifest.json")) as f:
        manifest = json.load(f)["boxes"]
    for name in ("standard_uniform", "standard_species", "giant_general",
                 "giant_uniform"):
        run = AT_SCALE.pop(name)
        if run["sha"] != manifest[name]["inputs_sha256"]:
            raise AssertionError(f"{name}: inputs differ from so_tpu's")
        t0 = time.perf_counter()
        rec = run["rec"]
        took = compare_to_ref(name, rec, load_ref(name), D2Witness(
            run["ps"].pos, run["ps"].mass, run["centers"], rec))
        log(f"[so_tpu at scale] {name}: {rec['code'].shape[0]} halos "
            f"({int((rec['code'] == 0).sum())} solved), {len(rec)} fields "
            f"equal to so_tpu's but for {len(set().union(*took.values()))} "
            "halos that equal the per-op witness instead, so_tpu's the "
            "fused one ("
            + ", ".join(f"{k} {len(v)}" for k, v in took.items())
            + f"); {time.perf_counter() - t0:.1f} s")
    work = os.path.join(HERE, "so_tpu_torch", "_build", "chip_smoke_zoom")
    t0 = time.perf_counter()
    sha = write_zoom_inputs(work, **ZOOM_BOX)
    if sha != manifest["zoom"]["inputs_sha256"]:
        raise AssertionError("zoom: inputs differ from so_tpu's")
    made = time.perf_counter() - t0
    remove_outputs(f"{work}/got")
    torch.cuda.reset_peak_memory_stats()
    _, sec, err = counted("zoom", cli_in_process, [
        "-i", f"{work}/cat.gtp", "-o", f"{work}/got", "--tipsy",
        f"{work}/snap.bin", "--device", "cuda", "--verbose"] + ZOOM_FLAGS,
        need=("K1", "K1s", "K2"))
    k3 = read_counts()["K3"]
    k3 = (f"K3 launched {k3} times (a ball above 2^15 slots)" if k3 else
          "K3 not launched (no ball above 2^15 slots)")
    t0 = time.perf_counter()
    compare_cli_files("zoom", f"{work}/got", load_ref("zoom"))
    log(f"[so_tpu at scale] zoom: {ZOOM_BOX}, inputs {made:.1f} s; the "
        f"CLI on the card {sec:.2f} s{phase_table(err)}; {k3}; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; every "
        "file equal to so_tpu's by compare_reference_zoom.py's rules, "
        f"{time.perf_counter() - t0:.1f} s")


def phase_512():
    """so_tpu's 512^3 catalog (experiments/scale512.py): make_box(rng(12345),
    512**3, 65536), uniform masses, Delta 178. run_so once on "cuda"; 4
    largest solved and 4 random halos against the oracle; run_so_multi at
    178/200/500 on a prebuilt grid, whose 178 run equals run_so's in every
    field."""
    import numpy as np
    import torch

    from so_tpu_torch.engine.pipeline import SOParams, run_so, run_so_multi
    from so_tpu_torch.ops.grid import build_grid

    t0 = time.perf_counter()
    box = make_box(np.random.default_rng(SEED), 512 ** 3, 65536)
    log(f"[512^3] make_box {time.perf_counter() - t0:.1f} s: "
        f"{box[0].shape[0]} particles, {box[3].shape[0]} halos")
    ps, catalog = particles_and_catalog(box, (), SEED)
    centers, rgtp = box[3], box[4]
    del box
    G = centers.shape[0]
    out, e2e, counts = counted_run("512^3 run_so", run_so, ps, catalog(),
                                   SOParams(threshold=THR, device="cuda"))
    log_run("512^3 run_so", out, e2e, G, counts)

    ok = np.nonzero(out.solve.code == 0)[0]
    big = ok[np.argsort(out.solve.j[ok], kind="stable")[-4:]]
    rnd = np.random.default_rng(SEED).choice(G, 4, replace=False)
    t0 = time.perf_counter()
    oracle_check("512^3", ps, out, centers, rgtp, list(big) + list(rnd))
    log(f"[512^3] halos {big.tolist()} (largest j "
        f"{out.solve.j[big].tolist()}) and {rnd.tolist()} (codes "
        f"{out.solve.code[rnd].tolist()}) equal the oracle (code, Mvir, "
        f"Rvir to 2e-5); {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    grid = build_grid(ps.pos, ps.mass, vel=ps.vel, ptype=ps.ptype_all(),
                      mark=ps.mark, device="cuda")
    torch.cuda.synchronize()
    log(f"[512^3] grid for --deltas: {time.perf_counter() - t0:.3f} s")
    runs, e2e_m, counts = counted_run(
        "512^3 run_so_multi", run_so_multi, ps, catalog(),
        SOParams(threshold=THR, device="cuda"), (THR, 200.0, 500.0),
        grid=grid)
    pairs = assert_runs_equal("512^3 --deltas 178", runs[0], out, ())
    log_run("512^3 run_so_multi 178/200/500", runs[0], e2e_m, G, counts)
    log(f"[512^3 run_so_multi] threshold 178: {len(pairs)} fields and all "
        "member lists identical to run_so's; ok at 200 / 500: "
        f"{int((runs[1].solve.code == 0).sum())} / "
        f"{int((runs[2].solve.code == 0).sum())}")
    del grid, runs, out
    torch.cuda.empty_cache()


def phase_survey_box():
    """bench.py's survey box: make_box(rng(12345), 2**25, 1_000_000).
    solve_rvir with survey None (the auto-gate), True and False: codes,
    Mvir, Rvir, j and d2cut identical; then one run_so end to end, whose 8
    largest and 8 random other solved halos must equal the oracle."""
    import numpy as np
    import torch

    from so_tpu_torch.engine import solver
    from so_tpu_torch.engine.pipeline import SOParams, run_so
    from so_tpu_torch.ops.grid import build_grid

    t0 = time.perf_counter()
    box = make_box(np.random.default_rng(SEED), 2 ** 25, 1_000_000)
    log(f"[survey box] make_box {time.perf_counter() - t0:.1f} s: "
        f"{box[0].shape[0]} particles, {box[3].shape[0]} halos")
    pos, mass, _, centers, rgtp = box
    G = centers.shape[0]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    grid = build_grid(pos, mass, device="cuda")
    res = {}
    for survey in (None, True, False):
        tag = f"survey box, survey={survey}"
        r, sec = counted(tag, seconds, solver.solve_rvir, grid, centers,
                         rgtp, THR, survey=survey, need=("K1", "K1s"))
        counts = read_counts()
        res[survey] = r
        same_solve(tag, r, res[None])
        log(f"[{tag}] solve {sec:.3f} s ({G / sec:.0f} solves/s), "
            f"n_survey {r.n_survey}, launches K1 {counts['K1']} K1s "
            f"{counts['K1s']} K3 {counts['K3']}")
    # past its sample the gate either stops (at most SURVEY_SAMPLE halos
    # resolved) or classifies the rest; the forced pass, grouped into other
    # dispatches, may resolve a few halos more or fewer
    n_auto, n_all = res[None].n_survey, res[True].n_survey
    verdict = ("ran the full pre-pass" if n_auto > solver.SURVEY_SAMPLE
               else "stopped after its sample")
    log(f"[survey box] the auto-gate {verdict} ({n_auto} of {G} halos "
        f"resolved; forced: {n_all}); codes, Mvir, Rvir, j, d2cut identical "
        "across the three; peak device memory of the grid and the solves "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del grid, res
    ps, catalog = particles_and_catalog(box, (), SEED)
    del box
    out, e2e, counts = counted_run("survey box run_so", run_so, ps,
                                   catalog(), SOParams(threshold=THR,
                                                       device="cuda"))
    log_run("survey box run_so", out, e2e, G, counts)
    ok = np.nonzero(out.solve.code == 0)[0]
    big = ok[np.argsort(out.solve.j[ok], kind="stable")[-8:]]
    rnd = np.random.default_rng(SEED).choice(np.setdiff1d(ok, big), 8,
                                             replace=False)
    t0 = time.perf_counter()
    oracle_check("survey box", ps, out, centers, rgtp, list(big) + list(rnd))
    log(f"[survey box] solved halos {big.tolist()} (largest j "
        f"{out.solve.j[big].tolist()}) and {rnd.tolist()} (j "
        f"{out.solve.j[rnd].tolist()}) equal the oracle (code, Mvir, Rvir "
        f"to 2e-5); {time.perf_counter() - t0:.1f} s")
    del out
    torch.cuda.empty_cache()


def cuda_mesh(shape):
    from so_tpu_torch.parallel import make_mesh

    h, p = shape
    return make_mesh(h, p, devices=["cuda:0"] * (h * p))


def run_sharded(ps, catalog, species, mesh, **kw):
    from so_tpu_torch.engine.pipeline import SOParams
    from so_tpu_torch.parallel import run_so_sharded

    t0 = time.perf_counter()
    out = run_so_sharded(ps, catalog(), SOParams(threshold=THR,
                                                 species=species, **kw), mesh)
    return out, time.perf_counter() - t0


def timed_runs(fn, *a):
    """One cold and MESH_WARM_RUNS warm runs of ``fn(*a)`` (an SORun and
    its e2e seconds): the last run, the cold (solve, e2e) seconds and the
    warm medians."""
    times = []
    for _ in range(1 + MESH_WARM_RUNS):
        out, e2e = fn(*a)
        times.append((out.phases["R_Delta solve"], e2e))
    warm = [statistics.median(t[i] for t in times[1:]) for i in (0, 1)]
    return out, times[0], warm


def member_d2(ps, center, members):
    """d2 of each member from ``center`` in the port's f32 form (one
    rounding an op, as row_fields), in the unit periodic box of every box
    here."""
    import numpy as np

    x = ps.pos[members]
    d = (center - np.float32(1.0) * np.round((center - x) / np.float32(1.0))
         ) - x
    return d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]


def equal_d2_pairs(ps, centers, radii):
    """Per ball, the pairs of neighbours at equal d2 among its particles
    (the port's f32 form in the unit periodic box, on the card: each torch
    op rounds once)."""
    import torch

    pos = torch.as_tensor(ps.pos, device="cuda")
    out = []
    for c, r in zip(centers, radii):
        c = torch.as_tensor(c, device="cuda")
        d = (c - torch.round(c - pos)) - pos
        d2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
        inside = torch.sort(d2[d2 <= float(r) * float(r)]).values
        out.append(int((inside[1:] == inside[:-1]).sum()))
    return out


def mesh_agrees(tag, got, want, ps, sp, uniform):
    """A sharded run against run_so on the same inputs. Uniform mass:
    every field bit for bit, and every member list, where a list may
    differ only in the order of members at equal d2 (docs/PARITY.md #3:
    the merge orders a tie by shard). General mass: codes, j and member
    sets exact, Mvir, Rvir and d2cut to rtol 2e-6 (the serial sum past a
    tie may differ by an ulp). Returns (halos whose solve bits differ,
    halos whose member order differs within a tie)."""
    import numpy as np

    a, b = got.solve, want.solve
    if uniform:
        assert_runs_equal(tag, got, want, sp, members=False)
    for f in ("code", "j"):
        if getattr(a, f).tobytes() != getattr(b, f).tobytes():
            raise AssertionError(f"{tag}: solve.{f} differs from run_so")
    for f in ("mvir", "rvir", "d2cut"):
        if not np.allclose(getattr(a, f), getattr(b, f), rtol=2e-6, atol=0):
            raise AssertionError(f"{tag}: solve.{f} beyond rtol 2e-6")
    differ = np.nonzero(
        (a.mvir.view(np.int32) != b.mvir.view(np.int32))
        | (a.rvir.view(np.int32) != b.rvir.view(np.int32))
        | (a.d2cut.view(np.int32) != b.d2cut.view(np.int32)))[0]
    tie_order = []
    centers = np.asarray(want.catalog.pos, np.float32)
    for h, (ma, mb) in enumerate(zip(got.members, want.members)):
        if (ma is None) != (mb is None):
            raise AssertionError(f"{tag}: members of halo {h} differ")
        if ma is None or np.array_equal(ma, mb):
            continue
        if not np.array_equal(np.sort(ma), np.sort(mb)):
            raise AssertionError(f"{tag}: member set of halo {h} differs")
        if uniform and not np.array_equal(member_d2(ps, centers[h], ma),
                                          member_d2(ps, centers[h], mb)):
            raise AssertionError(f"{tag}: members of halo {h} differ in "
                                 "more than the order within a tie")
        tie_order.append(h)
    return differ, np.asarray(tie_order, np.int64)


def log_mesh(tag, got, want, ps, sp, uniform):
    """mesh_agrees, and the [mesh] line with the count of halos whose bits
    or member order differ and of the equal-d2 pairs in their balls."""
    import numpy as np

    differ, tie_order = mesh_agrees(tag, got, want, ps, sp, uniform)
    odd = np.union1d(differ, tie_order)
    ok = want.solve.code == 0
    radii = np.where(ok, np.float32(2) * want.solve.rvir,
                     np.float32(1.2) * want.catalog.rgtp)[odd]
    pairs = sum(equal_d2_pairs(ps, want.catalog.pos[odd], radii))
    log(f"[mesh] {tag}: against run_so on the card: "
        + ("every field bit-identical" if uniform else
           "codes, j and member sets exact, Mvir/Rvir/d2cut within rtol "
           "2e-6")
        + f"; {differ.size} halos with other solve bits, {tie_order.size} "
        f"with member order differing within a tie; {pairs} equal-d2 pairs "
        f"in the 2 Rvir balls of those {odd.size} halos")


def phase_mesh(box):
    """--mesh: run_so_sharded on 1x4 and 2x2 meshes of cuda:0 over the
    standard box, uniform and three-species masses, each against the
    card's run_so; run_so_multi_sharded at DELTAS on the 2x2 mesh against
    run_so_multi; the reduced giant box on a 1x2 mesh with PIECE_K_MIN at
    2^12 (K3) against run_so; and the CLI's --mesh 1x1 against the plain
    CLI on the 2^18 box. The sharded runs are counted (K1, K1s, K2; K3 on
    the giant box); the single-device references are not."""
    from so_tpu_torch.engine.pipeline import SOParams, run_so_multi
    from so_tpu_torch.io.tipsy import DARK, GAS, STAR
    from so_tpu_torch.ops import gather
    from so_tpu_torch.parallel import run_so_multi_sharded

    sp3 = (DARK, GAS, STAR)
    for tag, sp in (("uniform", ()), ("species", sp3)):
        ps, catalog = particles_and_catalog(box, sp, SEED)
        want, cold, warm = timed_runs(run, ps, catalog, sp, "cuda")
        log(f"[mesh {tag} single device] cold solve {cold[0]:.4f} s e2e "
            f"{cold[1]:.4f} s; median of {MESH_WARM_RUNS} warm: solve "
            f"{warm[0]:.4f} s e2e {warm[1]:.4f} s")
        for shape in MESH_SHAPES:
            name = f"{shape[0]}x{shape[1]}"
            got, cold_m, warm_m = counted(
                f"--mesh {name} {tag}", timed_runs, run_sharded, ps,
                catalog, sp, cuda_mesh(shape),
                need=("K1", "K1s") + (("K2",) if sp else ()))
            log(f"[mesh {name} {tag}] cold solve {cold_m[0]:.4f} s e2e "
                f"{cold_m[1]:.4f} s; median of {MESH_WARM_RUNS} warm: "
                f"solve {warm_m[0]:.4f} s e2e {warm_m[1]:.4f} s (single "
                f"device: {warm[0]:.4f} s, {warm[1]:.4f} s)")
            log_mesh(f"{name} {tag}", got, want, ps, sp, not sp)
        del want, got

    ps, catalog = particles_and_catalog(box, sp3, SEED)
    params = SOParams(species=sp3)
    shape = MESH_SHAPES[1]
    t0 = time.perf_counter()
    want = run_so_multi(ps, catalog(), SOParams(species=sp3, device="cuda"),
                        DELTAS)
    t1 = time.perf_counter()
    got = counted(f"--mesh {shape[0]}x{shape[1]} --deltas",
                  run_so_multi_sharded, ps, catalog(), params, DELTAS,
                  cuda_mesh(shape))
    t2 = time.perf_counter()
    for d, g, w in zip(DELTAS, got, want):
        log_mesh(f"{shape[0]}x{shape[1]} --deltas Delta={d:g}", g, w, ps,
                 sp3, False)
    log(f"[mesh {shape[0]}x{shape[1]} --deltas] T={len(DELTAS)} solve "
        f"(multi) {got[0].phases['R_Delta solve (multi)']:.4f} s e2e "
        f"{t2 - t1:.4f} s (single device: "
        f"{want[0].phases['R_Delta solve (multi)']:.4f} s, "
        f"{t1 - t0:.4f} s; cold)")
    del want, got

    small_giant = giant_config(200_000, 120_000, 12)
    kmin = gather.PIECE_K_MIN
    gather.PIECE_K_MIN = 1 << 12
    try:
        for tag, mass in small_giant["masses"]:
            gps, gcat = giant_inputs(small_giant, mass)
            want, tw = run(gps, gcat, (), "cuda")
            got, tg = counted(f"--mesh 1x2 giant {tag}", run_sharded, gps,
                              gcat, (), cuda_mesh((1, 2)),
                              need=("K1", "K1s", "K3")
                              + (("K2",) if tag == "general" else ()))
            log_mesh(f"1x2 giant {tag}, PIECE_K_MIN=2^12", got, want, gps,
                     (), tag == "uniform")
            log(f"[mesh 1x2 giant {tag}] particles={gps.n} halos="
                f"{gcat().n}; largest shard K="
                f"{int(got.solve.kcap.max())}; e2e {tg:.3f} s (single "
                f"device {tw:.3f} s; cold)")
    finally:
        gather.PIECE_K_MIN = kmin
    phase_mesh_cli()


def phase_mesh_cli():
    """The CLI's --mesh 1x1 on phase_cli's 2^18 files: the outputs equal
    the plain CLI's byte for byte but for the header's run time and the
    names of the profile files it lists."""
    from so_tpu_torch.cli import main as cli_main

    out = os.path.join(HERE, "so_tpu_torch", "_build", "chip_smoke_cli")
    base = ["-i", f"{out}/cat.gtp", "--tipsy", f"{out}/snap.bin", "-grp",
            "-gtp", "-all", "-delta", "178", "--device", "cuda"]
    t0 = time.perf_counter()
    if cli_main(base + ["-o", f"{out}/plain"]) != 0 or \
            cli_main(base + ["-o", f"{out}/mesh", "--mesh", "1x1"]) != 0:
        raise RuntimeError("CLI --mesh 1x1 failed")
    exts = ("sovcirc", "sogrp", "sogtp", "sodark", "sogas", "sostar")
    for ext in exts:
        body = [[ln for ln in open(f"{out}/{run}.{ext}", "rb")
                 if not (ln.startswith(b"# Run on") or b"written to" in ln)]
                for run in ("plain", "mesh")]
        if body[0] != body[1] or not body[0]:
            raise AssertionError(f"CLI --mesh 1x1: .{ext} differs")
    log(f"[mesh cli] python -m so_tpu_torch --mesh 1x1: {len(exts)} output "
        f"files equal the plain CLI's but for the run time and file names; "
        f"{time.perf_counter() - t0:.2f} s for both")


# one rank of --distributed runs: the port's CLI once a job, each job in
# its own process group (a port of its own), the launch counters zeroed
# before each; after each, its counts and e2e seconds on one line
DIST_RANK = """
import json, os, sys, time
sys.path.insert(0, sys.argv[1])
from so_tpu_torch.cli import main
from so_tpu_torch.ops import piece_gather, ranges, seqsum, slab_gather
for port, args in json.loads(sys.argv[2]):
    os.environ["MASTER_PORT"] = str(port)
    slab_gather.launches = slab_gather.sorted_launches = 0
    seqsum.launches = piece_gather.launches = ranges.launches = 0
    t0 = time.perf_counter()
    if main(args) != 0:
        sys.exit(1)
    print("[rank] " + json.dumps(dict(
        e2e=time.perf_counter() - t0, K1=slab_gather.launches,
        K1s=slab_gather.sorted_launches, K2=seqsum.launches,
        K3=piece_gather.launches, ranges=ranges.launches)), flush=True)
"""


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(W, jobs, device="cuda", backend=None):
    """W rank processes of the port's CLI with --distributed, torchrun's
    variables set by hand (localhost, a free port a job). ``jobs`` are
    (tag, CLI args, kernels that must launch) run in turn in the same
    processes. Every rank must exit 0 and report launches of each job's
    kernels. Returns per job rank 0's output, its solve seconds and the
    largest e2e seconds (SO CPU Time: the run from the solve through the
    stats, as the CLI reports it)."""
    extra = ["--distributed", "--device", device] + (
        ["--dist-backend", backend] if backend else [])
    plan = json.dumps([(free_port(), args + extra) for _, args, _ in jobs])
    procs = [subprocess.Popen(
        [sys.executable, "-c", DIST_RANK, HERE, plan], cwd=HERE,
        env=dict(os.environ, MASTER_ADDR="localhost", WORLD_SIZE=str(W),
                 RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(W)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"{jobs[0][0]}...: rank {r} exited "
                               f"{p.returncode}:\n" + out[-3000:])
    # each rank's output, cut after each job's [rank] line
    parts = [out.split("[rank] ")[1:] for out in outs]
    text0 = outs[0].split("[rank] ")[:-1]
    results = []
    for j, (tag, _, need) in enumerate(jobs):
        counts = [json.loads(part[j].splitlines()[0]) for part in parts]
        for r, c in enumerate(counts):
            if any(c[k] <= 0 for k in gather_need(need)):
                raise AssertionError(f"{tag}: rank {r} never ran a kernel "
                                     f"of the path: {c}")
            for k in LAUNCHES:
                LAUNCHES[k] += c[k]
        lines = text0[j].splitlines()
        solve = float(next(ln for ln in lines
                           if ln.startswith("SO CPU Time:")).split()[-1])
        where = next(ln for ln in lines
                     if ln.startswith("--distributed: rank 0"))
        log(f"[dist {tag}] {where[len('--distributed: '):]}"
            f"{'' if j else ' (first job of the processes)'}; launches per "
            "rank: " + "; ".join(
                ", ".join(f"{k} {c[k]}" for k in LAUNCHES)
                for c in counts))
        results.append((text0[j], solve, max(c["e2e"] for c in counts)))
    return results


def phase_table(text):
    """The phase seconds of a --verbose run's timer report, on one line."""
    lines = text.splitlines()
    if "so_tpu_torch phase timings:" not in lines:
        return ""
    import re

    out = []
    for ln in lines[lines.index("so_tpu_torch phase timings:") + 1:]:
        m = re.match(r"  (\S.*?)\s+([0-9.]+s)(\s|$)", ln)
        if m is None:
            break
        out.append(f"{m.group(1)} {m.group(2)}")
    return "; phases: " + ", ".join(out)


def remove_outputs(base):
    """Delete every ``base``.* file an earlier run left, so a comparison
    reads only files the next run wrote."""
    import glob

    for path in glob.glob(glob.escape(base) + ".*"):
        os.remove(path)


def cli_in_process(args):
    """The port's CLI in this process: (the SO CPU Time it reports, e2e
    seconds, its stderr)."""
    import contextlib
    import io

    from so_tpu_torch.cli import main as cli_main

    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        if cli_main(args) != 0:
            raise RuntimeError(f"CLI {args} failed")
    e2e = time.perf_counter() - t0
    return float(next(ln for ln in err.getvalue().splitlines()
                      if ln.startswith("SO CPU Time:")).split()[-1]), e2e, \
        err.getvalue()


def same_outputs(tag, got, want, exts):
    """Two runs' files byte for byte but for the run time and the names of
    the profile files the catalog lists."""
    for ext in exts:
        body = [[ln for ln in open(f"{b}.{ext}", "rb")
                 if not (ln.startswith(b"# Run on") or b"written to" in ln)]
                for b in (got, want)]
        if body[0] != body[1] or not body[0]:
            raise AssertionError(f"{tag}: .{ext} differs from the "
                                 "one-process CLI's")


def write_inputs(base, ps, cat):
    """``base``.bin (the snapshot, its species split) and ``base``.gtp."""
    import numpy as np

    from so_tpu_torch.io.tipsy import (DARK_DTYPE, GAS_DTYPE, STAR_DTYPE,
                                       TipsyHeader, write_tipsy)

    h = ps.header
    recs = []
    for dt, sl in ((GAS_DTYPE, slice(0, h.nsph)),
                   (DARK_DTYPE, slice(h.nsph, h.nsph + h.ndark)),
                   (STAR_DTYPE, slice(h.nsph + h.ndark, h.nbodies))):
        r = np.zeros(sl.stop - sl.start, dtype=dt[False])
        r["mass"], r["pos"], r["vel"] = ps.mass[sl], ps.pos[sl], ps.vel[sl]
        r["phi"] = ps.phi[sl]
        recs.append(r)
    write_tipsy(f"{base}.bin", h, *recs, False)
    G = cat.n
    gtp = np.zeros(G, dtype=STAR_DTYPE[False])
    gtp["mass"], gtp["pos"], gtp["eps"] = cat.gtp_mass, cat.pos, cat.rgtp
    gtp["tform"] = np.arange(1, G + 1)
    write_tipsy(f"{base}.gtp", TipsyHeader(time=1.0, nbodies=G, ndim=3,
                                           nsph=0, ndark=0, nstar=G),
                None, None, gtp, False)


def phase_distributed(box):
    """--distributed on the standard box: each mass kind through the port's
    CLI in this process on cuda:0 (the witness), then as one rank (NCCL
    for the card's tensors) and as two ranks sharing cuda:0 (gloo: NCCL
    refuses two ranks on one card); every output file must equal the
    witness's but for the run time. The ranks run both mass kinds in turn
    in one launch."""
    from so_tpu_torch.io.tipsy import DARK, GAS, STAR

    out = os.path.join(HERE, "so_tpu_torch", "_build", "chip_smoke_dist")
    os.makedirs(out, exist_ok=True)
    flags = ["-grp", "-gtp", "-subsumed", "-ignored", "-delta", "178",
             "--verbose"]
    exts = ("sovcirc", "sogrp", "sogtp", "sosub", "soign")
    kinds = (("uniform", ()), ("species", (DARK, GAS, STAR)))
    witness = {}
    for tag, sp in kinds:
        ps, catalog = particles_and_catalog(box, sp, SEED)
        write_inputs(f"{out}/{tag}", ps, catalog())
        witness[tag] = cli_in_process(
            ["-i", f"{out}/{tag}.gtp", "--tipsy", f"{out}/{tag}.bin", *flags,
             "-o", f"{out}/{tag}.single", "--device", "cuda:0"])
        log(f"[dist {tag} witness] one process on cuda:0: particles={ps.n} "
            f"halos={catalog().n} SO CPU Time {witness[tag][0]:.4f} s e2e "
            f"{witness[tag][1]:.4f} s{phase_table(witness[tag][2])}")
    for W, dev, backend in ((1, "cuda", None), (2, "cuda:0", "gloo")):
        jobs = [(f"{tag} W={W}",
                 ["-i", f"{out}/{tag}.gtp", "--tipsy", f"{out}/{tag}.bin",
                  *flags, "-o", f"{out}/{tag}.w{W}"],
                 ("K1", "K1s") + (("K2",) if sp else ())) for tag, sp in kinds]
        results = run_ranks(W, jobs, dev, backend)
        for (name, _, _), (tag, _), (text, solve, e2e) in zip(jobs, kinds,
                                                            results):
            same_outputs(name, f"{out}/{tag}.w{W}", f"{out}/{tag}.single",
                         exts)
            log(f"[dist {name}] {len(exts)} files equal the witness's; "
                f"SO CPU Time {solve:.4f} s e2e {e2e:.4f} s (witness "
                f"{witness[tag][0]:.4f} s, {witness[tag][1]:.4f} s; e2e "
                f"from main() in each rank){phase_table(text)}")


def phase_distributed_paths():
    """--distributed's options on the 2^18 box of phase_cli_paths (general
    masses, phi), two ranks sharing cuda:0 over gloo: --deltas 200,340,667
    and -pot against that phase's one-process files, and -pot with
    --checkpoint twice (the second resumes from the two rank shards) with
    the same bytes."""
    paths = os.path.join(HERE, "so_tpu_torch", "_build", "chip_smoke_paths")
    base = ["-i", f"{paths}/cat.gtp", "--tipsy", f"{paths}/snap.bin", "-grp",
            "-gtp", "-all"]
    exts = ("sovcirc", "sogrp", "sogtp", "sodark", "sogas", "sostar")
    need = ("K1", "K1s", "K2")
    ck = f"{paths}/dist_state.npz"
    for r in range(2):
        if os.path.exists(f"{ck}.rank{r}-of-2.npz"):
            os.remove(f"{ck}.rank{r}-of-2.npz")
    runs = ("save", "resume")
    jobs = [("--deltas", base + ["-o", f"{paths}/dist", "--deltas",
                                 ",".join(f"{d:g}" for d in DELTAS)], need)]
    jobs += [(f"-pot --checkpoint {run}",
              base + ["-o", f"{paths}/dist_{run}", "-pot", "--checkpoint",
                      ck, "--verbose"], need) for run in runs]
    results = run_ranks(2, jobs, "cuda:0", "gloo")
    for d in DELTAS:
        same_outputs(f"--deltas {d:g}", f"{paths}/dist.d{d:g}",
                     f"{paths}/multi.d{d:g}", exts)
    log(f"[dist --deltas] W=2: every threshold's files equal the "
        f"one-process CLI's; SO CPU Time {results[0][1]:.4f} s e2e "
        f"{results[0][2]:.4f} s")
    for run, (text, solve, e2e) in zip(runs, results[1:]):
        phase = f"checkpoint {run} (segment)"
        if phase not in text or (run == "resume" and "R_Delta" in text):
            raise AssertionError(f"--checkpoint {run}: not a {run} run")
        same_outputs(f"-pot --checkpoint {run}", f"{paths}/dist_{run}",
                     f"{paths}/pot", exts)
        log(f"[dist -pot --checkpoint {run}] W=2: files equal the "
            f"one-process -pot CLI's; SO CPU Time {solve:.4f} s e2e "
            f"{e2e:.4f} s{phase_table(text)}")


def surface_counted(tag, need, fn, *a, **kw):
    """counted() for one check of the surface phase: also its seconds (to
    the card's synchronize) and its launches."""
    import torch

    t0 = time.perf_counter()
    out = counted(f"surface {tag}", fn, *a, need=need, **kw)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, read_counts()


def lists_agree(tag, ps, centers, got, want):
    """Member lists equal, but for the order of members at equal d2 (the
    shard merge orders a tie by shard, docs/PARITY.md #3). Returns the
    number of lists whose order differs within a tie."""
    import numpy as np

    if len(got) != len(want):
        raise AssertionError(f"{tag}: {len(got)} lists against {len(want)}")
    ties = 0
    for h, (a, b) in enumerate(zip(got, want)):
        if np.array_equal(a, b):
            continue
        if not np.array_equal(np.sort(a), np.sort(b)) or not np.array_equal(
                member_d2(ps, centers[h], a), member_d2(ps, centers[h], b)):
            raise AssertionError(f"{tag}: members of list {h} differ")
        ties += 1
    return ties


def phase_surface(box):
    """so_tpu's library surface beside the CLI, on the card at the
    standard box's size (masses uniform or uniform(0.5, 1.5)/N, velocities
    normal(0, 1), seed SEED + 7):
      - parallel.extract_members_sharded on a 1x2 mesh of the card over
        the solved halos, host_mv rebuilt from the shards, against the
        CellGrid's engine.extract_members (lists equal but for the order
        within equal d2, vcm bit for bit); again with PIECE_K_MIN at 512
        (K3 and sort_in_ball);
      - engine.solver.scan_sorted at (16384, 4096), the sorted hits of
        every halo at the solve's second ladder radius (rung 1 + DK; at
        rung 1 the particle past j* mostly lies outside), capped at the
        99th percentile of those radii (the one level a dispatch takes is
        set by its largest ball, and the largest few would make most
        footprints overflow), both mass kinds, against
        its plain version on CPU copies (found, jstar, mvir, rvir, d2cut
        bit for bit, vcm within the f32 bound of two sums of its n = jstar
        terms in other orders, (n + 2) 2^-23 sum|m v| / Mvir) and against
        solve_rvir: a halo
        that scan finds without overflow has the solve's code 0 (jstar =
        j, Mvir and d2cut bit for bit) or -2 (jstar = nMembers - 2), and
        a code-0 halo whose ball holds its j + 2 nearest is found, which
        must be a quarter of them or more;
      - ops.gather.ragged_ball_gather for the first 4,096 halos at the
        same radii, K = 4096, on "cuda" and on the CPU, both sort modes:
        d2, idx, n_in and overflow bit for bit;
      - cosmology.rhovir_over_rhobar_torch over a 6 x 6 (Omega0, z) grid,
        both fits, on "cuda": in f64 the host scalar to rtol 1e-12, in f32
        to rtol 5e-5 (the f32 form's cancellation in sinh(eta) - eta as
        Omega(z) -> 1); numerics.romberg_torch over 64 intervals against
        dromberg_o (rtol 1e-5)."""
    import numpy as np
    import torch

    from so_tpu_torch.cosmology import (rhovir_over_rhobar,
                                        rhovir_over_rhobar_torch)
    from so_tpu_torch.engine import extract_members, solve_rvir
    from so_tpu_torch.engine.solver import (DK, _pick_level_span,
                                            ladder_radius, rvir_ladder,
                                            scan_sorted)
    from so_tpu_torch.numerics import dromberg_o, romberg_torch
    from so_tpu_torch.ops import gather
    from so_tpu_torch.ops.grid import build_grid
    from so_tpu_torch.parallel import (build_sharded_grid,
                                       extract_members_sharded)

    pos, mass_u, _, centers, rgtp = box
    n = pos.shape[0]
    rng = np.random.default_rng(SEED + 7)
    vel = rng.normal(size=(n, 3)).astype(np.float32)
    mass_g = (rng.uniform(0.5, 1.5, n) / n).astype(np.float32)
    grids = {k: build_grid(pos, m, vel=vel, device="cuda")
             for k, m in (("uniform", mass_u), ("general", mass_g))}
    solves = {k: solve_rvir(g, centers, rgtp, THR) for k, g in grids.items()}

    # extract_members_sharded against the CellGrid's extract_members
    s = solves["uniform"]
    ok = s.code == 0
    args = (centers[ok], s.d2cut[ok], s.j[ok], s.mvir[ok])
    want, want_vcm = extract_members(grids["uniform"], *args,
                                     host_mv=(vel, mass_u))
    mesh = cuda_mesh((1, 2))
    sgrid = build_sharded_grid(pos, mass_u, vel=vel, mesh=mesh)
    keep = gather.PIECE_K_MIN
    for piece_k_min, need in ((keep, ("K1s",)), (512, ("K3",))):
        gather.PIECE_K_MIN = piece_k_min
        try:
            (got, got_vcm), dt, counts = surface_counted(
                "members", need, extract_members_sharded, mesh, sgrid, *args)
        finally:
            gather.PIECE_K_MIN = keep
        if got_vcm.tobytes() != want_vcm.tobytes():
            raise AssertionError("surface: vcm differs from the CellGrid's")
        ties = lists_agree("surface members", types.SimpleNamespace(pos=pos),
                           centers[ok], got, want)
        log(f"[surface] extract_members_sharded 1x2, PIECE_K_MIN "
            f"{piece_k_min}: {len(got)} lists ({sum(x.size for x in got)} "
            f"members) equal the CellGrid's, {ties} in another order within "
            f"equal d2; vcm bit for bit; {dt:.3f} s; launches {counts}")

    # scan_sorted at (16384, 4096), and ragged_ball_gather at its radii
    kmax, _ = rvir_ladder(rgtp, grids["uniform"].period_np())
    radii = ladder_radius(rgtp, np.minimum(1 + DK, kmax))
    radii = np.minimum(radii, np.float32(np.quantile(radii, 0.99)))
    level, S = _pick_level_span(grids["uniform"], float(radii.max()))
    c = torch.as_tensor(centers, device="cuda")
    r = torch.as_tensor(radii, device="cuda")
    K = 4096
    for kind, g in grids.items():
        sg = gather.slab_gather(g, level, c, r, r * r, K, S, ("mass", "idx"))
        idx = sg.channels[1]
        vel_s = torch.where((idx >= 0)[..., None],
                            g.vel_a()[idx.clamp(min=0).long()], 0.0)
        inputs = (sg.d2, sg.channels[0], vel_s, sg.n_in)
        um = g.uniform_mass
        out, dt, counts = surface_counted(
            f"scan {kind}", () if um is not None else ("K2",), scan_sorted,
            *inputs, THR, 8, uniform_m=um)
        plain = scan_sorted(*(t.cpu() for t in inputs), THR, 8,
                            uniform_m=um)
        for f in ("found", "jstar", "mvir", "rvir", "d2cut"):
            assert_same_bits(f"surface scan {kind} {f}", out[f].cpu(),
                             plain[f])
        found = plain["found"].numpy()
        # two f32 sums of the same n = jstar terms in any orders differ by
        # at most (n + 2) 2^-23 sum|m v| after the quotient by Mvir
        n = out["jstar"][:, None].double()
        slot = torch.arange(K, device="cuda")[None, :]
        absum = (torch.where(slot < n, inputs[1].double(), 0.0)[:, :, None]
                 * vel_s.double().abs()).sum(dim=1)
        bound = ((n + 2) * 2.0 ** -23 * absum
                 / out["mvir"][:, None]).cpu().numpy()[found]
        diff = np.abs(out["vcm"].cpu().numpy() - plain["vcm"].numpy())[found]
        vcm_err = float((diff / bound).max())
        if not vcm_err <= 1.0:
            raise AssertionError(f"surface scan {kind}: vcm at {vcm_err} of "
                                 "its f32 summation bound")
        del absum
        sv = solves[kind]
        ovf = sg.overflow.cpu().numpy()
        n_in = sg.n_in.cpu().numpy()
        jstar = plain["jstar"].numpy()
        hit = found & ~ovf
        if not np.isin(sv.code[hit], (0, -2)).all():
            raise AssertionError(f"surface scan {kind}: a found halo's "
                                 "solve code is not 0 or -2")
        m2 = hit & (sv.code == -2)
        solved = hit & (sv.code == 0)
        if (jstar[m2] != 6).any() or (jstar[solved] != sv.j[solved]).any():
            raise AssertionError(f"surface scan {kind}: jstar is not the "
                                 "solve's")
        for f in ("mvir", "d2cut"):
            a = plain[f].numpy()[solved]
            if a.tobytes() != getattr(sv, f)[solved].tobytes():
                raise AssertionError(f"surface scan {kind}: {f} is not the "
                                     "solve's")
        reach = (sv.code == 0) & ~ovf & (n_in > sv.j + 1)
        if not found[reach].all():
            raise AssertionError(f"surface scan {kind}: a solved halo whose "
                                 "ball holds its j + 2 nearest is not found")
        if 4 * solved.sum() < (sv.code == 0).sum():
            raise AssertionError(f"surface scan {kind}: {int(solved.sum())} "
                                 "solved halos found")
        log(f"[surface] scan_sorted ({c.shape[0]}, {K}) {kind}: card = plain "
            f"(found/jstar/mvir/rvir/d2cut bit for bit, vcm at most "
            f"{vcm_err:.3g} of its f32 summation bound); "
            f"{int(solved.sum())} found halos equal "
            f"solve_rvir's code 0, {int(m2.sum())} its -2, "
            f"{int(ovf.sum())} overflowed; {dt:.3f} s; launches {counts}")
        del sg, idx, vel_s, inputs, out, plain

    B = 4096
    cpu_grid = build_grid(pos, mass_u, device="cpu")
    for sort in (False, True):
        got, dt, counts = surface_counted(
            "ragged", (), gather.ragged_ball_gather, grids["uniform"], level,
            c[:B], r[:B], r[:B] * r[:B], K, S, sort=sort)
        cr = torch.as_tensor(radii[:B])
        want = gather.ragged_ball_gather(cpu_grid, level,
                                         torch.as_tensor(centers[:B]), cr,
                                         cr * cr, K, S, sort=sort)
        for f, a, b in zip(got._fields, got, want):
            assert_same_bits(f"surface ragged {f}", a.cpu(), b)
        log(f"[surface] ragged_ball_gather ({want.n_in.shape[0]}, {K}) "
            f"sort={sort}: cuda = "
            f"cpu bit for bit (d2, idx, n_in, overflow); "
            f"{int(want.n_in.sum())} hits, {int(want.overflow.sum())} "
            f"overflowed; {dt:.3f} s; launches {counts}")
    del cpu_grid

    t0 = time.perf_counter()
    om, z = np.meshgrid([0.1, 0.2, 0.3, 0.5, 0.9, 1.0],
                        [0.0, 0.5, 1.0, 2.0, 3.0, 6.0])
    worst = {}
    for lam in (False, True):
        host = np.vectorize(lambda o, zz: rhovir_over_rhobar(o, lam, zz))(
            om, z)
        for dtype, rtol in ((torch.float64, 1e-12), (torch.float32, 5e-5)):
            got = rhovir_over_rhobar_torch(om, lam, z, dtype=dtype,
                                           device="cuda").cpu().numpy()
            err = float(np.max(np.abs(got - host) / host))
            if not err <= rtol or got.dtype != np.dtype(str(dtype)[6:]):
                raise AssertionError(f"surface Delta_vir lambda={lam} "
                                     f"{dtype}: rel err {err}")
            worst[(lam, str(dtype)[6:])] = err
    a = np.linspace(0.0, 2.0, 64)
    b = a + np.linspace(0.5, 3.0, 64)
    got = romberg_torch(lambda x: torch.exp(-x) * torch.sin(x), a, b,
                        eps=1e-6, device="cuda").cpu().numpy()
    host = np.array([dromberg_o(lambda x: np.exp(-x) * np.sin(x), x, y,
                                1e-10) for x, y in zip(a, b)])
    r_err = float(np.max(np.abs(got - host) / np.abs(host)))
    if not r_err <= 1e-5:
        raise AssertionError(f"surface romberg_torch: rel err {r_err}")
    log(f"[surface] rhovir_over_rhobar_torch 6x6 (Omega0, z) on cuda against "
        f"the host scalar, max rel err "
        + ", ".join(f"lambda={k[0]} {k[1]} {v:.3g}" for k, v in worst.items())
        + f"; romberg_torch 64 intervals rel err {r_err:.3g}; "
        f"{time.perf_counter() - t0:.3f} s; launches none (plain torch)")


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
    if len(sys.argv) > 1:
        sys.stderr.write("usage: python3 chip_smoke.py (no arguments)\n")
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
    k1 = timed("kernels", phase_kernels, box)
    cr = timed("cell ranges", phase_ranges, box)
    k2 = timed("K2 ladder", phase_k2)
    giant = timed("giant box", giant_config)
    k3 = timed("K3 kernel", phase_k3, giant)
    counts = timed("main path", phase_main_path, box)
    for k, v in counts.items():
        LAUNCHES[k] += v
    small = make_box(np.random.default_rng(SEED), 1 << 18, 2048)
    timed("gpu vs cpu", phase_gpu_vs_cpu, small)
    timed("cli", phase_cli, small)
    timed("goldens", phase_goldens)
    timed("-pot", counted, "-pot", phase_pot, box, small)
    timed("--deltas", counted, "--deltas", phase_multi, box)
    timed("--mesh", phase_mesh, box)
    timed("--distributed", phase_distributed, box)
    timed("surface", phase_surface, box)
    del box
    dense = timed("dense box", make_dense_box)
    timed("--survey", counted, "--survey", phase_survey, dense)
    timed("survey classify vs cpu", phase_survey_vs_cpu, dense)
    del dense
    timed("cli paths", counted, "cli paths", phase_cli_paths, small)
    timed("--distributed 2^18", phase_distributed_paths)
    timed("giant", phase_giant, giant)
    del giant
    timed("giant vs cpu", phase_giant_vs_cpu)
    timed("so_tpu at scale", phase_at_scale)
    timed("512^3", phase_512)
    timed("survey box", phase_survey_box)
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "so_tpu", "bench")]
    if bad:
        raise AssertionError(f"imported from the JAX side: {bad}")

    kernels = [
        dict(name="slab_gather", route="cuda",
             source="so_tpu_torch/csrc/slab_gather.cu",
             replaces="so_tpu/ops/pallas_gather.py:325",
             launches=LAUNCHES["K1"], sorted_launches=LAUNCHES["K1s"],
             **k1),
        dict(name="seqsum", route="cuda",
             source="so_tpu_torch/csrc/seqsum.cu",
             replaces="so_tpu/ops/seqsum.py:18",
             launches=LAUNCHES["K2"], **k2),
        dict(name="piece_gather", route="cuda",
             source="so_tpu_torch/csrc/piece_gather.cu",
             replaces="experiments/pallas_piece_dma.py:176",
             launches=LAUNCHES["K3"], **k3),
        dict(name="cell_ranges", route="cuda",
             source="so_tpu_torch/csrc/cell_ranges.cu",
             replaces="so_tpu/ops/gather.py:59 (XLA ops, no Pallas kernel)",
             launches=LAUNCHES["ranges"], **cr),
    ]
    log("[K2] launches per (B, K) over the counted paths: "
        + ", ".join(f"({b}, {k}): {n}" for (b, k), n in sorted(
            K2_SHAPES.items())))
    log(f"[done] {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
