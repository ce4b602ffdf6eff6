#!/usr/bin/env python3
"""The measurement behind solver.WBOX_K_MIN, the capacity above which a
uniform-mass grid's solve takes the whole-box stage, on one CUDA card. Not
part of the smoke run.

    python3 wbox_study.py [--runs R] [--skip-probe]   (from a checkout's root)

On two boxes, chip_smoke.py's uniform giant box (giant_config, masses 1/N)
and its 512^3 box (make_box(default_rng(12345), 512**3, 65536)), it
builds the grid on the card once and runs solve_rvir at Delta 178 (the
survey auto-gate on, as run_so calls it) with WBOX_K_MIN at 2^15, 2^18,
2^21 and off, in turns: one cold round (off first), then R warm rounds
(default 3), each round in another order. A solve still running after
LIMIT_X times the cold gather-only solve (at least LIMIT_MIN seconds) is
stopped at its next whole-box dispatch: that setting is out of the box's
warm rounds and of the choice, its cold time given as "> limit". Every
run that ends must give the first run's codes, Mvir, Rvir, j and d2cut
bit for bit. It prints, for each box and setting, the cold and warm solve
seconds (median and range), the whole-box dispatches and the K1/K3
launches of a run, and the halos at each final capacity in the
gather-only run; then each setting's summed median over the boxes (a
setting stopped on a box has no sum) and the setting with the lowest
sum.

Then, unless --skip-probe, on chip_smoke.py's survey box
(make_box(default_rng(12345), 2**25, 1_000_000)): one solve, and the
footprint probe of the fused pass (engine/derived.probe_capacities) over
its solved halos' 2*Rvir balls, run as one call (FOOTPRINT_PAIRS past
every halo) and in chunks of 2^26 (halo, cell) pairs: the capacities must
be equal, and each form's peak device memory above the memory held
before it (torch.cuda.max_memory_allocated) is printed.

The last line of its output holds the readings as one JSON object.
"""

import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SETTINGS = (("off", None), ("2^21", 1 << 21), ("2^18", 1 << 18),
            ("2^15", 1 << 15))
LIMIT_X = 5        # a solve stops after LIMIT_X x the cold gather-only one
LIMIT_MIN = 10.0   # seconds, at least




class TooSlow(Exception):
    pass


FIELDS = ("code", "mvir", "rvir", "j", "d2cut")


def log(msg):
    print(msg, flush=True)


def solve_once(grid, centers, rgtp, wk, limit):
    """(result, seconds, counts); raises TooSlow once ``limit`` seconds
    have passed at a whole-box dispatch."""
    import torch

    from so_tpu_torch.engine import multi, solver
    from so_tpu_torch.ops import piece_gather, slab_gather

    stage = multi._whole_box_stage

    def bounded(*a):
        if time.perf_counter() - t0 > limit:
            raise TooSlow(solver.wbox_dispatches - n0[0])
        return stage(*a)

    solver.WBOX_K_MIN = wk
    multi._whole_box_stage = bounded
    n0 = (solver.wbox_dispatches, slab_gather.launches, piece_gather.launches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        r = solver.solve_rvir(grid, centers, rgtp, 178.0)
    finally:
        multi._whole_box_stage = stage
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = [b - a for a, b in zip(n0, (solver.wbox_dispatches,
                                         slab_gather.launches,
                                         piece_gather.launches))]
    return r, sec, dict(zip(("wbox", "K1", "K3"), counts))


def study_box(tag, pos, mass, centers, rgtp, runs):
    import numpy as np
    import torch

    from so_tpu_torch.engine import solver
    from so_tpu_torch.ops.grid import build_grid

    t0 = time.perf_counter()
    grid = build_grid(pos, mass, device="cuda")
    torch.cuda.synchronize()
    log(f"[{tag}] particles={pos.shape[0]} halos={centers.shape[0]} grid "
        f"build {time.perf_counter() - t0:.3f} s, uniform mass "
        f"{grid.uniform_mass}")
    wk0 = solver.WBOX_K_MIN
    ref = None
    rows = {name: dict(warm=[]) for name, _ in SETTINGS}
    limit = float("inf")
    try:
        for rnd in range(1 + runs):
            k = rnd % len(SETTINGS)
            for name, wk in SETTINGS[k:] + SETTINGS[:k]:
                row = rows[name]
                if row.get("stopped"):
                    continue
                try:
                    r, sec, counts = solve_once(grid, centers, rgtp, wk,
                                                limit)
                except TooSlow as e:
                    row.update(stopped=True, cold=f"> {limit:.1f}",
                               wbox=f"> {e.args[0]}")
                    log(f"[{tag} cold] WBOX_K_MIN {name}: stopped after "
                        f"{limit:.1f} s, at whole-box dispatch {e.args[0]}")
                    continue
                if ref is None:
                    ref = r
                    limit = max(LIMIT_MIN, LIMIT_X * sec)
                for f in FIELDS:
                    a, b = getattr(r, f), getattr(ref, f)
                    if a.tobytes() != b.tobytes():
                        raise AssertionError(f"{tag} {name}: {f} differs")
                if rnd == 0:
                    row.update(cold=sec, **counts)
                    if wk is None:
                        kc = r.kcap
                        row["kcap_hist"] = {
                            f"2^{int(np.log2(v))}": int((kc == v).sum())
                            for v in np.unique(kc)}
                else:
                    row["warm"].append(sec)
                log(f"[{tag} {'cold' if rnd == 0 else f'warm {rnd}'}] "
                    f"WBOX_K_MIN {name}: solve {sec:.4f} s, whole-box "
                    f"dispatches {counts['wbox']}, K1 {counts['K1']}, K3 "
                    f"{counts['K3']}")
    finally:
        solver.WBOX_K_MIN = wk0
    codes = np.bincount(-ref.code[ref.code <= 0], minlength=4).tolist()
    log(f"[{tag}] ok/-1/-2/-3={codes}; every run bit-identical "
        "(code, Mvir, Rvir, j, d2cut)")
    for name, _ in SETTINGS:
        row = rows[name]
        if row.get("stopped"):
            log(f"[{tag}] WBOX_K_MIN {name}: stopped, cold {row['cold']} s")
            continue
        row["median"] = statistics.median(row["warm"])
        log(f"[{tag}] WBOX_K_MIN {name}: warm median {row['median']:.4f} s "
            f"(range {min(row['warm']):.4f}-{max(row['warm']):.4f}, "
            f"{len(row['warm'])} runs), cold {row['cold']:.4f} s, whole-box "
            f"dispatches {row['wbox']}, K1 {row['K1']}, K3 {row['K3']}"
            + (f"; halos by final capacity {row['kcap_hist']}"
               if "kcap_hist" in row else ""))
    del grid
    torch.cuda.empty_cache()
    return dict(codes=codes, settings=rows)


def probe_peaks(box):
    import numpy as np
    import torch

    from so_tpu_torch.engine import derived, solver
    from so_tpu_torch.ops.grid import build_grid

    pos, mass, _, centers, rgtp = box
    grid = build_grid(pos, mass, device="cuda")
    t0 = time.perf_counter()
    s = solver.solve_rvir(grid, centers, rgtp, 178.0)
    log(f"[probe] survey box: particles={pos.shape[0]} halos="
        f"{centers.shape[0]}, solve {time.perf_counter() - t0:.3f} s")
    ok = np.nonzero(s.code == 0)[0]
    fball = (np.float32(2.0) * s.rvir).astype(np.float32)
    out, caps = {}, {}
    for name, pairs in (("one call", 1 << 62), ("chunked 2^26", 1 << 26)):
        derived.FOOTPRINT_PAIRS = pairs
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        caps[name] = derived.probe_capacities(grid, centers, fball, ok)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        out[name] = dict(peak_gib=peak / 2**30, seconds=sec)
        log(f"[probe] {name}: {ok.size} halos, peak device memory above "
            f"the grid {peak / 2**30:.3f} GiB, {sec:.3f} s")
    derived.FOOTPRINT_PAIRS = 1 << 26
    if not np.array_equal(caps["one call"], caps["chunked 2^26"]):
        raise AssertionError("the chunked probe's capacities differ")
    log("[probe] capacities identical")
    return dict(halos=int(ok.size), **out)


def main():
    if not os.path.isdir(os.path.join(HERE, "so_tpu_torch")):
        sys.stderr.write("run it from the root of a checkout\n")
        return 2
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        sys.stderr.write("wbox_study.py: torch sees no CUDA device\n")
        return 2
    runs = 3
    args = sys.argv[1:]
    if "--runs" in args:
        runs = int(args[args.index("--runs") + 1])
    card = cs.phase_env()
    cs.phase_build()
    out = dict(card=card, runs=runs, boxes={})

    giant = cs.giant_config()
    mass_u = dict(giant["masses"])["uniform"]
    out["boxes"]["giant"] = study_box("giant", giant["pos"], mass_u,
                                      giant["centers"], giant["rgtp"], runs)
    del giant, mass_u
    t0 = time.perf_counter()
    pos, mass, _, centers, rgtp = cs.make_box(np.random.default_rng(12345),
                                              512 ** 3, 65536)
    log(f"[512^3] make_box {time.perf_counter() - t0:.1f} s")
    out["boxes"]["512^3"] = study_box("512^3", pos, mass, centers, rgtp,
                                      runs)
    del pos, mass, centers, rgtp

    sums = {name: sum(b["settings"][name]["median"]
                      for b in out["boxes"].values()) for name, _ in SETTINGS
            if all("median" in b["settings"][name]
                   for b in out["boxes"].values())}
    best = min(sums, key=sums.get)
    log("[sum] summed warm medians: " + ", ".join(
        f"{k} {v:.4f} s" for k, v in sums.items()) + f"; lowest: {best}")
    out.update(sums=sums, best=best)

    if "--skip-probe" not in args:
        t0 = time.perf_counter()
        box = cs.make_box(np.random.default_rng(12345), 2 ** 25, 1_000_000)
        log(f"[probe] make_box {time.perf_counter() - t0:.1f} s")
        out["probe"] = probe_peaks(box)

    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
