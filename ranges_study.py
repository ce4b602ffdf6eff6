#!/usr/bin/env python3
"""The measurements behind the cell-enumeration kernel
(so_tpu_torch/csrc/cell_ranges.cu), on one CUDA card. Not part of the
smoke run.

    python3 ranges_study.py [--parent DIR] [--jobs N] [--seed S]
                            (from the root of a checkout)

1. On a box made as chip_smoke.py's standard box (2^21 particles, 16,384
   halos) from --seed, at chip_smoke.ranges_shapes' shapes (16,384 halos
   at the first ladder rung, K = 4096: K1's sorted form; the 8 largest
   halos at S = 7, K = 2^21: K3): the kernel (ops/ranges.slab_ranges)
   against the plain route it replaced (cell_ranges_plain and the
   descriptors in torch ops) on the card, equal where the plain version
   defines them (chip_smoke.ranges_case); for each side its ms by CUDA
   events around the calls, its device ms by one CUDA graph of the calls
   replayed, its host ms (the calls' enqueue, no sync), and the device
   ops of one call (torch.profiler); for the kernel the bytes it must
   move (chip_smoke.ranges_bytes) and their time at 3.35 TB/s.
2. With --parent DIR (a checkout of the parent commit, for example
   `git archive <commit> | tar -x -C DIR` into a git-ignored directory):
   sobench's box512.uniform (the cell's first snapshot from --seed, its
   warm-up), one process a tree, in turns (parent, this tree, this tree,
   parent): the untraced span totals a job of the solve's spans
   (solve.ranges among them), the job's wall seconds and the enumeration
   counts a job, over --jobs jobs.

The last line of its output holds the readings as one JSON object.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = os.path.dirname(os.path.abspath(__file__))
SOLVE_SPANS = ("solve.ranges", "solve.gather", "solve.sort", "solve.scan",
               "solve.fetch", "solve.apply", "solve.plan", "R_Delta solve")


def log(msg):
    print(msg, flush=True)


def host_ms(fn, reps):
    """Mean host milliseconds a call of the enqueue alone (no sync inside
    the timed loop; after one warm call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * t / reps


def device_ops(fn):
    """The device ops (kernels, copies, sets) one call runs."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def phase_shapes(seed):
    import numpy as np
    import torch

    import chip_smoke
    from so_tpu_torch.ops import ranges
    from so_tpu_torch.ops.grid import build_grid

    box = chip_smoke.make_box(np.random.default_rng(seed), 1 << 21, 16384)
    grid = build_grid(*box[:2], vel=box[2], device="cuda")
    rows = []
    for tag, level, S, c, r, K in chip_smoke.ranges_shapes(box, grid, seed):
        rec = chip_smoke.ranges_case(grid, level, S, c, r, K, tag)
        kernel = rec["shape"].split()[-1]
        args = (grid, level, c, r, r * r, S, grid.chunk, K, kernel)

        def kern():
            return ranges.slab_ranges(*args)

        def plain():
            return ranges.slab_ranges_plain(*args)

        rec.update(
            B=c.shape[0], S=S, level=level, K=K, kernel=kernel,
            chunk=grid.chunk, host_ms=host_ms(kern, 50),
            ops=device_ops(kern),
            plain_device_ms=chip_smoke.graph_ms(plain, 10),
            plain_host_ms=host_ms(plain, 10), plain_ops=device_ops(plain))
        log(f"[ranges] {tag}: kernel host {rec['host_ms']:.4f} ms, "
            f"{rec['ops']} device op(s) a call; plain "
            f"{rec['plain_device_ms']:.4f} ms (graph) host "
            f"{rec['plain_host_ms']:.4f} ms, {rec['plain_ops']} device ops a "
            f"call")
        rows.append(rec)
        torch.cuda.empty_cache()
    return rows


def worker(root, seed, jobs):
    """One tree's box512.uniform jobs: the span totals, walls and counts
    a job, as one JSON line."""
    sys.path.insert(0, root)
    import torch

    from sobench import harness
    from so_tpu_torch import profiling
    from so_tpu_torch.ops import _cuda

    cell = harness.load_cell("box512.uniform", Path(root))
    _cuda.library()
    gen = harness.load_module(cell.root / "sobench" / "gen"
                              / f"{cell.config['generator']}.py")
    inp = harness.Inputs(gen.snapshot(cell.config, cell.mix, seed << 4,
                                      "cuda"))
    harness.warm_up([inp], cell, "cuda", seed)
    torch.cuda.synchronize()
    totals, counts = dict(profiling.totals), dict(profiling.counts)
    walls = []
    for _ in range(jobs):
        t0 = time.perf_counter()
        harness.run_job(inp, cell, "cuda")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    spans = {n: (profiling.totals.get((n, "ns"), 0)
                 - totals.get((n, "ns"), 0)) / 1e9 / jobs
             for n in SOLVE_SPANS}
    added = {k[0]: (v - counts.get(k, 0)) / jobs
             for k, v in profiling.counts.items()
             if k[0].startswith(("ranges.", "solve.dispatches"))}
    print(json.dumps(dict(root=root, walls=walls, spans=spans,
                          counts=added)), flush=True)


def phase_parent(parent, seed, jobs):
    rows = []
    for root in (parent, HERE, HERE, parent):
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--worker", os.path.abspath(root), "--seed",
                            str(seed), "--jobs", str(jobs)],
                           stdout=subprocess.PIPE, text=True, check=True)
        rec = json.loads(p.stdout.strip().splitlines()[-1])
        rec["side"] = "parent" if root == parent else "change"
        log(f"[spans] {rec['side']}: job walls "
            + ", ".join(f"{w:.3f}" for w in rec["walls"]) + " s; a job: "
            + ", ".join(f"{n} {v:.3f} s" for n, v in rec["spans"].items())
            + "; counts a job " + json.dumps(rec["counts"]))
        rows.append(rec)
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent")
    ap.add_argument("--worker")
    ap.add_argument("--seed", type=int, default=1919)
    ap.add_argument("--jobs", type=int, default=2)
    a = ap.parse_args()
    if a.worker:
        return worker(a.worker, a.seed, a.jobs)
    sys.path.insert(0, HERE)
    import subprocess as sp

    card = sp.run(["nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader"], stdout=sp.PIPE,
                  text=True).stdout.strip()
    log(f"[env] {card}")
    out = dict(card=card, shapes=phase_shapes(a.seed))
    if a.parent:
        out["spans"] = phase_parent(a.parent, a.seed, a.jobs)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
