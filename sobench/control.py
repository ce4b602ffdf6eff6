"""Readings that the check's limits are set from (not run by the
benchmark's own runs).

For each seed: the cell's snapshots, one job on each (the window's entry
at the cell's own size), and the check's readings of the program against
the reference. For the control seeds, also the control: the reference
one precision below what the program states, put in the program's place
on the same halos and held to the reference. The solve, members and
derived quantities (f32) in bfloat16 (positions, distances and masses);
the group mean velocity's float64 sum in float32, over the reference's
member lists; the conflict pass (f32 center distances) in bfloat16, over
the job's solve and members where the check walks the program's, over the
control's own solve where it walks the reference's; the stats (f64 sums)
in float32.

    python3 sobench/control.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 1,2,3

Prints one JSON line a seed and, last, the largest program readings and
the smallest control readings.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from sobench import check as ck  # noqa: E402
from sobench import harness  # noqa: E402
from sobench.reference import so_reference as ref  # noqa: E402

CONTROL_DTYPE = torch.bfloat16


def control_readings(cell, runs, snap, halos, device) -> dict:
    """The control's readings on ``halos`` of ``snap`` (None: every halo,
    as the check's whole job) against the f32 reference."""
    mix = cell.mix
    species = harness.species_of(mix)
    n_members = int(mix.get("n_members", 8))
    period = cell.config["period"]
    rows = np.arange(snap.n_halos) if halos is None else halos
    out = ck.empty()
    for run, thr in zip(runs, (float(t) for t in mix["thresholds"])):
        ps = ck.reference_particles(snap, period, device)
        want = ref.solve_halos(ps, snap.centers[rows], snap.rgtp[rows], thr,
                               n_members, species)
        del ps
        pc = ck.reference_particles(snap, period, device, CONTROL_DTYPE)
        got = ref.solve_halos(pc, snap.centers[rows], snap.rgtp[rows], thr,
                              n_members, species)
        del pc
        for g, w in zip(got, want):
            sb, mb, _, de = ck.compare_halo(g, w, w.code == 0, species)
            out["solve_diff"] += sb
            out["member_diff"] += mb
            out["derived_err"] = max(out["derived_err"], de)
            if w.code == 0:
                low = ref.vcm_of(w.members, snap.vel, snap.mass, w.mvir,
                                 np.float32)
                out["vcm_diff"] += int(not np.array_equal(
                    ck.bits(low), ck.bits(w.vcm)))
        if halos is None:
            rc = ck.walk_of(want, snap)
            low = ck.walk_of(got, snap, ref.round_bf16)
        else:
            rc = ck.reference_conflicts(run, snap)
            low = ck.reference_conflicts(run, snap, ref.round_bf16)
        out["conflict_diff"] += ck.conflict_diff(low, rc)
        out["stats_err"] = max(out["stats_err"], ck.stats_err(
            ref.stats(snap.mass, rc, np.float32), ref.stats(snap.mass, rc)))
    return out


def readings_for_seed(cell, seed: int, with_control: bool,
                      device: str) -> dict:
    gen = harness.load_module(cell.root / "sobench" / "gen"
                              / f"{cell.config['generator']}.py")
    mix = cell.mix
    snaps = [gen.snapshot(cell.config, mix, (int(seed) << 4) + i, device)
             for i in range(int(mix["snapshots"]))]
    jobs = []
    t0 = time.perf_counter()
    for i, s in enumerate(snaps):
        jobs.append((i, harness.run_job(harness.Inputs(s), cell, device)))
    t_jobs = time.perf_counter() - t0
    t0 = time.perf_counter()
    prog = ck.check_window(jobs, snaps, [float(t) for t in mix["thresholds"]],
                           harness.species_of(mix),
                           int(mix.get("n_members", 8)),
                           cell.config["period"], mix["check"], seed, device)
    t_check = time.perf_counter() - t0
    out = dict(seed=seed, jobs_s=t_jobs, check_s=t_check, program=prog)
    if with_control:
        t0 = time.perf_counter()
        ctl = ck.empty()
        for runs, snap, halos in ck.plan(jobs, snaps, mix["check"], seed):
            ctl = ck.merge(ctl, control_readings(cell, runs, snap, halos,
                                                 device))
        out["control"] = ctl
        out["control_s"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="sobench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    a = ap.parse_args(argv)
    cell = harness.load_cell(a.workload)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    ctl_seeds = {int(s) for s in a.control_seeds.split(",") if s}
    lows, highs = {}, {}
    for seed in (int(s) for s in a.seeds.split(",")):
        r = readings_for_seed(cell, seed, seed in ctl_seeds, "cuda")
        print(json.dumps(r), flush=True)
        for k, v in r["program"].items():
            lows[k] = max(lows.get(k, v), v)
        for k, v in r.get("control", {}).items():
            highs[k] = min(highs.get(k, v), v)
    print(json.dumps({"workload": a.workload, "lower": lows,
                      "upper": highs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
