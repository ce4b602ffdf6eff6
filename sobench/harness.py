"""One run of one cell: set-up, the measured window, the check, the
result line.

Everything that belongs to one configuration, traffic mix or metric is
found by its name in BENCHMARK.json:

- the configuration: its ``file`` (sizes, generator, period, source);
- the traffic mix: ``sobench/traffic/<traffic>.json``;
- the generator: ``sobench/gen/<config["generator"]>.py``, whose
  ``snapshot(config, mix, seed, device)`` makes one snapshot;
- each metric, end-to-end or per-layer: ``sobench/metrics/<name>.py``,
  whose ``read(record)`` returns a number or None (nothing to read); a
  per-layer module may also define ``install(notes)``, run before a traced
  window, returning an undo callable. A metric split by the end-to-end
  metric it moves, ``<base>.<part>``, reads as ``<base>`` unless it has a
  file of its own;
- the limits of the check: ``sobench/limits/<workload>.json``.

A job is one call of the mix's entry (``run_so``, or ``run_so_multi``
over the mix's thresholds) on fresh input objects, with no prebuilt grid.
Jobs cycle through the mix's snapshots, so no job sees the inputs of the
one before. The window runs whole jobs back to back: at least one, and no
job starts once the elapsed time plus the previous job's time would pass
``seconds``.

Every run has this window, untraced; the host-clock, span and counter
metrics read it, in a traced run too, so the profiler's cost is in none
of them. A traced run then runs the mix's ``trace.jobs`` more jobs under
torch.profiler, with spans around the layer entries, for the
device-trace metrics, ``busy_s``, ``window_s`` and the breakdown.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "so_tpu")


def forbidden_modules(names=None) -> list:
    """Top-level names in ``names`` (default sys.modules) that the
    benchmark must not load, compared whole: so_tpu_torch is not so_tpu."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: list        # metric entries of BENCHMARK.json
    per_layer: list
    root: Path


def _for_cell(metrics: list, cell: str) -> list:
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    spec = json.loads((root / "BENCHMARK.json").read_text())
    wl = {w["name"]: w for w in spec["workloads"]}
    if name not in wl:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(wl)}")
    w = wl[name]
    cfg = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((root / cfg["file"]).read_text())
    mix = json.loads((root / "sobench" / "traffic"
                      / f"{w['traffic']}.json").read_text())
    limits = json.loads((root / "sobench" / "limits"
                         / f"{name}.json").read_text())["limits"]
    return Cell(name, int(w["chips"]), config, mix, limits,
                _for_cell(spec["end_to_end"], name),
                _for_cell(spec["per_layer"], name), root)


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "sobench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod     # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


def metric_module(cell: Cell, name: str):
    folder = cell.root / "sobench" / "metrics"
    path = folder / f"{name}.py"
    return load_module(path if path.exists()
                       else folder / f"{name.split('.')[0]}.py")


# --------------------------------------------------------------------------
# The program's launch counters (module globals, zeroed before each job)
# --------------------------------------------------------------------------

def counters_of(cell: Cell) -> dict:
    return json.loads((cell.root / "sobench" / "counters.json").read_text())


def spans_of(cell: Cell) -> list:
    return json.loads((cell.root / "sobench" / "spans.json").read_text())


def zero_counters(counters: dict) -> None:
    for mod_name, attr in counters.values():
        mod = sys.modules.get(mod_name)
        v = getattr(mod, attr, None)
        if isinstance(v, int):
            setattr(mod, attr, 0)
        elif hasattr(v, "clear"):
            v.clear()


def read_counters(counters: dict) -> dict:
    out = {}
    for key, (mod_name, attr) in counters.items():
        v = getattr(sys.modules.get(mod_name), attr, None)
        out[key] = (v if isinstance(v, int) or v is None
                    else [[list(k), n] for k, n in sorted(v.items())])
    return out


# --------------------------------------------------------------------------
# Set-up and jobs
# --------------------------------------------------------------------------

class Inputs:
    """One snapshot as the entry takes it; fresh objects for every job."""

    def __init__(self, snap):
        import numpy as np

        self.snap = snap
        self.zeros = np.zeros(snap.n, np.float32)    # phi, temp: not read

    def particles(self):
        from so_tpu_torch.io.tipsy import ParticleSet, TipsyHeader

        s = self.snap
        hdr = TipsyHeader(time=1.0, nbodies=s.n, ndim=3, nsph=s.split[0],
                          ndark=s.split[1], nstar=s.split[2])
        return ParticleSet(hdr, s.pos, s.vel, s.mass, self.zeros, self.zeros)

    def catalog(self, rows=None):
        import numpy as np

        from so_tpu_torch.io.catalogs import GroupCatalog

        s = self.snap
        rows = np.arange(s.n_halos) if rows is None else rows
        return GroupCatalog(index=np.arange(1, rows.size + 1, dtype=np.int32),
                            pos=s.centers[rows].copy(), rgtp=s.rgtp[rows],
                            gtp_mass=s.gtp_mass[rows], n_in_gtp=rows.size,
                            gtp_time=1.0)


def species_of(mix: dict) -> tuple:
    from so_tpu_torch.io import tipsy

    return tuple(getattr(tipsy, s) for s in mix.get("species", []))


def run_job(inputs: Inputs, cell: Cell, device: str, rows=None) -> list:
    """One job: the mix's entry on fresh inputs; one SORun a threshold."""
    from so_tpu_torch.engine import pipeline

    mix, cfg = cell.mix, cell.config
    params = pipeline.SOParams(
        threshold=float(mix["thresholds"][0]),
        n_members=int(mix.get("n_members", 8)),
        period=tuple(cfg["period"]), species=species_of(mix),
        survey=mix.get("survey"), device=device)
    if mix["entry"] == "run_so":
        return [pipeline.run_so(inputs.particles(), inputs.catalog(rows),
                                params)]
    if mix["entry"] == "run_so_multi":
        return pipeline.run_so_multi(inputs.particles(), inputs.catalog(rows),
                                     params, list(mix["thresholds"]))
    raise ValueError(f"unknown entry {mix['entry']!r}")


def warm_up(inputs: list, cell: Cell, device: str, seed: int) -> None:
    """The mix's warm-up: ``jobs`` whole jobs on each snapshot, or one job
    on the first snapshot with a reduced catalog that keeps its ``largest``
    clumps (every tier's kernels and the allocator's largest blocks run)
    and ``random`` more drawn from the seed."""
    import numpy as np

    from .check import seed_rng

    w = cell.mix["warmup"]
    if w.get("jobs"):
        for inp in inputs:
            for _ in range(int(w["jobs"])):
                run_job(inp, cell, device)
        return
    rng = seed_rng(seed, 2)
    snap = inputs[0].snap
    big = np.argsort(snap.rgtp, kind="stable")[::-1][:int(w["largest"])]
    some = rng.choice(snap.n_halos, size=min(int(w["random"]), snap.n_halos),
                      replace=False)
    run_job(inputs[0], cell, device, np.unique(np.concatenate([big, some])))


def power_limit() -> str | None:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 \
        and r.stdout.strip() else None


def _sync(device: str) -> None:
    import torch

    if device.startswith("cuda"):
        torch.cuda.synchronize()


def _reset_peak(device: str) -> None:
    import torch

    if device.startswith("cuda"):
        torch.cuda.reset_peak_memory_stats()


def _peak(device: str) -> int | None:
    import torch

    return (int(torch.cuda.max_memory_allocated())
            if device.startswith("cuda") else None)


class Keep:
    """One job a snapshot for the check, drawn from the seed as the window
    runs: the m-th job on a snapshot replaces the kept one with chance
    1/m, so each is kept alike, and no other job's outputs are held."""

    def __init__(self, seed: int):
        from .check import seed_rng

        self.rng = seed_rng(seed, 4)
        self.seen: dict = {}
        self.kept: dict = {}

    def offer(self, i: int, runs) -> None:
        self.seen[i] = self.seen.get(i, 0) + 1
        if self.rng.integers(self.seen[i]) == 0:
            self.kept[i] = runs

    def jobs(self) -> list:
        return sorted(self.kept.items(), key=lambda kv: kv[0])


def window(inputs: list, cell: Cell, device: str, seconds: float,
           trace_on: bool, seed: int, log=print, n_jobs: int | None = None,
           first: int = 0):
    """Whole jobs back to back, for ``seconds`` or, given ``n_jobs``,
    that many, cycling through the snapshots from job ``first``; (job
    records, the kept jobs' outputs as (snapshot, runs), the Trace or
    None)."""
    import torch

    from . import trace as tr

    undo, hooks, prof = [], [], None
    notes: dict = {}
    if trace_on:
        spans = spans_of(cell)
        undo = tr.install_spans(spans)
        for m in cell.per_layer:
            mod = metric_module(cell, m["name"])
            if hasattr(mod, "install"):
                hooks.append(mod.install(notes))
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.startswith("cuda"):
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    counters = counters_of(cell)
    jobs, keep = [], Keep(seed)
    try:
        t_start = time.perf_counter()
        prev = 0.0
        k = 0
        while (k < n_jobs if n_jobs is not None else
               k == 0 or (time.perf_counter() - t_start) + prev <= seconds):
            i = (first + k) % len(inputs)
            _reset_peak(device)
            zero_counters(counters)
            t0 = time.perf_counter()
            if prof is not None:
                with torch.profiler.record_function(tr.JOB_SPAN):
                    runs = run_job(inputs[i], cell, device)
            else:
                runs = run_job(inputs[i], cell, device)
            _sync(device)
            t1 = time.perf_counter()
            phases: dict = {}
            for run in runs:
                for name, v in run.phases.items():
                    phases[name] = v
            jobs.append(dict(snapshot=i, start=t0 - t_start,
                             end=t1 - t_start, wall=t1 - t0,
                             halos=sum(r.catalog.n for r in runs),
                             phases=phases, counters=read_counters(counters),
                             peak_bytes=_peak(device)))
            if not trace_on:
                keep.offer(i, runs)
            del runs
            prev = t1 - t0
            k += 1
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
        for undo_hook in hooks:
            undo_hook()
        tr.uninstall(undo)
    trace = None
    if prof is not None:
        t0 = time.perf_counter()
        ops, found = tr.events_of(
            prof, {sp["name"] for sp in spans} | {tr.JOB_SPAN})
        trace = tr.Trace(ops=ops, spans=found, notes=notes)
        del prof
        log(f"[sobench] trace: {len(ops)} device ops, {len(found)} spans, "
            f"read in {time.perf_counter() - t0:.3f} s")
    return jobs, keep.jobs(), trace


def run_cell(cell: Cell, seed: int, seconds: float, trace_on: bool,
             device: str = "cuda", t_process: float | None = None,
             log=print) -> dict:
    """Set-up, window and check of one run; the result object."""
    import torch

    from . import check as ck
    from . import trace as tr

    t_setup = time.perf_counter() if t_process is None else t_process
    from so_tpu_torch import native
    from so_tpu_torch.engine import pipeline  # noqa: F401  (loads the port)

    if device.startswith("cuda"):
        from so_tpu_torch.ops import _cuda

        _cuda.library()
    native.get_lib()
    gen = load_module(cell.root / "sobench" / "gen"
                      / f"{cell.config['generator']}.py")
    snaps = [gen.snapshot(cell.config, cell.mix, (int(seed) << 4) + i, device)
             for i in range(int(cell.mix["snapshots"]))]
    inputs = [Inputs(s) for s in snaps]
    warm_up(inputs, cell, device, seed)
    _sync(device)
    setup_peak = _peak(device)
    setup_s = time.perf_counter() - t_setup
    log(f"[sobench] {cell.name}: set-up {setup_s:.3f} s, "
        f"{snaps[0].n} particles, {snaps[0].n_halos} halos, "
        f"{len(snaps)} snapshots")

    jobs, outs, _ = window(inputs, cell, device, seconds, False, seed, log)
    traced, trace = [], None
    if trace_on:
        traced, _, trace = window(inputs, cell, device, seconds, True, seed,
                                  log, int(cell.mix["trace"]["jobs"]),
                                  len(jobs))
    peaks = [j["peak_bytes"] for j in jobs + traced
             if j["peak_bytes"] is not None]
    memory_peak = max(peaks + [setup_peak]) if peaks else None
    for name in jobs[0]["phases"]:
        v = [j["phases"].get(name, 0.0) for j in jobs]
        log(f"[sobench] phase {name}: mean {sum(v) / len(v):.4f} s, "
            f"min {min(v):.4f}, max {max(v):.4f}")
    for label, js in (("window", jobs), ("traced window", traced)):
        if js:
            log(f"[sobench] {label}: {len(js)} jobs, "
                f"{js[-1]['end'] - js[0]['start']:.3f} s; job s "
                + " ".join(f"{j['wall']:.4f}" for j in js))

    record = dict(setup_s=setup_s, jobs=jobs, trace=trace)
    wanted = cell.per_layer if trace_on else cell.end_to_end
    metrics = {}
    for m in wanted:
        v = metric_module(cell, m["name"]).read(record)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    on_card = device.startswith("cuda")
    dev_info = dict(platform="gpu" if on_card else "cpu",
                    kind=torch.cuda.get_device_name(0) if on_card else "cpu",
                    count=cell.chips, memory_peak_bytes=memory_peak,
                    power_limit=power_limit() if on_card else None)
    result = dict(attempted=len(jobs), failed=0, metrics=metrics,
                  device=dev_info)
    if trace is not None:
        win = trace.window()
        busy = tr.union_ns([(s, e) for _, s, e in trace.ops], *win)
        dev_info["busy_s"] = busy / 1e9
        dev_info["window_s"] = (win[1] - win[0]) / 1e9
        result["breakdown"] = tr.breakdown(trace)
    del trace, record

    mix = cell.mix
    t_check = time.perf_counter()
    readings = ck.check_window(
        outs, snaps, [float(t) for t in mix["thresholds"]],
        species_of(mix), int(mix.get("n_members", 8)),
        cell.config["period"], mix["check"], seed, device)
    correct, table = ck.verdict(readings, cell.limits)
    log(f"[sobench] check {time.perf_counter() - t_check:.3f} s")
    result = dict(correct=correct, **result, checks=table)
    return result


def main(argv=None, t_process: float | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="sobench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    cell = load_cell(a.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"[sobench] {a.workload} needs {cell.chips} CUDA device(s); "
            f"torch sees {torch.cuda.device_count()}: no result")
        return 2
    cache = ROOT / ".sobench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    result = run_cell(cell, a.seed, a.seconds, bool(a.trace),
                      t_process=t_process, log=log)
    bad = forbidden_modules()
    if bad:
        log(f"[sobench] modules that must not load were loaded: {bad}: "
            "no result")
        return 3
    for name, v in result["checks"].items():
        log(f"[sobench] check {name} {v['value']} limit {v['limit']}")
    print(json.dumps(result), flush=True)
    return 0
