"""Device milliseconds per job of torch's sort kernels inside the
multi-threshold solve (the in-ball row sort after the slotted gathers,
ops/slab_gather.sort_in_ball), from the profiler's trace: sort_device_ms
read within the solve_rvir_multi span that run_so_multi opens."""

from sobench.readers import device_ms_per_job

OWN = ("slab_gather", "piece_gather", "seqsum")


def read(record):
    return device_ms_per_job(
        record, lambda n: "sort" in n.lower() and not any(k in n for k in OWN),
        within="solve_rvir_multi")
