"""Device milliseconds per job of torch's sort kernels inside the solve
(the row sort after the slotted gathers, ops/slab_gather.sort_rows),
from the profiler's trace."""

from sobench.readers import device_ms_per_job

OWN = ("slab_gather", "piece_gather", "seqsum")


def read(record):
    return device_ms_per_job(
        record, lambda n: "sort" in n.lower() and not any(k in n for k in OWN),
        within="solve_rvir")
