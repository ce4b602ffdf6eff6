"""Device milliseconds per job of the gather kernels K1 (slotted and
sorted forms) and K3, from the profiler's trace."""

from sobench.readers import device_ms_per_job

KERNELS = ("slab_gather_kernel", "slab_gather_sorted_kernel",
           "piece_gather_kernel")


def read(record):
    return device_ms_per_job(record,
                             lambda n: any(k in n for k in KERNELS))
