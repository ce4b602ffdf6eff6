"""Kernel K2's share of its roofline with the chain term: the least time
its launches could take over the device time of its kernels
(seqsum_rows_kernel, seqsum_short_kernel) in the traced window, in
percent.

The least time of one launch is the larger of its bytes / 3.35 TB/s and
its longest chain of serial f32 adds x 4 cycles / 1,980 MHz (one H100
SXM's device memory bandwidth, the data sheet, and its clocks.max.sm, as
chip_smoke.bound has it; the result line gives the card's power limit):
a row's running sum is one dependent add after another, so a launch
takes at least its longest row's chain, however many rows run beside it.
The counts are the program's K2.bytes (k2_roofline's reckoning: the
n_valid f32 read, the B x K f32 written, the (B,) int64 counts) and
K2.chain_adds (each call's largest n_valid), summed over a rerun of the
traced window's jobs with the device counts on
(program_spans.counted). Only the sums can be had, so the least time is
the larger of the two sums' terms, which is no more than the sum of each
launch's larger term: the share is a floor. k2_roofline leaves the chain
out, and on a giant job's long rows it reads near 0."""

from sobench import program_spans
from sobench import trace as tr

HBM_BYTES_PER_S = program_spans.HBM_BYTES_PER_S
CYCLES_PER_ADD = 4
SM_HZ = 1.98e9
KERNELS = ("seqsum_rows_kernel", "seqsum_short_kernel")

install = program_spans.install


def read(record):
    trace = record.get("trace")
    r = program_spans.counted(record)
    if trace is None or r is None:
        return None
    nbytes = r["counts"].get(("K2.bytes",))
    chain = r["counts"].get(("K2.chain_adds",))
    if not nbytes or not chain:
        return None
    ns = tr.device_ns(trace, lambda n: any(k in n for k in KERNELS))
    if not ns:
        return None
    least = max(nbytes / HBM_BYTES_PER_S, chain * CYCLES_PER_ADD / SM_HZ)
    return 100.0 * least / (ns / 1e9)
