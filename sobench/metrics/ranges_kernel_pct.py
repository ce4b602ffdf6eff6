"""The share of the gathers' cell enumerations that the enumeration
kernel served: 100 x the program's count ranges.kernel (enumerations
launched as one CUDA kernel, ops/ranges.slab_ranges) over ranges.calls
(every enumeration at align > 1), over the reruns of the traced window's
jobs (program_spans.rerun). None where the program counts neither, as one
that enumerates in torch ops alone."""

from sobench import program_spans

install = program_spans.install


def read(record):
    r = program_spans.rerun(record)
    calls = None if r is None else r["counts"].get(("ranges.calls",))
    if not calls:
        return None
    return 100.0 * r["counts"].get(("ranges.kernel",), 0) / calls
