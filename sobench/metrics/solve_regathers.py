"""Halo gathers per halo in the solve: the program's count
solve.halo_gathers (the halos of every solve dispatch, survey and
whole-box ones included) over the halos of the jobs. 1 would be one
gather a halo; each overflow regather or grown ball adds one.
Read from the reruns of the traced window's jobs (program_spans.rerun)."""

from sobench import program_spans

install = program_spans.install


def read(record):
    return program_spans.per_halo(record, "solve.halo_gathers")
