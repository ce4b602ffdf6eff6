"""Slots of the giant solve dispatches per halo: the program's count
solve.giant_slots (B x K of every solve dispatch at K >= 2^24,
engine/solver.GIANT_K) over the halos of the reruns of the traced
window's jobs (program_spans.rerun). A capacity policy that gathers the
largest halos at fewer or smaller tiers reads lower. None where the
program counts no giant slots."""

from sobench import program_spans

install = program_spans.install


def read(record):
    return program_spans.per_halo(record, "solve.giant_slots")
