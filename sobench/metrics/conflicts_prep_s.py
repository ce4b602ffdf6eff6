"""Seconds per job of the conflict pass's input building: the program's
conflicts.order (indexx) and conflicts.prep (offsets, the member
concatenation, id2row, the outputs' allocations) spans, against its
native walk (conflicts.walk).
Read from the reruns of the traced window's jobs (program_spans.rerun)."""

from sobench import program_spans

install = program_spans.install


def read(record):
    return program_spans.span_s(record, ("conflicts.order", "conflicts.prep"))
