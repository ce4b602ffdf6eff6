"""Seconds per job of run_so_multi's post-solves: the program's
multi.post spans, one a threshold (members and derived quantities, the
conflict pass and the stats of that threshold's catalog).
Read from the reruns of the traced window's jobs (program_spans.rerun)."""

from sobench import program_spans

install = program_spans.install


def read(record):
    return program_spans.span_s(record, ("multi.post",))
