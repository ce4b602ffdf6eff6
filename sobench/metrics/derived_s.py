"""Seconds per job of the program's "derived quantities" span (the
derived rows scattered to catalog order, or the resume path's gather).
Read from the reruns of the traced window's jobs (program_spans.rerun)."""

from sobench import program_spans

install = program_spans.install


def read(record):
    return program_spans.span_s(record, ("derived quantities",))
