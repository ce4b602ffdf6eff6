"""Seconds per job the solve spends fetching each stage's block to the
host: the program's solve.fetch spans (solver.pack_block and the survey
classify's fetch, each waiting for its dispatch's device work).
Read from the reruns of the traced window's jobs (program_spans.rerun)."""

from sobench import program_spans

install = program_spans.install


def read(record):
    return program_spans.span_s(record, ("solve.fetch",))
