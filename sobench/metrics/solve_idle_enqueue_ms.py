"""Milliseconds per traced job in which the card is idle while the host
enqueues a solve dispatch: the innermost program span open is
solve.ranges, solve.gather, solve.sort or solve.scan."""

from sobench import program_spans

install = program_spans.install

ENQUEUE = ("solve.ranges", "solve.gather", "solve.sort", "solve.scan")


def read(record):
    return program_spans.idle_ms(record, ENQUEUE)
