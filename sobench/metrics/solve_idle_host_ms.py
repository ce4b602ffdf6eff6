"""Milliseconds per traced job in which the card is idle while the host
is in the solve's own work: the innermost program span open is solve.plan
or solve.apply (the device trace's gaps, labelled by the program's spans
on the same clock)."""

from sobench import program_spans

install = program_spans.install


def read(record):
    return program_spans.idle_ms(record, ("solve.plan", "solve.apply"))
