"""Seconds per job of the solve's host work between dispatches: the self
time of the program's solve.plan (live sets, capacity tiers, radii and
levels) and solve.apply (verdicts and escalation) spans.
Read from the reruns of the traced window's jobs (program_spans.rerun)."""

from sobench import program_spans

install = program_spans.install


def read(record):
    return program_spans.span_s(record, ("solve.plan", "solve.apply"),
                                "self_ns")
