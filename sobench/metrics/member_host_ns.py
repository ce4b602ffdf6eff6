"""Nanoseconds of the fused post-solve's host half per member row it
fetches: the self time of the spans fused_host_s reads (fused.split,
fused.vcm, fused.fill, fused.members_list) over the program's count
fused.member_rows (the member rows the fused pass fetches to the host),
both over the reruns of the traced window's jobs (program_spans.rerun).
None where the program counts no member rows."""

from sobench import program_spans
from sobench.metrics.fused_host_s import HOST

install = program_spans.install


def read(record):
    r = program_spans.rerun(record)
    rows = None if r is None else r["counts"].get(("fused.member_rows",))
    if not rows:
        return None
    return sum(r["totals"].get((n, "self_ns"), 0) for n in HOST) / rows
