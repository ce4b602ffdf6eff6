"""Seconds per job of the fused post-solve's host half: the self time of
the program's fused.split (the member lists cut per halo), fused.vcm
(the f64 m*v sums), fused.fill (the derived rows written) and
fused.members_list (the catalog-order member list) spans.
Read from the reruns of the traced window's jobs (program_spans.rerun)."""

from sobench import program_spans

install = program_spans.install

HOST = ("fused.split", "fused.vcm", "fused.fill", "fused.members_list")


def read(record):
    return program_spans.span_s(record, HOST, "self_ns")
