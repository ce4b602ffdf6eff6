"""The share of the row sort's slots that it sorts: 100 x the program's
count sort.keys (the in-ball slots keyed and sorted by
ops/slab_gather.sort_in_ball) over sort.slots (the B x K slots handed to
it), over the reruns of the traced window's jobs (program_spans.rerun).
None where the program counts neither, as one that sorts whole rows."""

from sobench import program_spans

install = program_spans.install


def read(record):
    r = program_spans.rerun(record)
    slots = None if r is None else r["counts"].get(("sort.slots",))
    if not slots:
        return None
    return 100.0 * r["counts"].get(("sort.keys",), 0) / slots
