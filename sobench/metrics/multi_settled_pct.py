"""The share of the multi-threshold solve's (halo, threshold) verdicts
that rescan a pair already resolved: 100 x the program's count
multi.verdicts_settled over multi.verdicts (T x the halos of every solve
dispatch, the survey's classify and whole-box stages included), over the
reruns of the traced window's jobs (program_spans.rerun). A halo rides on
through the rounds until every threshold has resolved, so this is what
sharing one ladder costs. None where the program counts neither."""

from sobench import program_spans

install = program_spans.install


def read(record):
    r = program_spans.rerun(record)
    verdicts = None if r is None else r["counts"].get(("multi.verdicts",))
    if not verdicts:
        return None
    return 100.0 * r["counts"].get(("multi.verdicts_settled",), 0) / verdicts
