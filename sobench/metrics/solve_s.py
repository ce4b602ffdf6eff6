"""Seconds a job spends in the program's solve: its "R_Delta solve"
phase, or "R_Delta solve (multi)" under run_so_multi."""

from sobench.readers import phase_per_job


def read(record):
    got = [v for v in (phase_per_job(record, "R_Delta solve"),
                       phase_per_job(record, "R_Delta solve (multi)"))
           if v is not None]
    return sum(got) if got else None
