"""Seconds a job spends in the program's "members + derived (fused)" phase."""

from sobench.readers import phase_per_job


def read(record):
    return phase_per_job(record, "members + derived (fused)")
