"""Seconds a job spends in the program's "grid build" phase."""

from sobench.readers import phase_per_job


def read(record):
    return phase_per_job(record, "grid build")
