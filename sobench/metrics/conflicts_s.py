"""Seconds a job spends in the program's "conflict protocol" phase."""

from sobench.readers import phase_per_job


def read(record):
    return phase_per_job(record, "conflict protocol")
