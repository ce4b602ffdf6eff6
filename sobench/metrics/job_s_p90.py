"""The 90th percentile of job wall time over every job of the window
(statistics.quantiles, inclusive); None with fewer than ten jobs."""

import statistics


def read(record):
    walls = [j["wall"] for j in record["jobs"]]
    if len(walls) < 10:
        return None
    return statistics.quantiles(walls, n=10, method="inclusive")[-1]
