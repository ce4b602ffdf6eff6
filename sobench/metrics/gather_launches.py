"""Gather kernel launches per job: K1 (both forms) and K3, from the
program's launch counters."""


def read(record):
    jobs = record["jobs"]
    n = [j["counters"].get(k) for j in jobs for k in ("K1", "K3")]
    if any(v is None for v in n):
        return None
    return sum(n) / len(jobs)
