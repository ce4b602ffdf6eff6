"""Halos of every job in the window over the wall time from the first
job's start to the last job's end."""


def read(record):
    jobs = record["jobs"]
    span = jobs[-1]["end"] - jobs[0]["start"]
    return sum(j["halos"] for j in jobs) / span if span > 0 else None
