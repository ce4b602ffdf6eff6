"""Arithmetic that several metric readers share (sobench/metrics/*.py)."""

from __future__ import annotations

from . import trace as tr


def phase_per_job(record, phase: str):
    """Seconds of one PhaseTimer phase per job (the program syncs the card
    at each phase edge, so a phase holds the device work it issued); None
    when no job has the phase."""
    jobs = record["jobs"]
    vals = [j["phases"][phase] for j in jobs if phase in j["phases"]]
    return sum(vals) / len(jobs) if vals else None


def device_ms_per_job(record, match, within: str | None = None):
    """Device milliseconds per traced job of the ops ``match`` accepts
    (inside ``within`` spans if given); None without a trace, or when no
    such op ran."""
    trace = record["trace"]
    if trace is None or not trace.jobs():
        return None
    ns = tr.device_ns(trace, match, within)
    return ns / 1e6 / len(trace.jobs()) if ns else None
