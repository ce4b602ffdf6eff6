"""Checkpoint / resume of the solve state (port of so_tpu/checkpoint.py,
the single-file form; the same .npz format and digest).

The reference has none: the whole run is one pass. Here the device phase
(R_Delta solve + member extraction) can be saved, and a rerun with the
same file resumes straight into the conflict, derived and writer phases.
"""

from __future__ import annotations

import hashlib

import numpy as np

from .engine.solver import SolveResult

FORMAT_VERSION = 2


def _digest_array(h, a) -> None:
    a = np.ascontiguousarray(a)
    h.update(repr((a.shape, a.dtype.str)).encode())
    if a.nbytes > (1 << 20):
        # snapshot-scale arrays: head + tail + a strided sample of ~256K
        # interior bytes + the exact float64 sum (no full-array copy)
        b = a.reshape(-1).view(np.uint8)
        h.update(b[: 1 << 19].tobytes())
        h.update(b[-(1 << 19):].tobytes())
        stride = max(1, b.size >> 18)
        h.update(np.ascontiguousarray(b[::stride]).tobytes())
        if a.dtype.kind == "f":
            h.update(np.float64(a.sum(dtype=np.float64)).tobytes())
    else:
        h.update(a.tobytes())


def input_digest(particles, centers, rgtp, threshold: float,
                 n_members: int, period, center) -> str:
    """Content hash of everything the solve result depends on, stored in
    the checkpoint and checked on resume (the solve arrays index into the
    particle file, so a resume against other inputs would silently write
    a wrong catalog). Velocities count: the saved vcm depends on them."""
    h = hashlib.sha256()
    for a in (particles.pos, particles.vel, particles.mass, particles.phi,
              np.asarray(centers, np.float32), np.asarray(rgtp, np.float32)):
        _digest_array(h, a)
    h.update(repr((np.float32(threshold).item(), int(n_members),
                   tuple(np.asarray(period, np.float32).tolist()),
                   tuple(np.asarray(center, np.float32).tolist()))).encode())
    return h.hexdigest()


def save_solve(path: str, solve: SolveResult, members: list,
               centers: np.ndarray, digest: str = "") -> None:
    mem_off = np.zeros(len(members) + 1, np.int64)
    for g, m in enumerate(members):
        mem_off[g + 1] = mem_off[g] + (0 if m is None else m.size)
    mem = np.concatenate([m for m in members if m is not None and m.size]
                         ) if mem_off[-1] else np.zeros(0, np.int64)
    np.savez_compressed(
        path, version=FORMAT_VERSION, code=solve.code, mvir=solve.mvir,
        rvir=solve.rvir, j=solve.j, d2cut=solve.d2cut, vcm=solve.vcm,
        mem_off=mem_off, mem=mem, centers=centers, digest=digest)


def load_solve(path: str, expect_digest: str | None = None):
    """(SolveResult, member lists, centers) from save_solve's file;
    refuses a file written for other inputs."""
    z = np.load(path)
    if int(z["version"]) != FORMAT_VERSION:
        raise ValueError(f"checkpoint version {int(z['version'])} != "
                         f"{FORMAT_VERSION}")
    if expect_digest is not None:
        stored = str(z["digest"]) if "digest" in z else ""
        if stored and stored != expect_digest:
            raise ValueError(
                f"checkpoint {path} was written for different inputs "
                f"(snapshot/catalog/params digest {stored[:12]}... != "
                f"{expect_digest[:12]}...); refusing to resume")
    solve = SolveResult(code=z["code"], mvir=z["mvir"], rvir=z["rvir"],
                        j=z["j"], d2cut=z["d2cut"], vcm=z["vcm"])
    mem_off, mem = z["mem_off"], z["mem"]
    members = []
    for g in range(mem_off.shape[0] - 1):
        lo, hi = int(mem_off[g]), int(mem_off[g + 1])
        members.append(mem[lo:hi] if (hi > lo or solve.code[g] == 0) else None)
    return solve, members, z["centers"]
