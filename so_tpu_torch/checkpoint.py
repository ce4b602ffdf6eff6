"""Checkpoint / resume of the solve state (port of so_tpu/checkpoint.py:
the single-file, per-rank sharded and --distributed segment forms, in the
same .npz format and with the same digest).

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


def save_solve_sharded(path: str, solve: SolveResult, members: list,
                       centers: np.ndarray, host_id: int | None = None,
                       num_hosts: int | None = None,
                       digest: str = "") -> str:
    """One rank's shard of the state: its contiguous halo slice
    (parallel.distributed.host_segment) as ``{path}.{host_id}-of-
    {num_hosts}.npz``, in save_solve's format, so no rank holds the global
    member table. Rank and count default to torch.distributed's. Returns
    the shard's path."""
    from .parallel.distributed import host_segment

    if num_hosts is None or host_id is None:
        import torch.distributed as dist

        num_hosts = dist.get_world_size() if num_hosts is None else num_hosts
        host_id = dist.get_rank() if host_id is None else host_id
    lo, cnt = host_segment(len(members), num_hosts, host_id)
    shard = f"{path}.{host_id}-of-{num_hosts}.npz"
    sl = slice(lo, lo + cnt)
    sub = SolveResult(code=solve.code[sl], mvir=solve.mvir[sl],
                      rvir=solve.rvir[sl], j=solve.j[sl],
                      d2cut=solve.d2cut[sl], vcm=solve.vcm[sl])
    save_solve(shard, sub, members[sl], centers[sl], digest=digest)
    return shard


def load_solve_sharded(path: str, num_hosts: int,
                       expect_digest: str | None = None):
    """All of save_solve_sharded's shards merged back into global arrays."""
    parts = [load_solve(f"{path}.{h}-of-{num_hosts}.npz", expect_digest)
             for h in range(num_hosts)]

    def cat(field):
        return np.concatenate([getattr(p[0], field) for p in parts])

    solve = SolveResult(code=cat("code"), mvir=cat("mvir"), rvir=cat("rvir"),
                        j=cat("j"), d2cut=cat("d2cut"), vcm=cat("vcm"))
    members = [m for p in parts for m in p[1]]
    return solve, members, np.concatenate([p[2] for p in parts])


def save_solve_segment(path: str, solve: SolveResult, members: list,
                       centers: np.ndarray, digest: str = "") -> None:
    """A --distributed rank's post-members state (parallel.driver.
    run_so_distributed): the replicated solve arrays, so the rank can
    resume from its own file alone, and ``members`` as SegRows (the rank's
    segment rows of each halo's list with their ranks in it) or None.
    ``kind="segment"`` marks the file; the fields are so_tpu's, so a shard
    written by either package loads in the other. ``digest`` should mix
    the segment layout in, so a resume with another process count fails."""
    G = len(members)
    have = np.zeros(G, bool)
    n_full = np.zeros(G, np.int64)
    off = np.zeros(G + 1, np.int64)
    ranks_c, rows_c = [], []
    for g, m in enumerate(members):
        k = 0
        if m is not None:
            have[g] = True
            n_full[g] = int(m.n)
            k = m.rows.size
            if k:
                ranks_c.append(np.asarray(m.ranks, np.int64))
                rows_c.append(np.asarray(m.rows, np.int64))
        off[g + 1] = off[g] + k

    def cat(xs):
        return np.concatenate(xs) if xs else np.zeros(0, np.int64)

    np.savez_compressed(
        path, version=FORMAT_VERSION, kind="segment", code=solve.code,
        mvir=solve.mvir, rvir=solve.rvir, j=solve.j, d2cut=solve.d2cut,
        vcm=solve.vcm, have=have, n_full=n_full, off=off,
        ranks=cat(ranks_c), rows=cat(rows_c), centers=centers,
        digest=digest)


def load_solve_segment(path: str, expect_digest: str | None = None):
    """save_solve_segment's file as (SolveResult, SegRows-or-None list,
    centers); refuses another kind of file or one written for other inputs
    or another segment layout."""
    from .parallel.driver import SegRows

    z = np.load(path)
    if int(z["version"]) != FORMAT_VERSION:
        raise ValueError(f"checkpoint version {int(z['version'])} != "
                         f"{FORMAT_VERSION}")
    if str(z.get("kind", "")) != "segment":
        raise ValueError(f"{path} is not a distributed segment checkpoint")
    if expect_digest is not None:
        stored = str(z["digest"]) if "digest" in z else ""
        if stored and stored != expect_digest:
            raise ValueError(
                f"checkpoint {path} was written for different inputs or "
                f"a different segment layout (digest {stored[:12]}... != "
                f"{expect_digest[:12]}...); refusing to resume")
    solve = SolveResult(code=z["code"], mvir=z["mvir"], rvir=z["rvir"],
                        j=z["j"], d2cut=z["d2cut"], vcm=z["vcm"])
    have, n_full, off = z["have"], z["n_full"], z["off"]
    ranks, rows = z["ranks"], z["rows"]
    members = []
    for g in range(have.shape[0]):
        if not have[g]:
            members.append(None)
            continue
        lo, hi = int(off[g]), int(off[g + 1])
        members.append(SegRows(ranks=ranks[lo:hi], rows=rows[lo:hi],
                               n=int(n_full[g])))
    return solve, members, z["centers"]
