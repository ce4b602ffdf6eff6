"""Multi-process wiring over torch.distributed (port of
so_tpu/parallel/distributed.py).

The reference is a single process with the whole snapshot in memory
(SURVEY.md section 2.2); a 1024^3 snapshot needs each process to read only
its own segment of the file and hold only its own particle shards. The
pieces:

  1. init_distributed(): torch.distributed.init_process_group from
     torchrun's environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK;
     LOCAL_RANK picks the card), with the backend the caller names.
  2. host_segment / grid_segment: the [start, count) of the particle file
     a rank reads (io.tipsy.read_tipsy_segment seeks straight to it).
  3. build_sharded_grid_segment: the rank's P_local shards of a
     parallel.ShardedGrid whose part axis continues across ranks (global
     shard rank * P_local + p). The grid's gathers merge over the local
     shards, then over the ranks (mesh.ShardedGrid._each_slice), so every
     rank sees the same merged rows.
  4. TorchTransport: the collectives the grid and parallel/driver.py use.
     Host arrays go through the group's CPU backend (gloo); a card's
     tensors through its CUDA backend: NCCL with one card a rank, or gloo
     when several ranks share a card (NCCL refuses that).

so_tpu's make_global, make_global_from_local and fetch_sharded assemble
jax.Arrays across processes; the merge at the gather seam does their work
here, so they have no counterpart.
"""

from __future__ import annotations

import os
from datetime import timedelta

import numpy as np
import torch

# torchrun's variables that describe the group (LOCAL_RANK picks the card)
COORDINATOR_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")
DEFAULT_TIMEOUT = timedelta(minutes=30)


def default_backend(device) -> str:
    """The backend for a run on ``device``: gloo on the CPU; on a card,
    gloo for host arrays and NCCL for the card's tensors (one card a
    rank)."""
    return ("gloo" if torch.device(device).type == "cpu"
            else "cpu:gloo,cuda:nccl")


def init_distributed(backend: str, timeout: timedelta = DEFAULT_TIMEOUT
                     ) -> bool:
    """Join the process group torchrun's environment describes, with
    ``backend`` (a torch.distributed backend string, default_backend's or
    "gloo" alone for several ranks on one card) and a finite ``timeout``,
    so a rank left waiting at a collective fails instead of hanging.
    Returns False when none of the coordinator's variables is set (a
    single-process run); raises if only some are."""
    import torch.distributed as dist

    env = os.environ
    if not any(v in env for v in COORDINATOR_VARS):
        return False
    missing = [v for v in COORDINATOR_VARS if v not in env]
    if missing:
        raise RuntimeError(f"torch.distributed: {', '.join(missing)} not "
                           "set (set all of " + ", ".join(COORDINATOR_VARS)
                           + ")")
    dist.init_process_group(
        backend=backend,
        init_method=f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
        world_size=int(env["WORLD_SIZE"]), rank=int(env["RANK"]),
        timeout=timeout)
    return True


def rank_device(device) -> torch.device:
    """The rank's device: "cuda" is cuda:LOCAL_RANK, "cuda:N" that card,
    "cpu" the CPU. A card that torch does not see raises."""
    from ..engine.pipeline import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"{dev} requested, torch sees "
                               f"{torch.cuda.device_count()} CUDA devices")
    return dev


def _world(num_hosts, host_id) -> tuple[int, int]:
    import torch.distributed as dist

    if num_hosts is None:
        num_hosts = dist.get_world_size()
    if host_id is None:
        host_id = dist.get_rank()
    if not 0 <= host_id < num_hosts:
        raise ValueError(f"host_id {host_id} outside [0, {num_hosts})")
    return num_hosts, host_id


def host_segment(n: int, num_hosts: int | None = None,
                 host_id: int | None = None) -> tuple[int, int]:
    """The [start, count) of n items owned by a rank: contiguous, balanced
    (sizes differ by at most 1), covering. Rank and count default to
    torch.distributed's."""
    num_hosts, host_id = _world(num_hosts, host_id)
    base, rem = divmod(n, num_hosts)
    return host_id * base + min(host_id, rem), base + int(host_id < rem)


def grid_segment(n: int, parts_per_host: int, num_hosts: int | None = None,
                 host_id: int | None = None) -> tuple[int, int]:
    """[start, count) of the particle file a rank reads so that its
    ``parts_per_host`` shards are exactly its rows of the sharded grid:
    shard s holds rows [s * nl, (s + 1) * nl), nl = ceil(n / (num_hosts *
    parts_per_host)), the last ones tail-padded."""
    num_hosts, host_id = _world(num_hosts, host_id)
    nl = -(-n // (num_hosts * parts_per_host)) if n else 0
    start = min(host_id * parts_per_host * nl, n)
    stop = min((host_id + 1) * parts_per_host * nl, n)
    return start, stop - start


def make_multihost_mesh(parts_per_host: int = 1, device="cuda"):
    """The rank's local 1 x ``parts_per_host`` Mesh, every cell on the
    rank's device (rank_device). The part axis continues across ranks:
    a rank's shard p is global shard rank * parts_per_host + p (the
    ShardedGrid's shard0)."""
    from .mesh import make_mesh

    return make_mesh(1, parts_per_host,
                     devices=[rank_device(device)] * parts_per_host)


def allgather_f64(a) -> np.ndarray:
    """(W,) + a.shape float64 of every rank's ``a``, bit for bit."""
    return np.stack(allgather_varlen(np.asarray(a, np.float64).ravel())
                    ).reshape((-1,) + np.shape(a))


def allgather_varlen(a: np.ndarray) -> list:
    """Every rank's 1-D array, of any length, in rank order; bits and
    dtype kept (torch sends them as they are, through the CPU backend).
    Lengths go first so every rank pads to the longest."""
    import torch.distributed as dist

    a = np.ascontiguousarray(a).ravel()
    W = dist.get_world_size()
    n = torch.tensor([a.size], dtype=torch.int64)
    ns = [torch.empty_like(n) for _ in range(W)]
    dist.all_gather(ns, n)
    ns = [int(x) for x in ns]
    pad = torch.zeros(max(ns + [1]), dtype=torch.from_numpy(a[:0]).dtype)
    pad[:a.size] = torch.from_numpy(a)
    outs = [torch.empty_like(pad) for _ in range(W)]
    dist.all_gather(outs, pad)
    return [o[:k].numpy() for o, k in zip(outs, ns)]


def allgather_tensors(tensors: list) -> list:
    """Every rank's list of tensors (same shapes and dtypes on every rank;
    None entries stay None), as one list a rank in rank order, each tensor
    on its own device. Bool goes as uint8. A card's tensors go through the
    group's CUDA backend: NCCL, or gloo, which stages them through host
    memory itself (several ranks on one card)."""
    import torch.distributed as dist

    W = dist.get_world_size()
    out = [[] for _ in range(W)]
    for t in tensors:
        if t is None:
            for o in out:
                o.append(None)
            continue
        send = (t.to(torch.uint8) if t.dtype == torch.bool
                else t).contiguous()
        got = [torch.empty_like(send) for _ in range(W)]
        dist.all_gather(got, send)
        for o, g in zip(out, got):
            o.append(g.to(t.device, t.dtype))
    return out


class TorchTransport:
    """The collectives of a --distributed run over the default process
    group: the rank and count, the host-array exchanges of the conflict
    walk and the reductions, the card-tensor all-gather of the sharded
    grid's merges, and barriers. Tests put a threaded in-process fake with
    the same methods in its place."""

    def __init__(self):
        import torch.distributed as dist

        self.nproc = dist.get_world_size()
        self.pid = dist.get_rank()

    def allgather_varlen(self, a) -> list:
        return allgather_varlen(a)

    def process_allgather(self, tree) -> tuple:
        """(W,) + x.shape arrays of every rank's x, for each x of the
        tuple."""
        return tuple(np.stack(allgather_varlen(np.asarray(x).ravel())
                              ).reshape((-1,) + np.shape(x)) for x in tree)

    def allgather_tensors(self, tensors) -> list:
        return allgather_tensors(tensors)

    def barrier(self) -> None:
        import torch.distributed as dist

        dist.barrier()


def build_sharded_grid_segment(mesh, start: int, n_global: int, pos, mass,
                               vel=None, phi=None, ptype=None, mark=None,
                               period=(1.0, 1.0, 1.0),
                               center=(0.0, 0.0, 0.0), m: int | None = None,
                               uniform_mass: float | None = None, *, comm,
                               species_counts=None):
    """The rank's part of a ShardedGrid over ``comm.nproc`` ranks: its
    ``mesh.shape["part"]`` shards, built from its own segment [start,
    start + len(pos)) of the file (grid_segment's). The split, m and chunk
    are parallel.build_sharded_grid's on a mesh of nproc * P_local parts,
    so the merged gathers equal that grid's. ``uniform_mass`` must be the
    global verdict (a rank sees only its segment; run_so_distributed takes
    it by collective), the same on every rank. The species come from
    ``ptype`` (the segment's) or from the header's global
    ``species_counts``, as build_grid takes them."""
    from .mesh import build_shards

    P = mesh.shape["part"]
    want = grid_segment(n_global, P, comm.nproc, comm.pid)
    count = np.shape(pos)[0]
    if (start, count) != want:
        raise ValueError(f"rank {comm.pid} segment ({start}, {count}) != "
                         f"{want} for {P} parts a rank")
    return build_shards(mesh, pos, mass, vel, phi, ptype, mark, period,
                        center, m, n_global=n_global, nproc=comm.nproc,
                        start=start, uniform_mass=uniform_mass, comm=comm,
                        species_counts=species_counts)
