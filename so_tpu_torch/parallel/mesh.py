"""Halo x particle sharding over an (H, P) mesh of torch devices (port of
so_tpu/parallel/mesh.py).

The reference is a serial program (SURVEY.md section 2.2); its two
implicit axes of decomposition are the axes of the mesh:

  - 'halo': the catalog. A dispatch's halos are cut into H contiguous
    slices; slice h is gathered by the devices of mesh row h.
  - 'part': the particles, cut into P equal shards in file order, each
    with its own Morton grid (ShardedGrid). Shard p lives on every device
    of mesh column p.

so_tpu writes one shard_map body per stage and lets XLA insert the
collectives. Here one process holds the mesh and does them itself, at the
one place where a stage reads particles: the gather. ops/gather's
slab_gather, unsorted_gather and footprint hand a ShardedGrid to its own
methods. For slice h each shard gathers its candidates by the port's own
route (K1's sorted form, or K1/K3 slotted and a row sort) at capacity K;
the P rows go to device mesh[h][0] and are concatenated to P * K slots a
halo (the all-gather), and one stable sort merges them (slab_gather).
n_in is the sum over the shards and a halo overflows when any shard does.
The slices meet on the mesh's first device, where the rest of every stage
runs unchanged on the merged rows: the serial-f32 scan (K2), the
verdicts, the derived quantities, the member rows. The halo axis thus
splits the gathers and the merges; the scans run on the first device.

Under --distributed (parallel/distributed.py, parallel/driver.py) each
rank holds only its own P_local shards, global shards rank * P_local + p
(``shard0``), and a transport (``comm``). A slice's rows, merged over the
local shards, are then all-gathered over the ranks in rank order and
merged again by the same function, so every rank holds the same merged
rows, ties in (rank, shard, slot) order: global shard order, that of a
1 x (W * P_local) mesh in one process. The gathers' two reads of
per-particle arrays, a source particle's file index (slab_gather's "orig")
and position (unsorted_gather's gather.POSITION), are answered by each
shard before the merge.

Exactness: the merge of disjoint shard subsets is the single-device row
up to the order within equal d2, which is free (docs/PARITY.md #3; here
(shard, slot) order). Without equal d2 in a ball every result equals the
single-device run's bit for bit.

The engine's level and capacity logic reads the sharded grid as a grid of
one shard: ``n`` is the rows a shard (solver._pick_level's occupancy,
solver._k_limit's ceiling), a ball's footprint is its largest shard's
(over every rank's), and a merged row is ``parts`` * K slots wide (the
dispatch slot budgets; ``parts`` counts every rank's shards). Every value
the engine decides on is thus the same on every rank, so every rank
issues the same gathers and collectives.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import gather
from ..ops.grid import (build_grid, choose_chunk, choose_m,
                        detect_uniform_mass)


@dataclass(frozen=True)
class Mesh:
    """An (H, P) array of torch devices: row h gathers halo slice h, column
    p holds particle shard p. A device may appear more than once."""
    devices: tuple            # H tuples of P torch.device

    @property
    def shape(self) -> dict:
        return {"halo": len(self.devices), "part": len(self.devices[0])}

    @property
    def device(self) -> torch.device:
        """The first device: where the slices' merged rows meet."""
        return self.devices[0][0]


def make_mesh(n_halo: int, n_part: int, devices=None) -> Mesh:
    """An n_halo x n_part mesh over ``devices`` (row-major), by default the
    first n_halo * n_part CUDA devices; raises if fewer are visible.
    ``[torch.device("cpu")] * 8`` runs a 2x4 mesh on the CPU,
    ``[torch.device("cuda:0")] * 4`` a 1x4 mesh on one card."""
    n = n_halo * n_part
    if n_halo < 1 or n_part < 1:
        raise ValueError(f"a mesh needs H, P >= 1, got {n_halo}x{n_part}")
    if devices is None:
        found = torch.cuda.device_count()
        if found < n:
            raise RuntimeError(f"a {n_halo}x{n_part} mesh needs {n} CUDA "
                               f"devices, found {found}")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [torch.device(d) for d in devices]
    if len(devices) != n:
        raise ValueError(f"a {n_halo}x{n_part} mesh takes {n} devices, got "
                         f"{len(devices)}")
    return Mesh(tuple(tuple(devices[h * n_part:(h + 1) * n_part])
                      for h in range(n_halo)))


def _global_rows(idx, offset: int):
    """A shard's source rows (-1 off-ball) as rows of the sharded grid."""
    return torch.where(idx >= 0, idx + offset, idx)


def _pad_slots(t, K: int, fill):
    """A (B, W) or (B, W, 3) row tensor padded with ``fill`` to K slots."""
    if t.shape[1] == K:
        return t
    pad = t.new_full((t.shape[0], K - t.shape[1]) + t.shape[2:], fill)
    return torch.cat([t, pad], dim=1)


def _take(ch, order):
    """A (B, W) or (B, W, 3) channel permuted along its slots."""
    return torch.take_along_dim(ch, order if ch.dim() == 2
                                else order[..., None], dim=1)


@dataclass
class ShardedGrid:
    """P Morton grids, one a particle shard, placed on the mesh.

    ``cells[h][p]`` is shard p's CellGrid on ``mesh.devices[h][p]``; a
    shard is built once per distinct device, so cells that share a device
    share the object. Every shard holds ``n_local`` rows (the last ones
    padded with zero-mass rows that no cell reaches) and its ``orig_idx``
    maps them to original file indices (-1 on padding). Row r of shard p
    is row (shard0 + p) * n_local + r of the sharded grid, the row space
    of the merged gathers' idx.

    ``comm`` (a distributed.TorchTransport, or a test's fake) makes the
    grid one rank's part of a grid over ``comm.nproc`` ranks, whose
    shards start at global shard ``shard0``; None is a one-process grid.
    """
    mesh: Mesh
    cells: tuple              # H tuples of P CellGrids
    n_local: int
    uniform_mass: float | None
    comm: object = None
    shard0: int = 0

    # the CellGrid surface that the engine's level and capacity logic reads
    @property
    def parts(self) -> int:
        """Shards over every rank: a merged row is parts * K slots."""
        return self.mesh.shape["part"] * (1 if self.comm is None
                                          else self.comm.nproc)

    @property
    def n(self) -> int:
        return self.n_local

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    @property
    def m(self) -> int:
        return self.cells[0][0].m

    @property
    def chunk(self) -> int:
        return self.cells[0][0].chunk

    @property
    def period(self) -> torch.Tensor:
        return self.cells[0][0].period

    def period_np(self) -> np.ndarray:
        return self.cells[0][0].period_np()

    def ncell(self, level: int) -> int:
        return self.cells[0][0].ncell(level)

    def map_shards(self, fn) -> "ShardedGrid":
        """The sharded grid with ``fn`` applied to each placed shard once."""
        done = {}

        def once(g):
            if id(g) not in done:
                done[id(g)] = fn(g)
            return done[id(g)]

        cells = tuple(tuple(once(g) for g in row) for row in self.cells)
        return dataclasses.replace(self, cells=cells)

    def _each_slice(self, shard_fn, merge, *halo):
        """For each halo slice h and shard p: ``shard_fn(cell, offset, *the
        slice's halo tensors on the cell's device)`` returns a list of
        tensors (or None), moved to mesh[h][0]; ``merge`` of the P lists
        (one shard's list is its own merge) gives the slice's list. Over
        ranks, every rank's list is all-gathered and merged again, in rank
        order. The slice's list goes to the first device. Returns the
        slices' lists concatenated over halos. B is the same on every
        rank, so every rank skips the same empty slices."""
        B = halo[0].shape[0]
        H = len(self.cells)
        cuts = [h * B // H for h in range(H + 1)]
        outs = []
        for h in range(H):
            lo, hi = cuts[h], cuts[h + 1]
            if lo == hi:
                continue
            home = self.mesh.devices[h][0]
            rows = []
            for p, g in enumerate(self.cells[h]):
                res = shard_fn(g, (self.shard0 + p) * self.n_local,
                               *(x[lo:hi].to(g.device) for x in halo))
                rows.append([None if t is None else t.to(home) for t in res])
            merged = rows[0] if len(rows) == 1 else merge(rows)
            if self.comm is not None and self.comm.nproc > 1:
                merged = merge(self.comm.allgather_tensors(merged))
            outs.append([None if t is None else t.to(self.device)
                         for t in merged])
        return [None if parts[0] is None else torch.cat(parts)
                for parts in zip(*outs)]

    def slab_gather(self, level, centers, radii, r2_mask, K, S, channels):
        """gather.slab_gather merged over the shards: (B, P * K) rows sorted
        by d2, ties in (shard, slot) order; idx in the sharded grid's
        rows. A shard's rows narrower than K (the in-ball sort's) are
        padded back to K slots, so every halo slice and rank merges rows
        of one width."""
        nch = len(channels)

        def shard(g, offset, c, r, r2):
            sg = gather.slab_gather(g, level, c, r, r2, K, S, channels)
            chans = [_pad_slots(_global_rows(ch, offset) if name == "idx"
                                else ch, K,
                                -1 if name in ("idx", "orig") else 0)
                     for name, ch in zip(channels, sg.channels)]
            return [_pad_slots(sg.d2, K, torch.inf), sg.n_in, sg.overflow,
                    *chans]

        def merge(rows):
            d2, order = torch.sort(torch.cat([r[0] for r in rows], dim=1),
                                   dim=1, stable=True)
            chans = [_take(torch.cat([r[3 + i] for r in rows], dim=1), order)
                     for i in range(nch)]
            return [d2, torch.stack([r[1] for r in rows]).sum(dim=0),
                    torch.stack([r[2] for r in rows]).any(dim=0), *chans]

        d2, n_in, overflow, *chans = self._each_slice(shard, merge, centers,
                                                      radii, r2_mask)
        return gather.SlabGatherResult(d2=d2, channels=tuple(chans),
                                       n_in=n_in, overflow=overflow)

    def unsorted_gather(self, level, centers, radii, r2_mask, K, S, chans,
                        want_idx):
        """gather.unsorted_gather merged over the shards: the shards' slot
        rows side by side, (B, P * K), shard by shard."""
        def shard(g, offset, c, r, r2):
            d2, ch, idx, overflow = gather.unsorted_gather(
                g, level, c, r, r2, K, S, chans, want_idx)
            return [d2, ch, None if idx is None
                    else _global_rows(idx, offset), overflow]

        def merge(rows):
            return [torch.cat([r[0] for r in rows], dim=1),
                    torch.cat([r[1] for r in rows], dim=2),
                    None if rows[0][2] is None
                    else torch.cat([r[2] for r in rows], dim=1),
                    torch.stack([r[3] for r in rows]).any(dim=0)]

        return tuple(self._each_slice(shard, merge, centers, radii, r2_mask))

    def footprint(self, level, centers, radii, S):
        """gather.footprint: each ball's largest shard footprint."""
        def shard(g, offset, c, r):
            return [gather.footprint(g, level, c, r, S)]

        def merge(rows):
            return [torch.stack([r[0] for r in rows]).amax(dim=0)]

        return self._each_slice(shard, merge, centers, radii)[0]


def build_sharded_grid(pos, mass, vel=None, phi=None, ptype=None, mark=None,
                       period=(1.0, 1.0, 1.0), center=(0.0, 0.0, 0.0),
                       m: int | None = None, *, mesh: Mesh,
                       species_counts=None) -> ShardedGrid:
    """Split the particles in file order into P = mesh.shape["part"] shards
    of ceil(n / P) rows (the last padded with zero-mass rows) and build
    each shard's grid with ops/grid.build_grid on every distinct device of
    its mesh column. m = min(choose_m(n // P), 9) and chunk =
    choose_chunk(n // P, m), as so_tpu picks them; uniform_mass is detected
    on the real rows. The species come from ``ptype`` or from the header's
    ``species_counts``, as build_grid takes them."""
    n = np.shape(pos)[0]
    return build_shards(mesh, pos, mass, vel, phi, ptype, mark, period,
                        center, m, n_global=n, nproc=1, start=0,
                        uniform_mass=detect_uniform_mass(mass), comm=None,
                        species_counts=species_counts)


def build_shards(mesh: Mesh, pos, mass, vel, phi, ptype, mark, period,
                 center, m, *, n_global: int, nproc: int, start: int,
                 uniform_mass, comm, species_counts=None) -> ShardedGrid:
    """The shards of rows [start, start + len(pos)) of an n_global-particle
    file split over nproc * P shards (P = mesh.shape["part"] a process):
    build_sharded_grid's split, m and chunk at that shard count. With
    ``species_counts``, shard p's row 0 is file row start + p * nl."""
    pos = np.asarray(pos, np.float32)
    count = pos.shape[0]
    P = mesh.shape["part"]
    nsh = nproc * P
    if m is None:
        m = min(choose_m(max(n_global // nsh, 1)), 9)
    chunk = choose_chunk(max(n_global // nsh, 1), m)
    nl = -(-n_global // nsh)

    def split(a, fill=0):
        if a is None:
            return [None] * P
        a = np.asarray(a)
        out = np.full((P * nl,) + a.shape[1:], fill, a.dtype)
        out[:count] = a
        return out.reshape((P, nl) + a.shape[1:])

    fields = dict(vel=split(vel), phi=split(phi), ptype=split(ptype),
                  mark=split(mark, False))
    pos_s, mass_s = split(pos), split(np.asarray(mass, np.float32))
    valid = split(np.ones(count, bool), False)
    gidx = split(start + np.arange(count, dtype=np.int64), -1)
    built = {}

    def shard(p, dev):
        if (p, dev) not in built:
            g = build_grid(pos_s[p], mass_s[p], period=period, center=center,
                           m=m, chunk=chunk, valid=valid[p], device=dev,
                           species_counts=species_counts,
                           first_row=start + p * nl,
                           **{k: v[p] for k, v in fields.items()})
            built[(p, dev)] = dataclasses.replace(
                g, uniform_mass=uniform_mass,
                orig_idx=torch.as_tensor(gidx[p], device=dev)[g.orig_idx])
        return built[(p, dev)]

    cells = tuple(tuple(shard(p, dev) for p, dev in enumerate(row))
                  for row in mesh.devices)
    return ShardedGrid(mesh, cells, nl, uniform_mass, comm,
                       0 if comm is None else comm.pid * P)


def _check(mesh: Mesh, sgrid: ShardedGrid) -> None:
    if sgrid.mesh != mesh:
        raise ValueError("the sharded grid was built on another mesh")


def solve_rvir_sharded(mesh: Mesh, sgrid: ShardedGrid, centers, rgtp, thr,
                       n_members: int = 8, **kw):
    """engine.solver.solve_rvir on a sharded grid (``survey`` included:
    the classify's unsorted gather merges like the solve's)."""
    from ..engine.solver import solve_rvir

    _check(mesh, sgrid)
    return solve_rvir(sgrid, centers, rgtp, thr, n_members=n_members, **kw)


def solve_rvir_multi_sharded(mesh: Mesh, sgrid: ShardedGrid, centers, rgtp,
                             thresholds, n_members: int = 8, **kw):
    """engine.multi.solve_rvir_multi on a sharded grid."""
    from ..engine.multi import solve_rvir_multi

    _check(mesh, sgrid)
    return solve_rvir_multi(sgrid, centers, rgtp, thresholds,
                            n_members=n_members, **kw)


def recenter_most_bound_sharded(mesh: Mesh, sgrid: ShardedGrid, centers,
                                rgtp, k0_cap: int = 4096):
    """engine.recenter.recenter_most_bound on a sharded grid (built with
    phi): each shard's payload gets phi in its mass row, and the argmin runs
    over the merged rows, ties in (shard, slot) order."""
    from ..engine.recenter import recenter_most_bound

    _check(mesh, sgrid)
    return recenter_most_bound(sgrid, centers, rgtp, k0_cap=k0_cap)


def host_mv_from_sharded(sgrid: ShardedGrid):
    """The ``(vel, mass)`` pair of host arrays in original file order,
    rebuilt from the shards (one fetch each): every shard's real rows are
    scattered to their file indices; padding rows (orig_idx -1) are
    dropped. A rank's part of a --distributed grid holds only its own
    rows, so it is refused: pass host_mv instead."""
    if sgrid.comm is not None:
        raise ValueError("a rank's part of a --distributed grid holds only "
                         "its own rows: pass host_mv")
    shards = sgrid.cells[0]
    oi = [g.orig_idx.cpu().numpy() for g in shards]
    n = sum(int((o >= 0).sum()) for o in oi)
    vel = np.zeros((n, 3), np.float32)
    mass = np.zeros(n, np.float32)
    for g, o in zip(shards, oi):
        real = o >= 0
        vel[o[real]] = g.vel_a().cpu().numpy()[real]
        mass[o[real]] = g.mass_a().cpu().numpy()[real]
    return vel, mass


def extract_members_sharded(mesh: Mesh, sgrid: ShardedGrid, centers, d2cut,
                            j, mvir, host_mv=None, cap_hint=None):
    """engine.members.extract_members on a sharded grid: the sorted gather
    at each d2cut merges the shards' rows. ``host_mv`` (the file-order
    m*v, dense or the ``(vel, mass)`` pair) feeds the vcm; None rebuilds
    it from the shards (host_mv_from_sharded)."""
    from ..engine.members import extract_members

    _check(mesh, sgrid)
    return extract_members(sgrid, centers, d2cut, j, mvir, cap_hint=cap_hint,
                           host_mv=host_mv)


def run_so_sharded(particles, catalog, params, mesh: Mesh):
    """engine.pipeline.run_so with its grid sharded over ``mesh``, whose
    devices the run uses (``params.device`` is not read). No checkpoint:
    the sharded run has no resume yet."""
    from ..engine.pipeline import run_so

    if params.checkpoint is not None:
        raise ValueError("a sharded run takes no checkpoint")
    return run_so(particles, catalog, params, mesh=mesh)


def run_so_multi_sharded(particles, catalog, params, thresholds,
                         mesh: Mesh):
    """engine.pipeline.run_so_multi with its grid sharded over ``mesh``."""
    from ..engine.pipeline import run_so_multi

    return run_so_multi(particles, catalog, params, thresholds, mesh=mesh)
