"""Morton-sorted multi-level cell grid (port of so_tpu/ops/grid.py).

Particles are sorted once by Morton code on a 2^m-per-axis grid over the
periodic box; a level-g cell is then a contiguous range of the sorted rows
and one CSR ``starts`` array per level maps cell -> row range. The grid
always carries the transposed (8, W) slab payload that the gather kernels
read (rows x, y, z, mass, vx, vy, vz, meta; meta = species | mark << 4),
and nothing else per particle: the payload is a bit-exact encoding of
pos/mass/vel/ptype/mark, served back by the ``*_a()`` accessors. Its row
stride W is N + chunk rounded up to PAYLOAD_ALIGN floats, so every row
starts on a 128-byte line and K3 reads it in 16-byte groups; the columns
past N hold pad values (x=y=z=1e30, the rest 0) that no candidate reaches.
Particle potentials (-pot) are kept beside it, in sorted order, only when
given.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..io.tipsy import DARK, GAS, STAR
from ..profiling import span

# default slab chunk and its only alternative (choose_chunk)
CHUNK = 256
TARGET_OCCUPANCY = 24   # mean particles per finest cell (choose_m)
M_MAX = 9               # finest level choose_m picks
PAYLOAD_ALIGN = 32      # payload row stride: a multiple of 32 floats
# Morton code of a padding row (build_grid's ``valid`` False): at least the
# cell count at every level (1<<30 >> 3g >= 8^(m-g) for m <= 10), so the
# rows sort to the tail and no cell range at any level reaches them
SENTINEL_CODE = 1 << 30


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of x over 30 bits (int64: torch has almost
    no uint32 arithmetic; every intermediate stays below 2^31)."""
    x = x.to(torch.int64) & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_encode(ix, iy, iz) -> torch.Tensor:
    """3D Morton code (int64) from per-axis cell coords (< 1024 each)."""
    return _part1by2(ix) | (_part1by2(iy) << 1) | (_part1by2(iz) << 2)


@dataclass
class CellGrid:
    """Device-resident spatial index + slab payload, Morton-sorted.

    ``starts[g]`` has 8^(m-g)+1 entries; the particles of level-g cell c
    occupy sorted rows [starts[g][c], starts[g][c+1]). Positions keep their
    original coordinates (distances use min-image arithmetic); wrapped
    coordinates only assign cells.
    """
    m: int                    # finest level has 2^m cells per axis
    lo: torch.Tensor          # (3,) f32 box lower corner (center - period/2)
    period: torch.Tensor      # (3,) f32
    soa8t: torch.Tensor       # (8, payload_width(N + chunk)) f32 payload
    orig_idx: torch.Tensor    # (N,) i64 sorted row -> original file order
    starts: tuple             # per level g=0..m: (8^(m-g)+1,) i64
    chunk: int = CHUNK        # slab chunk: payload tail pad, K1 block width
    uniform_mass: float | None = None  # the single f32 mass value when
    #                           every particle's mass is bit-identical
    phi: torch.Tensor | None = None    # (N,) f32 sorted potentials, or None

    @property
    def n(self) -> int:
        return self.orig_idx.shape[0]

    @property
    def device(self) -> torch.device:
        return self.soa8t.device

    def pos_a(self) -> torch.Tensor:
        return self.soa8t[0:3, :self.n].T

    def mass_a(self) -> torch.Tensor:
        return self.soa8t[3, :self.n]

    def vel_a(self) -> torch.Tensor:
        return self.soa8t[4:7, :self.n].T

    def ptype_a(self) -> torch.Tensor:
        return self.soa8t[7, :self.n].to(torch.int32) & 0xF

    def mark_a(self) -> torch.Tensor:
        return (self.soa8t[7, :self.n].to(torch.int32) >> 4) > 0

    def file_rows(self, idx: torch.Tensor) -> torch.Tensor:
        """The file-order index of sorted rows ``idx`` (-1 stays -1)."""
        return torch.where(idx >= 0, self.orig_idx[idx.clamp(min=0).long()],
                           -1)

    def row_values(self, idx: torch.Tensor, row: int) -> torch.Tensor:
        """Payload row ``row`` at sorted rows ``idx`` (0 where idx is -1)."""
        return torch.where(idx >= 0, self.soa8t[row][idx.clamp(min=0).long()],
                           0.0)

    def ncell(self, level: int) -> int:
        return 1 << (self.m - level)

    def cell_size(self, level: int) -> torch.Tensor:
        return self.period / self.ncell(level)

    def period_np(self) -> np.ndarray:
        return self.period.cpu().numpy()

    # A grid as the engine sees it: one shard here; parallel.ShardedGrid
    # has several, each gathered at the same capacity K, so a merged row
    # holds parts * K slots.
    parts = 1

    def map_shards(self, fn) -> "CellGrid":
        """``fn`` applied to each shard: here, to the grid itself."""
        return fn(self)


def detect_uniform_mass(mass) -> float | None:
    """The single f32 mass value when every entry is bit-identical, else
    None (so_tpu.ops.grid.detect_uniform_mass on host arrays)."""
    m_np = np.asarray(mass, np.float32)
    if m_np.size and bool((m_np == m_np.flat[0]).all()):
        return float(m_np.flat[0])
    return None


def uniform_mass_on_device(mass: torch.Tensor) -> float | None:
    """detect_uniform_mass of a (N,) f32 tensor where it lies: the same
    ``==`` test (0.0 equals -0.0, NaN equals nothing), made on the tensor's
    device, and one read of the verdict and mass[0] together."""
    if mass.numel() == 0:
        return None
    same, first = torch.stack([(mass == mass[0]).all().to(mass.dtype),
                               mass[0]]).tolist()
    return first if same else None


def species_of_rows(rows: torch.Tensor, species_counts,
                    first_row: int = 0) -> torch.Tensor:
    """The int32 species of file rows ``first_row + rows`` from the
    header's (nsph, ndark, nstar), by ParticleSet.ptype's rule
    (kdParticleType, kd2.c:135-141): GAS below nsph, DARK below nsph +
    ndark, STAR past that, rows beyond the counts included. ``rows`` is
    compared as it is, against the bounds less ``first_row``."""
    nsph, ndark = int(species_counts[0]), int(species_counts[1])
    out = torch.full(rows.shape, STAR, dtype=torch.int32, device=rows.device)
    out.masked_fill_(rows < nsph + ndark - first_row, DARK)
    out.masked_fill_(rows < nsph - first_row, GAS)
    return out


def choose_m(n_particles: int) -> int:
    """Pick the finest level so mean cell occupancy ~= TARGET_OCCUPANCY."""
    if n_particles <= 1:
        return 0
    cells = max(1.0, n_particles / TARGET_OCCUPANCY)
    m = int(round(np.log2(cells ** (1.0 / 3.0))))
    return int(np.clip(m, 0, M_MAX))


def choose_chunk(n_particles: int, m: int) -> int:
    """Slab chunk from the occupancy ladder (so_tpu's rule, which the level
    selection's occupancy floor and the run alignment slack follow): 128
    when its floor (96) admits a strictly finer level than 256's (192), or
    when the selected level holds < 1.5 chunks per cell; else 256."""
    occ = [n_particles / (1 << (3 * (m - g))) for g in range(m + 1)]
    g96 = next((g for g, o in enumerate(occ) if o >= 96), m)
    g192 = next((g for g, o in enumerate(occ) if o >= 192), m)
    if g96 < g192 or occ[g192] < 384:
        return 128
    return 256


def payload_width(cols: int) -> int:
    """The payload's row stride for ``cols`` = N + chunk columns: rounded
    up to PAYLOAD_ALIGN floats."""
    return -(-cols // PAYLOAD_ALIGN) * PAYLOAD_ALIGN


def reads_in_16_bytes(soa8t: torch.Tensor) -> bool:
    """Whether every 4 columns of every payload row from a column that is a
    multiple of 4 are one aligned 16-byte group, as K3 reads them: a row
    stride that is a multiple of 4 floats (payload_width's is) and a
    16-byte aligned base."""
    return soa8t.stride(0) % 4 == 0 and soa8t.data_ptr() % 16 == 0


def pad_payload(soa: torch.Tensor, width: int) -> torch.Tensor:
    """``soa`` (8, w) f32 extended to (8, width) with pad columns: x=y=z=1e30,
    the rest 0."""
    pad = torch.zeros((8, width - soa.shape[1]), dtype=torch.float32,
                      device=soa.device)
    pad[0:3] = 1e30
    return torch.cat([soa.to(torch.float32), pad], dim=1)


def pack_soa8t(pos, mass, vel, ptype, mark, chunk: int) -> torch.Tensor:
    """The padded, transposed (8, payload_width(N + chunk)) payload (rows
    4-6 hold RAW velocities; the kernels form m*v themselves)."""
    meta = (ptype.to(torch.int32) | (mark.to(torch.int32) << 4)).to(torch.float32)
    soa = torch.stack([pos[:, 0], pos[:, 1], pos[:, 2], mass,
                       vel[:, 0], vel[:, 1], vel[:, 2], meta], dim=0)
    return pad_payload(soa, payload_width(pos.shape[0] + chunk))


def _level_starts(code_s: torch.Tensor, m: int) -> tuple:
    starts = []
    for g in range(m + 1):
        ncg3 = 1 << (3 * (m - g))
        cg = code_s >> (3 * g)
        starts.append(torch.searchsorted(
            cg, torch.arange(ncg3 + 1, dtype=torch.int64, device=cg.device),
            side="left"))
    return tuple(starts)


def build_grid(pos, mass, vel=None, phi=None, ptype=None, mark=None,
               period=(1.0, 1.0, 1.0), center=(0.0, 0.0, 0.0),
               m: int | None = None, chunk: int | None = None,
               valid=None, *, device, species_counts=None,
               first_row: int = 0) -> CellGrid:
    """Build the grid from host particle arrays on ``device`` ("cuda" or
    "cpu"; no default, so a run never lands on a device by accident).

    ``period``/``center`` follow the reference's -p / -c / -cx/-cy/-cz
    flags (defaults period=1^3, center=0^3). ``m`` and ``chunk`` default
    to choose_m and choose_chunk of the particle count. Rows where the
    bool mask ``valid`` is False (a particle shard's padding) get a Morton
    code past every cell: they sort to the tail and no cell, so no gather,
    reaches them.

    The species come from a ``ptype`` array (one int a row, uploaded), or
    from ``species_counts``, the header's (nsph, ndark, nstar): row i is
    then file row ``first_row + i`` and its species is formed on the
    device from the sorted order (species_of_rows), padding rows 0; with
    neither, every species is 0. ``uniform_mass`` is tested on the device
    (uniform_mass_on_device). Spans: grid.upload (the host arrays to the
    device and the uniform-mass test), grid.sort (Morton codes, the stable
    argsort, the level starts), grid.ptype (the species in sorted order)
    and grid.payload (the payload and phi in sorted order).
    """
    if ptype is not None and species_counts is not None:
        raise ValueError("build_grid takes a ptype array or species_counts, "
                         "not both")
    device = torch.device(device)
    f32 = dict(dtype=torch.float32, device=device)
    with span("grid.upload"):
        mass = torch.as_tensor(np.asarray(mass, np.float32), device=device)
        um = uniform_mass_on_device(mass)
        pos = torch.as_tensor(np.asarray(pos, np.float32), device=device)
        n = pos.shape[0]
        vel = (torch.zeros((n, 3), **f32) if vel is None else
               torch.as_tensor(np.asarray(vel, np.float32), device=device))
        if ptype is not None:
            ptype = torch.as_tensor(np.asarray(ptype, np.int32),
                                    device=device)
        mark = (torch.zeros(n, dtype=torch.bool, device=device)
                if mark is None else
                torch.as_tensor(np.asarray(mark, bool), device=device))
        period = torch.as_tensor(np.asarray(period, np.float32),
                                 device=device)
        center = torch.as_tensor(np.asarray(center, np.float32),
                                 device=device)
    lo = center - period * 0.5
    if m is None:
        m = choose_m(n)
    if chunk is None:
        chunk = choose_chunk(n, m)

    with span("grid.sort"):
        nc = 1 << m
        u = pos - lo
        u = u - torch.floor(u / period) * period      # wrap to [0, period)
        ic = torch.clip((u / period * nc).to(torch.int32), 0, nc - 1)
        code = morton_encode(ic[:, 0], ic[:, 1], ic[:, 2])
        if valid is not None:
            valid = torch.as_tensor(np.asarray(valid, bool), device=device)
            code = torch.where(valid, code, SENTINEL_CODE)
        perm = torch.argsort(code, stable=True)
        starts = _level_starts(code[perm], m)
    with span("grid.ptype"):
        if ptype is not None:
            ptype_s = ptype[perm]
        elif species_counts is not None:
            ptype_s = species_of_rows(perm, species_counts, first_row)
            if valid is not None:       # padding rows keep meta 0
                ptype_s.masked_fill_(~valid[perm], 0)
        else:
            ptype_s = torch.zeros(n, dtype=torch.int32, device=device)
    with span("grid.payload"):
        soa8t = pack_soa8t(pos[perm], mass[perm], vel[perm], ptype_s,
                           mark[perm], chunk=chunk)
        phi_s = (None if phi is None else
                 torch.as_tensor(np.asarray(phi, np.float32),
                                 device=device)[perm])
    return CellGrid(m, lo, period, soa8t, perm, starts, chunk=chunk,
                    uniform_mass=um, phi=phi_s)


def grid_from_arrays(m: int, lo, period, soa8t, orig_idx, starts,
                     chunk: int, uniform_mass: float | None, *,
                     device) -> CellGrid:
    """A port grid from another build's state as host arrays (the fields of
    so_tpu's CellGrid: m, lo, period, soa8t, orig_idx, starts[g], chunk,
    uniform_mass) — feeds both packages the identical index. so_tpu's
    (8, N + chunk) payload is padded to the port's stride."""
    device = torch.device(device)

    def f32(a):     # np.array copies: the caller's arrays may be read-only
        return torch.as_tensor(np.array(a, np.float32), device=device)

    def i64(a):
        return torch.as_tensor(np.array(a, np.int64), device=device)

    soa = f32(soa8t)
    return CellGrid(int(m), f32(lo), f32(period),
                    pad_payload(soa, payload_width(soa.shape[1])),
                    i64(orig_idx), tuple(i64(s) for s in starts),
                    chunk=int(chunk),
                    uniform_mass=None if uniform_mass is None
                    else float(uniform_mass))
