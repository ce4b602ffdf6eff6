"""Morton-sorted multi-level cell grid (port of so_tpu/ops/grid.py).

Particles are sorted once by Morton code on a 2^m-per-axis grid over the
periodic box; a level-g cell is then a contiguous range of the sorted rows
and one CSR ``starts`` array per level maps cell -> row range. The grid
always carries the transposed (8, N + chunk) slab payload that kernel K1
reads (rows x, y, z, mass, vx, vy, vz, meta; meta = species | mark << 4),
and nothing else per particle: the payload is a bit-exact encoding of
pos/mass/vel/ptype/mark, served back by the ``*_a()`` accessors.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# default slab chunk and its only alternative (choose_chunk)
CHUNK = 256
TARGET_OCCUPANCY = 24   # mean particles per finest cell (choose_m)
M_MAX = 9               # finest level choose_m picks


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
    soa8t: torch.Tensor       # (8, N + chunk) f32 payload
    orig_idx: torch.Tensor    # (N,) i64 sorted row -> original file order
    starts: tuple             # per level g=0..m: (8^(m-g)+1,) i64
    chunk: int = CHUNK        # slab chunk: payload tail pad, K1 block width
    uniform_mass: float | None = None  # the single f32 mass value when
    #                           every particle's mass is bit-identical

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

    def ncell(self, level: int) -> int:
        return 1 << (self.m - level)

    def cell_size(self, level: int) -> torch.Tensor:
        return self.period / self.ncell(level)

    def period_np(self) -> np.ndarray:
        return self.period.cpu().numpy()


def detect_uniform_mass(mass) -> float | None:
    """The single f32 mass value when every entry is bit-identical, else
    None (so_tpu.ops.grid.detect_uniform_mass on host arrays)."""
    m_np = np.asarray(mass, np.float32)
    if m_np.size and bool((m_np == m_np.flat[0]).all()):
        return float(m_np.flat[0])
    return None


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


def pack_soa8t(pos, mass, vel, ptype, mark, chunk: int) -> torch.Tensor:
    """The padded, transposed (8, N + chunk) payload (rows 4-6 hold RAW
    velocities; K1 forms m*v itself). Pad columns carry x=y=z=1e30."""
    meta = (ptype.to(torch.int32) | (mark.to(torch.int32) << 4)).to(torch.float32)
    soa = torch.stack([pos[:, 0], pos[:, 1], pos[:, 2], mass,
                       vel[:, 0], vel[:, 1], vel[:, 2], meta], dim=0)
    pad = torch.zeros((8, chunk), dtype=torch.float32, device=pos.device)
    pad[0:3] = 1e30
    return torch.cat([soa.to(torch.float32), pad], dim=1)


def _level_starts(code_s: torch.Tensor, m: int) -> tuple:
    starts = []
    for g in range(m + 1):
        ncg3 = 1 << (3 * (m - g))
        cg = code_s >> (3 * g)
        starts.append(torch.searchsorted(
            cg, torch.arange(ncg3 + 1, dtype=torch.int64, device=cg.device),
            side="left"))
    return tuple(starts)


def build_grid(pos, mass, vel=None, ptype=None, mark=None,
               period=(1.0, 1.0, 1.0), center=(0.0, 0.0, 0.0),
               m: int | None = None, *, device) -> CellGrid:
    """Build the grid from host particle arrays on ``device`` ("cuda" or
    "cpu"; no default, so a run never lands on a device by accident).

    ``period``/``center`` follow the reference's -p / -c / -cx/-cy/-cz
    flags (defaults period=1^3, center=0^3).
    """
    device = torch.device(device)
    f32 = dict(dtype=torch.float32, device=device)
    um = detect_uniform_mass(mass)
    pos = torch.as_tensor(np.asarray(pos, np.float32), device=device)
    n = pos.shape[0]
    mass = torch.as_tensor(np.asarray(mass, np.float32), device=device)
    vel = (torch.zeros((n, 3), **f32) if vel is None
           else torch.as_tensor(np.asarray(vel, np.float32), device=device))
    ptype = (torch.zeros(n, dtype=torch.int32, device=device) if ptype is None
             else torch.as_tensor(np.asarray(ptype, np.int32), device=device))
    mark = (torch.zeros(n, dtype=torch.bool, device=device) if mark is None
            else torch.as_tensor(np.asarray(mark, bool), device=device))
    period = torch.as_tensor(np.asarray(period, np.float32), device=device)
    center = torch.as_tensor(np.asarray(center, np.float32), device=device)
    lo = center - period * 0.5
    if m is None:
        m = choose_m(n)
    chunk = choose_chunk(n, m)

    nc = 1 << m
    u = pos - lo
    u = u - torch.floor(u / period) * period      # wrap to [0, period)
    ic = torch.clip((u / period * nc).to(torch.int32), 0, nc - 1)
    code = morton_encode(ic[:, 0], ic[:, 1], ic[:, 2])
    perm = torch.argsort(code, stable=True)
    starts = _level_starts(code[perm], m)
    soa8t = pack_soa8t(pos[perm], mass[perm], vel[perm], ptype[perm],
                       mark[perm], chunk=chunk)
    return CellGrid(m, lo, period, soa8t, perm, starts, chunk=chunk,
                    uniform_mass=um)


def grid_from_arrays(m: int, lo, period, soa8t, orig_idx, starts,
                     chunk: int, uniform_mass: float | None, *,
                     device) -> CellGrid:
    """A port grid from another build's state as host arrays (the fields of
    so_tpu's CellGrid: m, lo, period, soa8t, orig_idx, starts[g], chunk,
    uniform_mass) — feeds both packages the identical index."""
    device = torch.device(device)

    def f32(a):     # np.array copies: the caller's arrays may be read-only
        return torch.as_tensor(np.array(a, np.float32), device=device)

    def i64(a):
        return torch.as_tensor(np.array(a, np.int64), device=device)

    return CellGrid(int(m), f32(lo), f32(period), f32(soa8t).contiguous(),
                    i64(orig_idx), tuple(i64(s) for s in starts),
                    chunk=int(chunk),
                    uniform_mass=None if uniform_mass is None
                    else float(uniform_mass))
