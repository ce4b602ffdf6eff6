"""Tipsy snapshot codec — numpy structured dtypes, no tirpc needed (copy
of so_tpu/io/tipsy.py, so the port imports nothing of the JAX package).

Two on-disk formats, as in the reference:
  - "native": raw little-endian C structs (reference: fread paths,
    kd2.c:337, 373, 389, 405). The header is 32 bytes: a double, five ints,
    and 4 bytes of tail padding from C struct alignment (tipsydefs.h:41-48).
  - "standard" (-std): XDR big-endian (reference: xdr_vector paths,
    kd2.c:330-335, 368-371; xdrHeader writes an explicit pad int,
    kd2.c:32-44). XDR encoding of float/int/double is plain big-endian
    IEEE, so a byte-order flip of the same dtypes reproduces it exactly.

Particle records (tipsydefs.h:6-39):
  gas  = 12 floats: mass pos[3] vel[3] rho temp hsmooth metals phi
  dark =  9 floats: mass pos[3] vel[3] eps phi
  star = 11 floats: mass pos[3] vel[3] metals tform eps phi
File order is gas, dark, star; iOrder is file position (kd2.c:360-361) and
particle species is recovered from iOrder ranges (kdParticleType,
kd2.c:135-141).
"""

from __future__ import annotations

import io as _io
from dataclasses import dataclass, field

import numpy as np


def header_dtype(standard: bool) -> np.dtype:
    bo = ">" if standard else "<"
    return np.dtype([
        ("time", bo + "f8"),
        ("nbodies", bo + "i4"),
        ("ndim", bo + "i4"),
        ("nsph", bo + "i4"),
        ("ndark", bo + "i4"),
        ("nstar", bo + "i4"),
        ("pad", bo + "i4"),
    ])


def _particle_dtype(standard: bool, fields) -> np.dtype:
    bo = ">" if standard else "<"
    out = []
    for name, count in fields:
        out.append((name, bo + "f4", (count,)) if count > 1 else (name, bo + "f4"))
    return np.dtype(out)


_GAS_FIELDS = [("mass", 1), ("pos", 3), ("vel", 3), ("rho", 1), ("temp", 1),
               ("hsmooth", 1), ("metals", 1), ("phi", 1)]
_DARK_FIELDS = [("mass", 1), ("pos", 3), ("vel", 3), ("eps", 1), ("phi", 1)]
_STAR_FIELDS = [("mass", 1), ("pos", 3), ("vel", 3), ("metals", 1), ("tform", 1),
                ("eps", 1), ("phi", 1)]

GAS_DTYPE = {False: _particle_dtype(False, _GAS_FIELDS), True: _particle_dtype(True, _GAS_FIELDS)}
DARK_DTYPE = {False: _particle_dtype(False, _DARK_FIELDS), True: _particle_dtype(True, _DARK_FIELDS)}
STAR_DTYPE = {False: _particle_dtype(False, _STAR_FIELDS), True: _particle_dtype(True, _STAR_FIELDS)}

# Species codes — reference: kd2.h:27-30
DARK, GAS, STAR, MARK = 1, 2, 4, 8


@dataclass
class TipsyHeader:
    time: float
    nbodies: int
    ndim: int
    nsph: int
    ndark: int
    nstar: int


@dataclass
class ParticleSet:
    """All particles of a snapshot, file-ordered (gas, dark, star).

    Mirrors the PINIT array the reference fills in kdReadTipsy
    (kd2.c:360-416): pos/vel/mass/phi for every species, temp for gas only
    (zero otherwise, kd2.c:393, 409).
    """
    header: TipsyHeader
    pos: np.ndarray    # (N, 3) float32
    vel: np.ndarray    # (N, 3) float32
    mass: np.ndarray   # (N,)  float32
    phi: np.ndarray    # (N,)  float32
    temp: np.ndarray   # (N,)  float32
    mark: np.ndarray | None = None  # (N,) bool, set by read_mark

    @property
    def n(self) -> int:
        return self.mass.shape[0]

    def ptype(self, iorder: np.ndarray) -> np.ndarray:
        """Species from file order — reference: kdParticleType, kd2.c:135-141."""
        h = self.header
        out = np.full(np.shape(iorder), STAR, dtype=np.int32)
        out = np.where(iorder < h.nsph + h.ndark, DARK, out)
        out = np.where(iorder < h.nsph, GAS, out)
        return out

    def ptype_all(self) -> np.ndarray:
        return self.ptype(np.arange(self.n, dtype=np.int64))


def _read_exact(fp, nbytes: int) -> bytes:
    buf = fp.read(nbytes)
    if len(buf) != nbytes:
        raise EOFError(f"tipsy stream truncated: wanted {nbytes} bytes, got {len(buf)}")
    return buf


def read_header(fp, standard: bool) -> TipsyHeader:
    dt = header_dtype(standard)
    h = np.frombuffer(_read_exact(fp, dt.itemsize), dtype=dt)[0]
    return TipsyHeader(time=float(h["time"]), nbodies=int(h["nbodies"]),
                       ndim=int(h["ndim"]), nsph=int(h["nsph"]),
                       ndark=int(h["ndark"]), nstar=int(h["nstar"]))


def read_tipsy(fp, standard: bool = False) -> ParticleSet:
    """Read a whole snapshot — reference: kdReadTipsy, kd2.c:318-421."""
    if isinstance(fp, (str, bytes)):
        with open(fp, "rb") as f:
            return read_tipsy(f, standard)
    h = read_header(fp, standard)
    ngas, ndark, nstar = h.nsph, h.ndark, h.nstar
    n = ngas + ndark + nstar

    pos = np.zeros((n, 3), np.float32)
    vel = np.zeros((n, 3), np.float32)
    mass = np.zeros(n, np.float32)
    phi = np.zeros(n, np.float32)
    temp = np.zeros(n, np.float32)

    def fill(lo, cnt, dt, has_temp):
        if cnt == 0:
            return
        rec = np.frombuffer(_read_exact(fp, dt.itemsize * cnt), dtype=dt)
        sl = slice(lo, lo + cnt)
        pos[sl] = rec["pos"].astype(np.float32)
        vel[sl] = rec["vel"].astype(np.float32)
        mass[sl] = rec["mass"].astype(np.float32)
        phi[sl] = rec["phi"].astype(np.float32)
        if has_temp:
            temp[sl] = rec["temp"].astype(np.float32)

    fill(0, ngas, GAS_DTYPE[standard], True)
    fill(ngas, ndark, DARK_DTYPE[standard], False)
    fill(ngas + ndark, nstar, STAR_DTYPE[standard], False)
    return ParticleSet(h, pos, vel, mass, phi, temp)


def read_tipsy_segment(path, start: int, count: int,
                       standard: bool = False) -> ParticleSet:
    """Read particles [start, start+count) of a snapshot (global file
    order: gas, dark, star) by seeking directly to the slice — each host
    of a sharded run reads only its own segment instead of the whole file
    (the reference is single-process and always reads everything,
    kdReadTipsy kd2.c:318-421; this is the multi-host extension).

    The returned ParticleSet carries the FULL header (so species
    boundaries stay global) but only ``count`` rows of particle data;
    species of row i is ``pset.ptype(start + i)``.
    """
    with open(path, "rb") as fp:
        h = read_header(fp, standard)
        hdr_size = header_dtype(standard).itemsize
        spans = [(h.nsph, GAS_DTYPE[standard], True),
                 (h.ndark, DARK_DTYPE[standard], False),
                 (h.nstar, STAR_DTYPE[standard], False)]
        n = h.nsph + h.ndark + h.nstar
        if not (0 <= start and start + count <= n):
            raise ValueError(f"segment [{start}, {start + count}) outside "
                             f"snapshot of {n} particles")

        pos = np.zeros((count, 3), np.float32)
        vel = np.zeros((count, 3), np.float32)
        mass = np.zeros(count, np.float32)
        phi = np.zeros(count, np.float32)
        temp = np.zeros(count, np.float32)

        base = hdr_size            # byte offset of the current species block
        glo = 0                    # global index of the block's first row
        end = start + count
        for cnt_sp, dt, has_temp in spans:
            lo = max(start, glo)
            hi = min(end, glo + cnt_sp)
            if lo < hi:
                fp.seek(base + (lo - glo) * dt.itemsize)
                rec = np.frombuffer(_read_exact(fp, dt.itemsize * (hi - lo)),
                                    dtype=dt)
                sl = slice(lo - start, hi - start)
                pos[sl] = rec["pos"].astype(np.float32)
                vel[sl] = rec["vel"].astype(np.float32)
                mass[sl] = rec["mass"].astype(np.float32)
                phi[sl] = rec["phi"].astype(np.float32)
                if has_temp:
                    temp[sl] = rec["temp"].astype(np.float32)
            base += cnt_sp * dt.itemsize
            glo += cnt_sp
    return ParticleSet(h, pos, vel, mass, phi, temp)


def write_header(fp, h: TipsyHeader, standard: bool) -> None:
    dt = header_dtype(standard)
    rec = np.zeros(1, dtype=dt)
    rec["time"] = h.time
    rec["nbodies"] = h.nbodies
    rec["ndim"] = h.ndim
    rec["nsph"] = h.nsph
    rec["ndark"] = h.ndark
    rec["nstar"] = h.nstar
    rec["pad"] = 0
    fp.write(rec.tobytes())


def write_tipsy_star(fp, time: float, star_records: np.ndarray, standard: bool) -> None:
    """Write a star-only tipsy file (the .sogtp shape — kd2.c:1267-1332).

    ``star_records`` is a structured array with STAR_DTYPE fields (any byte
    order); it is converted to the requested format.
    """
    if isinstance(fp, (str, bytes)):
        with open(fp, "wb") as f:
            write_tipsy_star(f, time, star_records, standard)
            return
    nstar = star_records.shape[0]
    write_header(fp, TipsyHeader(time=time, nbodies=nstar, ndim=3, nsph=0,
                                 ndark=0, nstar=nstar), standard)
    fp.write(star_records.astype(STAR_DTYPE[standard], copy=False).tobytes())


def make_star_records(n: int) -> np.ndarray:
    return np.zeros(n, dtype=STAR_DTYPE[False])


def write_tipsy(fp, header: TipsyHeader, gas: np.ndarray | None,
                dark: np.ndarray | None, star: np.ndarray | None,
                standard: bool) -> None:
    """General tipsy writer (fixture generation, round-trip tests)."""
    if isinstance(fp, (str, bytes)):
        with open(fp, "wb") as f:
            write_tipsy(f, header, gas, dark, star, standard)
            return
    write_header(fp, header, standard)
    if gas is not None and len(gas):
        fp.write(gas.astype(GAS_DTYPE[standard], copy=False).tobytes())
    if dark is not None and len(dark):
        fp.write(dark.astype(DARK_DTYPE[standard], copy=False).tobytes())
    if star is not None and len(star):
        fp.write(star.astype(STAR_DTYPE[standard], copy=False).tobytes())
