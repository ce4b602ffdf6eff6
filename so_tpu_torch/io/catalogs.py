"""Catalog readers: GTP group centers, -list subsets, SKID .stat, mark files
(copy of so_tpu/io/catalogs.py, so the port imports nothing of the JAX
package).

Reference behavior reproduced:
  - GTP files are star-only tipsy files; presence of dark/gas aborts
    (kdReadGTPList, kd2.c:220-223).
  - Per group: pos, fRgtp = eps, fGTPMass = mass, 1-based ``index``
    (kd2.c:244-281). With a -list file, groups are taken in *list order*
    (indices into the GTP file, 1-based); the -M minimum-mass filter applies
    in both paths (kd2.c:248, 266).
  - .stat lines are ``grpnum int 16*float x y z``; centers are replaced by
    sequential matching against the group list (kdReadStat, kd2.c:287-315).
  - Mark files are ASCII ``n g s`` header + 1-based particle indices
    (kdReadMark, kd2.c:144-169).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .tipsy import STAR_DTYPE, read_header


@dataclass
class GroupCatalog:
    """The GRPNODE list (reference: kd2.h:86-102) in SoA form."""
    index: np.ndarray      # (G,) int32, 1-based group id from the input GTP
    pos: np.ndarray        # (G, 3) float32 centers (mutable: -stat/-pot recentre)
    rgtp: np.ndarray       # (G,) float32 input radius (eps field)
    gtp_mass: np.ndarray   # (G,) float32 input mass (drives processing order)
    n_in_gtp: int          # total entries in the input GTP file (kd2.c:281)
    gtp_time: float        # header time of the input GTP file

    @property
    def n(self) -> int:
        return self.index.shape[0]


def read_gtp_list(gtp_path: str, list_path: str | None = None,
                  f_min_mass: float = 0.0, standard: bool = False) -> GroupCatalog:
    """Read candidate halo centers — reference: kdReadGTPList, kd2.c:171-284."""
    with open(gtp_path, "rb") as fp:
        h = read_header(fp, standard)
        if h.ndark > 0 or h.nsph > 0:
            raise ValueError(
                " FILE TYPE MISMATCH: GTP file contains non-star particles!")
        dt = STAR_DTYPE[standard]
        buf = fp.read(dt.itemsize * h.nstar)
        if len(buf) != dt.itemsize * h.nstar:
            raise EOFError("GTP file truncated")
        rec = np.frombuffer(buf, dtype=dt)

    mass = rec["mass"].astype(np.float32)
    pos = rec["pos"].astype(np.float32)
    eps = rec["eps"].astype(np.float32)

    if list_path is not None:
        with open(list_path, "r") as f:
            fof = np.array([int(t) for t in f.read().split()], dtype=np.int64)
        sel0 = fof - 1  # list entries are 1-based GTP indices (kd2.c:248)
        keep = mass[sel0] >= np.float32(f_min_mass)
        sel0 = sel0[keep]
        index = fof[keep].astype(np.int32)
    else:
        keep = mass >= np.float32(f_min_mass)
        sel0 = np.nonzero(keep)[0]
        index = (sel0 + 1).astype(np.int32)

    return GroupCatalog(
        index=index,
        pos=np.ascontiguousarray(pos[sel0]),
        rgtp=np.ascontiguousarray(eps[sel0]),
        gtp_mass=np.ascontiguousarray(mass[sel0]),
        n_in_gtp=h.nstar,
        gtp_time=h.time,
    )


def read_stat(cat: GroupCatalog, stat_path: str) -> int:
    """Replace centers with most-bound-particle positions from a SKID .stat.

    Sequential matching against the group list exactly as kdReadStat
    (kd2.c:297-312): each line whose grpnum equals the next unmatched
    group's index replaces that group's center. Returns the number
    replaced; the caller must verify it equals cat.n (so.c:527-534).
    """
    with open(stat_path, "r") as fp:
        toks = fp.read().split()
    k = 0
    # token-stream records of 21 fields, exactly like the fscanf sequence
    # grpnum int 16*float x y z (kd2.c:298-302)
    for off in range(0, len(toks) - 20, 21):
        grpnum = int(toks[off])
        if k < cat.n and grpnum == int(cat.index[k]):
            cat.pos[k] = [np.float32(toks[off + 18]), np.float32(toks[off + 19]),
                          np.float32(toks[off + 20])]
            k += 1
    return k


def read_mark(mark_path: str, n_particles: int) -> tuple[np.ndarray, int]:
    """Read a mark file into a boolean mask — reference: kdReadMark, kd2.c:144-169.

    Format: one ASCII header line ``nbodies ngas nstar`` then 1-based
    particle indices. Returns (mask, count-of-mark-lines); like the
    reference, duplicate indices are counted once in the mask but every
    line increments the count.
    """
    with open(mark_path, "r") as f:
        data = np.array([int(t) for t in f.read().split()], dtype=np.int64)
    idx = data[3:] - 1  # skip the 3 header ints; mark indexing is 1-based
    if idx.size and (idx.min() < 0 or idx.max() >= n_particles):
        raise ValueError("mark file index out of range")
    mask = np.zeros(n_particles, dtype=bool)
    mask[idx] = True
    return mask, int(idx.size)
