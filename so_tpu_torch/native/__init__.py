"""ctypes bindings for the C runtime components (so_native.c; copy of
so_tpu/native with its own build).

The shared library is built on first use with the system compiler (no
pybind11 dependency) into ``so_tpu_torch/_build/`` (git-ignored), under a
name keyed by a hash of the source and flags, never beside the source; if
no compiler is available the callers fall back to the pure-numpy
implementations (the conflict pass has none and raises).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

from ..profiling import span

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "so_native.c")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_CFLAGS = ("-O3", "-shared", "-fPIC")

_lib = None
_tried = False


def library_path() -> str:
    """The keyed output path for the current source and flags."""
    h = hashlib.sha256(" ".join(_CFLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(_BUILD_DIR, f"so_native_{h.hexdigest()[:16]}.so")


def _build(out: str) -> bool:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    for cc in ("cc", "gcc", "clang"):
        try:
            r = subprocess.run([cc, *_CFLAGS, "-o", tmp, _SRC],
                               capture_output=True, text=True, timeout=120)
        except (FileNotFoundError, subprocess.TimeoutExpired):
            continue
        if r.returncode == 0:
            os.replace(tmp, out)   # atomic: a concurrent loader never sees half
            return True
    return False


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    out = library_path()
    try:
        if not os.path.exists(out) and not _build(out):
            return None
        lib = ctypes.CDLL(out)
    except OSError:
        return None

    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.so_conflict_pass.restype = ctypes.c_int
    lib.so_conflict_pass.argtypes = [
        ctypes.c_int64, i32p, f32p, f32p, f32p, i32p, i64p, i64p, i64p,
        ctypes.c_int64, i64p, ctypes.c_int64, i32p, i32p, i32p, u8p, i64p]
    lib.so_write_int_array.restype = ctypes.c_int
    lib.so_write_int_array.argtypes = [ctypes.c_char_p, i32p, ctypes.c_int64]
    lib.so_write_int_array_segment.restype = ctypes.c_int
    lib.so_write_int_array_segment.argtypes = [
        ctypes.c_char_p, i32p, ctypes.c_int64, ctypes.c_int64]
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.so_stats_pass.restype = ctypes.c_int
    lib.so_stats_pass.argtypes = [ctypes.c_int64, f32p, i32p, i32p, i32p,
                                  f64p, i64p]
    lib.so_indexx.restype = ctypes.c_int
    lib.so_indexx.argtypes = [ctypes.c_int64, f64p, i64p]
    _lib = lib
    return _lib


def _ptr(a, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def conflict_pass_native(index, pos, mvir, rvir, code, order, members,
                         n_particles):
    """Native mass-ordered conflict pass; returns the same fields as
    engine.conflicts.resolve_conflicts or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    with span("conflicts.prep"):
        G = index.shape[0]
        index = np.ascontiguousarray(index, np.int32)
        pos = np.ascontiguousarray(pos, np.float32)
        mvir = np.ascontiguousarray(mvir, np.float32).copy()
        rvir = np.ascontiguousarray(rvir, np.float32).copy()
        code = np.ascontiguousarray(code, np.int32)
        order = np.ascontiguousarray(order, np.int64)

        mem_off = np.zeros(G + 1, np.int64)
        for g in range(G):
            m = members[g]
            mem_off[g + 1] = mem_off[g] + (0 if m is None else m.size)
        mem = np.zeros(int(mem_off[-1]), np.int64)
        for g in range(G):
            m = members[g]
            if m is not None and m.size:
                mem[mem_off[g]:mem_off[g + 1]] = m

        max_id = int(index.max()) if G else 0
        id2row = np.full(max_id + 1, -1, np.int64)
        id2row[index] = np.arange(G, dtype=np.int64)

        igrp = np.zeros(n_particles, np.int32)
        n_sub = np.zeros(n_particles, np.int32)
        n_ign = np.zeros(n_particles, np.int32)
        slurped_own = np.zeros(G, np.uint8)
        counters = np.zeros(2, np.int64)

    with span("conflicts.walk"):
        rc = lib.so_conflict_pass(
            G, _ptr(index, ctypes.c_int32), _ptr(pos, ctypes.c_float),
            _ptr(mvir, ctypes.c_float), _ptr(rvir, ctypes.c_float),
            _ptr(code, ctypes.c_int32), _ptr(order, ctypes.c_int64),
            _ptr(mem_off, ctypes.c_int64), _ptr(mem, ctypes.c_int64),
            n_particles, _ptr(id2row, ctypes.c_int64), max_id,
            _ptr(igrp, ctypes.c_int32), _ptr(n_sub, ctypes.c_int32),
            _ptr(n_ign, ctypes.c_int32), _ptr(slurped_own, ctypes.c_uint8),
            _ptr(counters, ctypes.c_int64))
    if rc != 0:
        raise RuntimeError(f"so_conflict_pass failed: rc={rc}")
    return dict(igrp=igrp, n_subsumed=n_sub, n_ignored=n_ign, mvir=mvir,
                rvir=rvir, slurped_own=slurped_own.astype(bool),
                groups_removed=int(counters[0]),
                groups_slurped=int(counters[1]))


def stats_pass_native(mass, igrp, n_subsumed, n_ignored):
    """One-pass kdOutStats per-particle reductions (so_stats_pass);
    returns (fout[5], iout[4]) or None if the library is unavailable.
    fout: [cum_mass_sub, mass_sub, cum_mass_ign, mass_ign, particle_mass],
    iout: [cum_sub, particles_sub, cum_ign, particles_ign]."""
    lib = get_lib()
    if lib is None:
        return None
    mass = np.ascontiguousarray(mass, np.float32)
    igrp = np.ascontiguousarray(igrp, np.int32)
    nsub = np.ascontiguousarray(n_subsumed, np.int32)
    nign = np.ascontiguousarray(n_ignored, np.int32)
    fout = np.zeros(5, np.float64)
    iout = np.zeros(4, np.int64)
    with span("stats.native"):
        rc = lib.so_stats_pass(mass.shape[0], _ptr(mass, ctypes.c_float),
                               _ptr(igrp, ctypes.c_int32),
                               _ptr(nsub, ctypes.c_int32),
                               _ptr(nign, ctypes.c_int32),
                               _ptr(fout, ctypes.c_double),
                               _ptr(iout, ctypes.c_int64))
    if rc != 0:
        raise RuntimeError(f"so_stats_pass failed: rc={rc}")
    return fout, iout


def indexx_native(arr1) -> np.ndarray | None:
    """NR indexx over 1-based keys (so_indexx — the C transliteration of
    numerics._indexx_nr): returns the 1-based index array (slot 0 unused)
    or None if the library is unavailable. Bit-faithful to the Python
    port (tests/test_numerics.py fuzzes them against each other)."""
    lib = get_lib()
    if lib is None:
        return None
    arr1 = np.ascontiguousarray(arr1, np.float64)
    n = arr1.shape[0] - 1
    indx = np.zeros(n + 1, np.int64)
    rc = lib.so_indexx(n, _ptr(arr1, ctypes.c_double),
                       _ptr(indx, ctypes.c_int64))
    if rc != 0:
        raise RuntimeError(f"so_indexx failed: rc={rc}")
    return indx


def write_int_array_native(path: str, values) -> bool:
    lib = get_lib()
    if lib is None:
        return False
    v = np.ascontiguousarray(values, np.int32)
    rc = lib.so_write_int_array(path.encode(), _ptr(v, ctypes.c_int32),
                                v.shape[0])
    return rc == 0


def write_int_array_segment_native(path: str, values, offset: int) -> bool:
    """Write len(values) "%d\n" lines at a byte offset of an existing
    file (no header) — the per-host .sogrp segment write."""
    lib = get_lib()
    if lib is None:
        return False
    v = np.ascontiguousarray(values, np.int32)
    rc = lib.so_write_int_array_segment(
        path.encode(), _ptr(v, ctypes.c_int32), v.shape[0], int(offset))
    return rc == 0
