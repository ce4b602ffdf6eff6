"""Build and load the hand-written CUDA kernels (csrc/*.cu, *.cuh).

Every ``.cu`` source under ``so_tpu_torch/csrc`` is compiled by its own
``nvcc`` (all started together) and the objects are linked into ONE shared
library with a plain C interface, loaded with ctypes. The library lands in
``so_tpu_torch/_build/`` (git-ignored) under a name keyed by a hash of the
sources, the headers and the flags, so an edited kernel or header rebuilds
on its next use and an unchanged one loads in milliseconds. Nothing here
runs at import time: the first CUDA launch builds.

Flags: ``-fmad=false`` forbids FMA contraction (the kernels reproduce the
JAX package's f32 arithmetic bit for bit); ``--use_fast_math`` is never
used.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from functools import lru_cache
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC")

_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    # (soa, np_cols, a0, lo, hi, n_total, nc, centers, period, r2, B, K,
    #  chunk, nchan, c0..c4, out, out_idx, stream)
    "so_slab_gather": [_P, _L, _P, _P, _P, _P, _I, _P, _P, _P, _L, _L, _I,
                       _I, _I, _I, _I, _I, _I, _P, _P, _P],
    # so_slab_gather's arguments with n_in and the block size before stream
    "so_slab_gather_sorted": [_P, _L, _P, _P, _P, _P, _I, _P, _P, _P, _L, _L,
                              _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _I, _P],
    # (soa, np_cols, src, t0, v, lo, hi, n_pieces, n_chunks, np_max,
    #  centers, period, r2, B, K, chunk, nchan, c0..c4, out, out_idx,
    #  pieces a block, stream)
    "so_piece_gather": [_P, _L, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P,
                        _L, _L, _I, _I, _I, _I, _I, _I, _I, _P, _P, _I, _P],
    # (x, y, n_valid, B, K, rows, stream)
    "so_seqsum_rows": [_P, _P, _P, _L, _L, _I, _P],
    # (centers, radii, r2_mask, lo, period, starts, B, ncg, S, align, st,
    #  cnt, q, total, mode, nc, piece_w, desc, desc_n, stream)
    "so_cell_ranges": [_P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _P, _P, _P,
                       _P, _I, _L, _I, _P, _P, _P],
    # (soa, stride, idx, counts, B, W, uniform mass, uniform, cut, NI, out,
    #  stream)
    "so_member_sums": [_P, _L, _P, _P, _L, _L, _F, _I, _P, _L, _P, _P],
}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found at {path}: set CUDA_HOME to the "
                           "CUDA toolkit that builds the so_tpu_torch kernels")
    return path


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """The keyed output path for the current sources, headers and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"so_tpu_torch_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels if this source set has no library yet: one
    nvcc per source, in parallel, then the link."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources()]
    cmds = [[nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
            for o, src in zip(objs, sources())]
    tmp = BUILD_DIR / f"{tag}.tmp"
    cmds.append([nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp),
                 *(str(o) for o in objs)])
    try:
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds[:-1]]
        results = [(c, p.communicate()[0], p.returncode)
                   for c, p in zip(cmds, procs)]
        if all(rc == 0 for _, _, rc in results):
            r = subprocess.run(cmds[-1], stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
            results.append((cmds[-1], r.stdout, r.returncode))
        for cmd, text, rc in results:
            if rc != 0:
                raise RuntimeError("nvcc failed:\n" + " ".join(cmd) + "\n"
                                   + text)
        os.replace(tmp, out)   # atomic: a concurrent loader never sees half
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    """Raise on a nonzero cudaGetLastError() returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {rc})")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def launch(device: torch.device, name: str, *args) -> None:
    """Call the library's entry point ``name`` with ``args`` and the
    device's current stream, with that device current (the runtime
    launches there, and a mesh puts shards on other cards than the
    current one); raise on a failed launch."""
    with torch.cuda.device(device):
        rc = getattr(library(), name)(*args, stream_ptr(device))
    check(rc, name)


@lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The card's streaming multiprocessors (the kernels' launch shapes
    follow it)."""
    return torch.cuda.get_device_properties(device).multi_processor_count
