"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Every source under ``so_tpu_torch/csrc`` is compiled by ``nvcc`` into ONE
shared library with a plain C interface, loaded with ctypes. The library
lands in ``so_tpu_torch/_build/`` (git-ignored) under a name keyed by a
hash of the sources and flags, so an edited kernel rebuilds on its next
use and an unchanged one loads in milliseconds. Nothing here runs at
import time: the first CUDA launch builds.

Flags: ``-fmad=false`` forbids FMA contraction (the kernels reproduce the
JAX package's f32 arithmetic bit for bit); ``--use_fast_math`` is never
used.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    # (soa, np_cols, a0, lo, hi, n_total, nc, centers, period, r2, B, K,
    #  chunk, nchan, c0..c4, out, out_idx, stream)
    "so_slab_gather": [_P, _L, _P, _P, _P, _P, _I, _P, _P, _P, _L, _L, _I,
                       _I, _I, _I, _I, _I, _I, _P, _P, _P],
    # (soa, np_cols, src, t0, v, lo, hi, n_pieces, n_chunks, np_max,
    #  centers, period, r2, B, K, chunk, nchan, c0..c4, out, out_idx, stream)
    "so_piece_gather": [_P, _L, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P,
                        _L, _L, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    # (x, y, n_valid, B, K, rows, stream)
    "so_seqsum_rows": [_P, _P, _P, _L, _L, _I, _P],
}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found at {path}: set CUDA_HOME to the "
                           "CUDA toolkit that builds the so_tpu_torch kernels")
    return path


def library_path() -> Path:
    """The keyed output path for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"so_tpu_torch_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels if this source set has no library yet."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(s) for s in sorted(CSRC.glob("*.cu")))]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + " ".join(cmd) + "\n"
                           + r.stdout + r.stderr)
    os.replace(tmp, out)       # atomic: a concurrent loader never sees half
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
