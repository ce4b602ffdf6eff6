"""so_tpu_torch — the so_tpu spherical-overdensity engine on PyTorch + CUDA.

A port of the JAX package ``so_tpu`` (which stays the reference) to one
NVIDIA H100. Module layout and names mirror ``so_tpu`` so each counterpart
is easy to find:

  ops/grid.py         Morton-sorted multi-level cell grid + slab payload
  ops/gather.py       cell enumeration and the sorted slab gather
  ops/slab_gather.py  kernel K1 (csrc/slab_gather.cu) + its plain version
  ops/seqsum.py       kernel K2 (csrc/seqsum.cu), serial f32 row cumsum
  engine/             solve, fused members + derived, conflicts, pipeline
  cli.py              the single-threshold command line

The host-only layer (tipsy/catalog IO, writers, stats, units, cosmology,
NR indexx, the native conflict pass) is imported from ``so_tpu``; none of
it imports jax, and nothing in this package does either.
"""

from so_tpu.version import __version__

__all__ = ["__version__"]
