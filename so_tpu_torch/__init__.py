"""so_tpu_torch — the so_tpu spherical-overdensity engine on PyTorch + CUDA.

A port of the JAX package ``so_tpu`` (which stays the reference) to one
NVIDIA H100. Module layout and names mirror ``so_tpu`` so each counterpart
is easy to find:

  ops/grid.py          Morton-sorted multi-level cell grid + slab payload
  ops/gather.py        cell enumeration, the K1/K3 route and the sorted
                       slab gather
  ops/slab_gather.py   kernel K1 (csrc/slab_gather.cu) + its plain version
  ops/piece_gather.py  kernel K3 (csrc/piece_gather.cu), the run-level
                       piece gather of the giant tiers, + its plain version
  ops/seqsum.py        kernel K2 (csrc/seqsum.cu), serial f32 row cumsum
  engine/              solve, fused members + derived, conflicts, pipeline
  cli.py               the single-threshold command line

The host-only layer (io/ for tipsy, catalogs and writers; stats, units,
cosmology, numerics' NR indexx, native/ for the C conflict pass, version)
is the port's own copy of ``so_tpu``'s: nothing in this package imports
``so_tpu`` or jax.
"""

from .version import __version__

__all__ = ["__version__"]
