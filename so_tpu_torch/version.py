"""Version strings (copy of so_tpu/version.py, so the port imports nothing
of the JAX package)."""

__version__ = "0.1.0"

# Version banner parity: the reference prints "SO Release 1.7: Jeff Gardner,
# May 2003" to stderr (so.c:208) and stamps "#SO v1.61: Jeff Gardner, April
# 2002" into the .sovcirc header (a stale string, so.c:491). We reproduce the
# .sovcirc header string verbatim for byte-compatible catalogs and print our
# own banner to stderr.
REFERENCE_BANNER = "SO Release 1.7: Jeff Gardner, May 2003"
SOVCIRC_HEADER_VERSION = "#SO v1.61: Jeff Gardner, April 2002"
BANNER = (f"so_tpu_torch {__version__} (PyTorch/CUDA SO engine; "
          "reference parity: SO 1.7)")
