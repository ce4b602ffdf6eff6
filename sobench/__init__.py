"""The benchmark of so_tpu_torch (see sobench/README.md)."""
