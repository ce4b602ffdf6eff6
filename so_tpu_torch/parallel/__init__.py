"""Multi-device runs (port of so_tpu/parallel): halo x particle sharding
over an (H, P) mesh of torch devices, behind the CLI's --mesh HxP."""

from .mesh import (  # noqa: F401
    Mesh,
    ShardedGrid,
    build_sharded_grid,
    make_mesh,
    recenter_most_bound_sharded,
    run_so_multi_sharded,
    run_so_sharded,
    solve_rvir_multi_sharded,
    solve_rvir_sharded,
)
