"""Multi-device and multi-process runs (port of so_tpu/parallel): halo x
particle sharding over an (H, P) mesh of torch devices, behind the CLI's
--mesh HxP, and ranks of a torch.distributed group that each hold one
segment of the snapshot, behind --distributed."""

from .distributed import (  # noqa: F401
    TorchTransport,
    allgather_f64,
    allgather_varlen,
    build_sharded_grid_segment,
    default_backend,
    grid_segment,
    host_segment,
    init_distributed,
    make_multihost_mesh,
)
from .driver import (  # noqa: F401
    SegmentConflictState,
    SegRows,
    dist_conflict_fn,
    dist_stats_fn,
    dist_vcm_fn,
    recenter_most_bound_distributed,
    run_so_distributed,
    run_so_multi_distributed,
    seg_member_filter,
    write_array_file_segments,
)
from .mesh import (  # noqa: F401
    Mesh,
    ShardedGrid,
    build_sharded_grid,
    extract_members_sharded,
    make_mesh,
    recenter_most_bound_sharded,
    run_so_multi_sharded,
    run_so_sharded,
    solve_rvir_multi_sharded,
    solve_rvir_sharded,
)
