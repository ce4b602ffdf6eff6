from .grid import (CellGrid, build_grid, grid_from_arrays,  # noqa: F401
                   morton_encode)
from .gather import ragged_ball_gather, GatherResult  # noqa: F401
