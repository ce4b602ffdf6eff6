from .grid import CellGrid, build_grid, grid_from_arrays  # noqa: F401
