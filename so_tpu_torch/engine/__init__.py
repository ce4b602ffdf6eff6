from .pipeline import SOParams, SORun, run_so  # noqa: F401
from .solver import SolveResult, solve_rvir  # noqa: F401
