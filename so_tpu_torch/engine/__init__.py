from .conflicts import ConflictState, resolve_conflicts  # noqa: F401
from .derived import DerivedResult, compute_derived  # noqa: F401
from .members import extract_members  # noqa: F401
from .pipeline import SOParams, SORun, run_so  # noqa: F401
from .recenter import recenter_most_bound  # noqa: F401
from .solver import SolveResult, rvir_ladder, solve_rvir  # noqa: F401
