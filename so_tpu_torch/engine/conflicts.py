"""Mass-ordered subsume/slurp/retain conflict protocol (port of
so_tpu/engine/conflicts.py resolve_conflicts).

Groups are processed in ascending input-GTP-mass order (kd2.c:864-895);
each successful group walks its interior particles in ascending distance
(kdTagParticles, kd2.c:663-720): an unowned particle is tagged; one owned
by B is SUBSUMED (B zeroed) when |posA-posB| <= RvirA, SLURPS A when
|posA-posB| <= RvirB, else is RETAINED by B (counted as ignored). The
walk runs in the port's native C pass (so_tpu_torch/native, a copy of
so_tpu's); there is no second implementation here, so a missing native
library is an error.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..native import conflict_pass_native


@dataclass
class ConflictState:
    """Post-protocol per-particle and per-group ownership state."""
    igrp: np.ndarray          # (N,) i32 final group id per particle (0 = none)
    n_subsumed: np.ndarray    # (N,) i32 — .sosub counters (kd2.c:639)
    n_ignored: np.ndarray     # (N,) i32 — .soign counters (kd2.c:714)
    mvir: np.ndarray          # (G,) f32 catalog Mvir after sub/slurp negation
    rvir: np.ndarray          # (G,) f32 catalog Rvir after -10*winner marking
    slurped_own: np.ndarray   # (G,) bool — slurped during own tagging
    groups_removed: int = 0   # iGroupsRemoved (kd2.c:692)
    groups_slurped: int = 0   # iGroupsSlurped (kd2.c:702)


def resolve_conflicts(index: np.ndarray, pos: np.ndarray, mvir: np.ndarray,
                      rvir: np.ndarray, code: np.ndarray, order: np.ndarray,
                      members: list, n_particles: int) -> ConflictState:
    """Run the protocol over all groups in ``order`` (numerics.indexx of
    the GTP masses). ``members[h]`` is halo h's distance-sorted interior
    original-index list, read only where code[h] == 0."""
    out = conflict_pass_native(np.asarray(index, np.int32),
                               np.asarray(pos, np.float32),
                               np.asarray(mvir, np.float32),
                               np.asarray(rvir, np.float32),
                               np.asarray(code, np.int32),
                               np.asarray(order, np.int64),
                               members, n_particles)
    if out is None:
        raise RuntimeError("the native conflict pass (so_tpu_torch/native) "
                           "could not be built or loaded: a C compiler is "
                           "needed")
    return ConflictState(**out)
