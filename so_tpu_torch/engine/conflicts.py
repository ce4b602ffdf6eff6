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


# ---------------------------------------------------------------------------
# Component decomposition (port of so_tpu/engine/conflicts.py:182-347)
#
# A group's walk reads and writes only (a) catalog columns of groups whose
# member lists share a particle row with its own and (b) per-particle state
# of rows in its component's lists. The serial mass-order walk therefore
# decomposes exactly over the connected components of the "groups sharing
# a member row" graph: walking each component's groups in the global order
# restricted to it gives the serial pass's bits. The --distributed driver
# shards the walk this way (parallel/driver.py dist_conflict_fn).
# ---------------------------------------------------------------------------


def union_find(G: int, edge_blocks) -> np.ndarray:
    """Root per group id after uniting the (a, b) pairs of ``edge_blocks``
    (flat int64 pair arrays) in order: the first of a pair's roots becomes
    the root. The same blocks in the same order give the same roots."""
    parent = np.arange(G, dtype=np.int64)

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    for blk in edge_blocks:
        for a, b in np.asarray(blk, np.int64).reshape(-1, 2):
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[rb] = ra
    return np.fromiter((find(g) for g in range(G)), np.int64, count=G)


def conflict_components(code: np.ndarray, members: list) -> np.ndarray:
    """Component label (its root group) per group; -1 for groups that never
    walk (error codes or empty member lists). Edges join the groups of
    equal rows after one stable sort of the concatenated (row, group)
    pairs."""
    G = len(members)
    active = np.asarray([g for g in range(G) if code[g] == 0
                         and members[g] is not None and members[g].size],
                        np.int64)
    edges = np.zeros((0, 2), np.int64)
    if active.size:
        rows = np.concatenate([np.asarray(members[g], np.int64)
                               for g in active])
        gids = np.repeat(active, [members[g].size for g in active])
        o = np.argsort(rows, kind="stable")
        rows_s, gids_s = rows[o], gids[o]
        same = rows_s[1:] == rows_s[:-1]
        edges = np.stack([gids_s[:-1][same], gids_s[1:][same]], axis=1)
    comp = np.full(G, -1, np.int64)
    comp[active] = union_find(G, [edges])[active]
    return comp


@dataclass
class SparseConflictRows:
    """Per-particle conflict outputs as (row, value) triplets over the
    walked components' rows only; every other row is (0, 0, 0). Components
    have disjoint row sets, so rows are unique and a scatter into zeroed
    dense arrays gives the serial pass's."""
    rows: np.ndarray          # (T,) i64 particle rows
    igrp: np.ndarray          # (T,) i32
    n_subsumed: np.ndarray    # (T,) i32
    n_ignored: np.ndarray     # (T,) i32
    own: np.ndarray           # (G,) bool: groups of the walked components
    mvir: np.ndarray          # (G,) f32, changed only at own groups
    rvir: np.ndarray          # (G,) f32, changed only at own groups
    slurped_own: np.ndarray   # (G,) bool (False outside own)
    groups_removed: int
    groups_slurped: int


def conflict_walk_sparse(index, pos, mvir, rvir, code, order, members,
                         comp: np.ndarray | None = None,
                         comp_sel=None) -> SparseConflictRows:
    """The component-decomposed walk with sparse per-particle output.

    ``comp_sel(component ids) -> mask`` restricts the walk to a subset of
    the components (a rank's share under --distributed); per-group columns
    are then meaningful only at ``own`` groups, whose masks are disjoint
    across the shares. A singleton component (a group that shares no row)
    cannot conflict: its members are tagged without a walk. Every other
    component runs the native pass over its own compacted rows."""
    G = index.shape[0]
    if comp is None:
        comp = conflict_components(code, members)
    mvir_out = np.asarray(mvir, np.float32).copy()
    rvir_out = np.asarray(rvir, np.float32).copy()
    own = np.zeros(G, bool)
    slurped_own = np.zeros(G, bool)
    removed = slurped = 0
    rows_l, ig_l, ns_l, ni_l = [], [], [], []

    roots, counts = np.unique(comp[comp >= 0], return_counts=True)
    if comp_sel is not None:
        keep = comp_sel(roots)
        roots, counts = roots[keep], counts[keep]
    keep_root = set(roots.tolist())
    single_roots = set(roots[counts == 1].tolist())
    rank = np.empty(G, np.int64)
    rank[np.asarray(order)] = np.arange(G)
    multi_groups = []
    for g in range(G):
        c = comp[g]
        if c < 0 or c not in keep_root:
            continue
        own[g] = True
        if c in single_roots:
            m = np.asarray(members[g], np.int64)
            rows_l.append(m)
            ig_l.append(np.full(m.size, np.int32(index[g]), np.int32))
            z = np.zeros(m.size, np.int32)
            ns_l.append(z)
            ni_l.append(z)
        else:
            multi_groups.append(g)

    multi_groups.sort(key=lambda g: rank[g])
    by_comp: dict = {}
    for g in multi_groups:
        by_comp.setdefault(comp[g], []).append(g)
    for gs in by_comp.values():
        gs = np.asarray(gs, np.int64)      # in global mass order
        rows_c = np.unique(np.concatenate([members[g] for g in gs]))
        mem_c = [np.searchsorted(rows_c, members[g]) for g in gs]
        st = resolve_conflicts(index[gs], pos[gs], mvir[gs], rvir[gs],
                               code[gs], np.arange(gs.size), mem_c,
                               rows_c.size)
        rows_l.append(rows_c)
        ig_l.append(st.igrp)
        ns_l.append(st.n_subsumed)
        ni_l.append(st.n_ignored)
        mvir_out[gs] = st.mvir
        rvir_out[gs] = st.rvir
        slurped_own[gs] = st.slurped_own
        removed += st.groups_removed
        slurped += st.groups_slurped

    def cat(ls, dt):
        return (np.concatenate(ls) if ls else np.zeros(0, dt)).astype(
            dt, copy=False)

    return SparseConflictRows(
        rows=cat(rows_l, np.int64), igrp=cat(ig_l, np.int32),
        n_subsumed=cat(ns_l, np.int32), n_ignored=cat(ni_l, np.int32),
        own=own, mvir=mvir_out, rvir=rvir_out, slurped_own=slurped_own,
        groups_removed=removed, groups_slurped=slurped)


def resolve_conflicts_components(index, pos, mvir, rvir, code, order,
                                 members, n_particles,
                                 comp: np.ndarray | None = None,
                                 comp_sel=None) -> ConflictState:
    """resolve_conflicts through the component decomposition (the same
    bits): conflict_walk_sparse scattered into zeroed dense arrays."""
    sp = conflict_walk_sparse(index, pos, mvir, rvir, code, order, members,
                              comp=comp, comp_sel=comp_sel)
    igrp = np.zeros(n_particles, np.int32)
    n_sub = np.zeros(n_particles, np.int32)
    n_ign = np.zeros(n_particles, np.int32)
    igrp[sp.rows] = sp.igrp
    n_sub[sp.rows] = sp.n_subsumed
    n_ign[sp.rows] = sp.n_ignored
    return ConflictState(igrp=igrp, n_subsumed=n_sub, n_ignored=n_ign,
                         mvir=sp.mvir, rvir=sp.rvir,
                         slurped_own=sp.slurped_own,
                         groups_removed=sp.groups_removed,
                         groups_slurped=sp.groups_slurped)
