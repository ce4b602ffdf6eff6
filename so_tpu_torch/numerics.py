"""Numerics: Romberg integrator and the Numerical-Recipes index sort (copy
of so_tpu/numerics.py without its JAX Romberg, so the port imports
nothing of the JAX package).

Reference parity:
  - ``dromberg_o`` mirrors the open-interval midpoint Romberg ``dRombergO``
    (reference: romberg.c:16-65, MAXLEV 13), used by the cosmology module.
  - ``indexx`` reproduces the exact permutation of the NR ``indexx``
    quicksort-with-insertion (reference: nr.c:91-151), including its behavior
    on *tied keys*, because the reference processes halos in the order this
    sort emits (kd2.c:843-861) and the conflict protocol is order-dependent.
    For all-distinct keys any correct sort yields the same permutation, so a
    fast numpy argsort path is used; the faithful slow path only runs when
    ties are present.
"""

from __future__ import annotations

import numpy as np

MAXLEV = 13


def dromberg_o(func, a: float, b: float, eps: float) -> float:
    """Open-interval Romberg integration of ``func`` over (a, b).

    Mirrors dRombergO (reference: romberg.c:16-65): midpoint rule with 3x
    sample refinement and Richardson extrapolation in powers of 9, up to
    MAXLEV levels, converging to relative tolerance ``eps``.
    """
    tlk = np.zeros(MAXLEV + 1, dtype=np.float64)
    n = 1
    nsamples = 1
    tlk[0] = tllnew = (b - a) * func(0.5 * (b + a))
    tll = np.finfo(np.float32).max

    while abs((tllnew - tll) / tllnew) > eps and n < MAXLEV:
        nsamples *= 3
        deltax = (b - a) / nsamples
        tlktmp = tlk[0]
        tlk[0] = tlk[0] / 3.0
        for i in range(nsamples // 3):
            tlk[0] += deltax * func(a + (3 * i + 0.5) * deltax)
            tlk[0] += deltax * func(a + (3 * i + 2.5) * deltax)
        for i in range(n):
            tlknew = (9.0 ** (i + 1) * tlk[i] - tlktmp) / (9.0 ** (i + 1) - 1.0)
            tlktmp = tlk[i + 1]
            tlk[i + 1] = tlknew
        tll = tllnew
        tllnew = tlk[n]
        n += 1

    if abs((tllnew - tll) / tllnew) >= eps:
        raise ArithmeticError("Romberg integration did not converge")
    return float(tllnew)


# ---------------------------------------------------------------------------
# NR indexx (reference: nr.c:91-151)
# ---------------------------------------------------------------------------

_NR_M = 7
_NR_NSTACK = 50


def _indexx_nr(arr1: np.ndarray) -> np.ndarray:
    """Faithful port of the NR indexx permutation semantics (nr.c:91-151).

    ``arr1`` is 1-based (arr1[0] unused). Returns the 1-based index array
    (position 0 unused). Only used when keys contain ties; see indexx().
    """
    n = arr1.shape[0] - 1
    indx = np.arange(n + 1, dtype=np.int64)  # indx[j] = j, 1-based
    istack = np.zeros(_NR_NSTACK + 1, dtype=np.int64)
    jstack = 0
    l = 1
    ir = n
    while True:
        if ir - l < _NR_M:
            for j in range(l + 1, ir + 1):
                indxt = indx[j]
                a = arr1[indxt]
                i = j - 1
                while i >= 1:
                    if arr1[indx[i]] <= a:
                        break
                    indx[i + 1] = indx[i]
                    i -= 1
                indx[i + 1] = indxt
            if jstack == 0:
                break
            ir = istack[jstack]
            jstack -= 1
            l = istack[jstack]
            jstack -= 1
        else:
            k = (l + ir) >> 1
            indx[k], indx[l + 1] = indx[l + 1], indx[k]
            if arr1[indx[l + 1]] > arr1[indx[ir]]:
                indx[l + 1], indx[ir] = indx[ir], indx[l + 1]
            if arr1[indx[l]] > arr1[indx[ir]]:
                indx[l], indx[ir] = indx[ir], indx[l]
            if arr1[indx[l + 1]] > arr1[indx[l]]:
                indx[l + 1], indx[l] = indx[l], indx[l + 1]
            i = l + 1
            j = ir
            indxt = indx[l]
            a = arr1[indxt]
            while True:
                i += 1
                while arr1[indx[i]] < a:
                    i += 1
                j -= 1
                while arr1[indx[j]] > a:
                    j -= 1
                if j < i:
                    break
                indx[i], indx[j] = indx[j], indx[i]
            indx[l] = indx[j]
            indx[j] = indxt
            jstack += 2
            if jstack > _NR_NSTACK:
                raise RuntimeError("NSTACK too small in indexx")
            if ir - i + 1 >= j - l:
                istack[jstack] = ir
                istack[jstack - 1] = i
                ir = j - 1
            else:
                istack[jstack] = j - 1
                istack[jstack - 1] = l
                l = i
    return indx


def indexx(arr: np.ndarray) -> np.ndarray:
    """Index sort matching the reference's group scheduler (kd2.c:843-861).

    Takes a 0-based float array, returns a 0-based permutation ``perm`` such
    that arr[perm] is ascending, with the *same tie order* the NR indexx
    quicksort produces (the reference's halo processing order). Distinct keys
    take the fast numpy path; ties take the faithful NR path.
    """
    arr = np.asarray(arr)
    n = arr.shape[0]
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    if np.unique(arr).size == n:
        return np.argsort(arr, kind="stable")
    arr1 = np.concatenate([[np.float64(0)], arr.astype(arr.dtype)])
    # tie path: the C transliteration when available (~100x; the Python
    # quicksort costs ~100 ms at 16k keys, ~10 s at 1e6 — and float32
    # catalogs collide routinely at those sizes)
    from .native import indexx_native
    out = indexx_native(arr1)
    if out is None:
        out = _indexx_nr(arr1)
    return out[1:] - 1
