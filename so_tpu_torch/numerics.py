"""Numerics: Romberg integrator and the Numerical-Recipes index sort (copy
of so_tpu/numerics.py, so the port imports nothing of the JAX package;
its batched JAX Romberg is romberg_torch here).

Reference parity:
  - ``dromberg_o`` mirrors the open-interval midpoint Romberg ``dRombergO``
    (reference: romberg.c:16-65, MAXLEV 13), used by the cosmology module.
  - ``romberg_torch`` is a batched tensor re-expression of the same rule
    with a fixed depth and convergence masking (so_tpu's romberg_jax).
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
import torch

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


def tensor_device(device, *xs) -> torch.device:
    """``device`` if given, else that of the first tensor among ``xs``,
    else the card: host values go to "cuda" unless the CPU is asked for."""
    if device is not None:
        return torch.device(device)
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cuda")


def romberg_torch(func, a, b, eps: float = 1e-7, max_lev: int = 9, *,
                  dtype=torch.float32, device=None):
    """Batched Romberg on tensors: dromberg_o's midpoint/extrapolation rule
    (so_tpu's romberg_jax). ``func`` is an elementwise torch function;
    ``a``/``b`` broadcast. Every level runs with a convergence mask, and
    each element keeps its first converged extrapolant, which is what the
    early-exiting reference loop (romberg.c:28-60) returns. Depth 9 (3^8
    midpoint samples at the deepest level) covers the cosmology
    integrands; computed in ``dtype`` (f32, JAX's default, unless asked)
    on ``device`` (tensor_device's rule).
    """
    device = tensor_device(device, a, b)
    a = torch.as_tensor(a, dtype=dtype, device=device)
    b = torch.as_tensor(b, dtype=dtype, device=device)
    a, b = torch.broadcast_tensors(a, b)

    tlk = [torch.zeros_like(a)] * (max_lev + 1)
    tlk[0] = (b - a) * func(0.5 * (b + a))
    tllnew = tlk[0]
    tll = torch.full_like(a, torch.finfo(torch.float32).max)
    result = tllnew
    converged = torch.zeros(a.shape, dtype=torch.bool, device=a.device)

    nsamples = 1
    for n in range(1, max_lev):
        newly = torch.abs((tllnew - tll) / tllnew) <= eps
        result = torch.where(newly & ~converged, tllnew, result)
        converged = converged | newly

        nsamples *= 3
        deltax = (b - a) / nsamples
        tlktmp = tlk[0]
        i = torch.arange(nsamples // 3, dtype=dtype, device=a.device)
        x1 = a[..., None] + (3 * i + 0.5) * deltax[..., None]
        x2 = a[..., None] + (3 * i + 2.5) * deltax[..., None]
        tlk[0] = tlk[0] / 3.0 + deltax * (func(x1).sum(-1) + func(x2).sum(-1))
        for i2 in range(n):
            tlknew = ((9.0 ** (i2 + 1) * tlk[i2] - tlktmp)
                      / (9.0 ** (i2 + 1) - 1.0))
            tlktmp = tlk[i2 + 1]
            tlk[i2 + 1] = tlknew
        tll = tllnew
        tllnew = tlk[n]

    newly = torch.abs((tllnew - tll) / tllnew) <= eps
    result = torch.where(newly & ~converged, tllnew, result)
    converged = converged | newly
    return torch.where(converged, result, tllnew)


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
