"""so_tpu_torch solve_rvir against so_tpu solve_rvir and the brute-force
oracle on the CPU.

so_tpu builds its grid with the slab payload (pallas=True), so its solve
runs the Pallas slab kernel in interpret mode, as tests/test_pallas.py
does. code, mvir, rvir and j must agree bit for bit. d2cut is a
particle's d2: the port rounds every op of dx*dx + dy*dy + dz*dz (as the
reference's C loop and the CUDA kernel, built with -fmad=false, do),
while XLA:CPU contracts the sum into fma(dz, dz, fma(dx, dx, dy*dy)).
So each solved halo's d2cut is checked against both forms of the same
sorted rank: the port's against the per-op form, so_tpu's against the
fused form (the witness), and the two bit for bit wherever the forms
agree at that rank.
"""

import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from fixtures import make_clumpy_box  # noqa: E402
from reference_oracle import oracle_rvir  # noqa: E402

from so_tpu.engine.solver import solve_rvir as jax_solve_rvir  # noqa: E402
from so_tpu.ops import build_grid as jax_build_grid  # noqa: E402
from so_tpu_torch.engine.solver import solve_rvir  # noqa: E402
from so_tpu_torch.ops.grid import build_grid  # noqa: E402


def _clumpy(seed, uniform):
    rng = np.random.default_rng(seed)
    clumps = [
        dict(center=(0.1, 0.0, -0.1), n=1500, rmax=0.06, mass_total=0.2),
        dict(center=(-0.25, 0.3, 0.2), n=800, rmax=0.04, mass_total=0.08),
        dict(center=(0.45, 0.45, 0.45), n=400, rmax=0.03, mass_total=0.03),
    ]
    data = make_clumpy_box(rng, n_background=4000, clumps=clumps)
    if uniform:
        data["mass"] = np.full(data["mass"].shape,
                               np.float32(1.0 / data["mass"].size))
    centers = np.concatenate([
        np.array([c["center"] for c in clumps], np.float32),
        rng.uniform(-0.5, 0.5, (5, 3)).astype(np.float32)])
    rgtp = rng.uniform(0.01, 0.06, centers.shape[0]).astype(np.float32)
    return data, centers, rgtp, 178.0


def _errors(seed, uniform):
    # rgtp tiny -> -1; rgtp >= the ladder cap -> immediate -3; a uniform
    # box already below threshold at nMembers -> -2 (test_solver.py)
    rng = np.random.default_rng(seed)
    data = make_clumpy_box(rng, n_background=3000, clumps=[])
    centers = np.zeros((3, 3), np.float32)
    rgtp = np.asarray([1e-4, 0.9, 0.15], np.float32)
    return data, centers, rgtp, 178.0


def _minus3_run(seed, uniform):
    # -delta 1e-4: dense forever, the ladder runs out (errors_m3 golden)
    rng = np.random.default_rng(seed)
    clumps = [dict(center=(0.2, 0.2, 0.2), n=2000, rmax=0.06,
                   mass_total=0.25)]
    data = make_clumpy_box(rng, n_background=3000, clumps=clumps)
    centers = np.asarray([(0.2, 0.2, 0.2), (-0.3, 0.1, 0.0)], np.float32)
    rgtp = np.asarray([0.01, 0.02], np.float32)
    return data, centers, rgtp, 1e-4


def fma32(a, b, c):
    """f32 fused multiply-add, fl32(a*b + c) with one rounding: the f64
    product of two f32 values is exact, the f64 sum is rounded to odd
    (TwoSum error term), and rounding an odd-rounded 53-bit value to 24
    bits is the correct single rounding. Inputs are non-negative."""
    a, b, c = (np.asarray(v, np.float64) for v in (a, b, c))
    p = a * b
    s = p + c
    bv = s - p
    err = (p - (s - bv)) + (c - bv)
    bits = s.view(np.int64).copy()
    odd = (err != 0) & ((bits & 1) == 0)
    bits[odd] += np.where(err[odd] > 0, 1, -1)
    return bits.view(np.float64).astype(np.float32)


def d2_forms(pos, center, period):
    """(per-op, fused) d2 of every particle from ``center``: the port's
    one rounding per f32 op (numpy does not fuse), and XLA:CPU's
    fma(dz, dz, fma(dx, dx, dy*dy))."""
    p = np.asarray(period, np.float32)
    d = (center - p * np.round((center - pos) / p)) - pos
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    return x * x + y * y + z * z, fma32(z, z, fma32(x, x, y * y))


BOXES = {
    "general": (_clumpy, 11, False, (0, -1)),
    "uniform": (_clumpy, 11, True, (0, -1)),
    "errors": (_errors, 6, True, (-1, -2, -3)),   # background only: uniform
    "minus3_run": (_minus3_run, 99, False, (-3,)),
}


@pytest.mark.parametrize("name", sorted(BOXES))
def test_solve_matches_so_tpu(name):
    make, seed, uniform, codes = BOXES[name]
    data, centers, rgtp, thr = make(seed, uniform)
    period = (1.0, 1.0, 1.0)
    want = jax_solve_rvir(jax_build_grid(data["pos"], data["mass"], m=3,
                                         pallas=True),
                          centers, rgtp, thr)
    grid = build_grid(data["pos"], data["mass"], vel=data["vel"], m=3,
                      device="cpu")
    assert (grid.uniform_mass is not None) == uniform
    got = solve_rvir(grid, centers, rgtp, thr)
    assert set(codes) <= set(got.code.tolist())
    for f in ("code", "mvir", "rvir", "j"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    # d2cut: so_tpu's everywhere, except that a solved halo whose rank
    # j-1 reads differently under the two d2 forms carries the per-op
    # value in the port and the fused value in so_tpu
    port_d2cut = want.d2cut.copy()
    for h in np.nonzero(got.code == 0)[0]:
        per_op, fused = (np.sort(d) for d in
                         d2_forms(data["pos"], centers[h], period))
        k = got.j[h] - 1
        assert want.d2cut[h].view(np.int32) == fused[k].view(np.int32), h
        port_d2cut[h] = per_op[k]
    np.testing.assert_array_equal(got.d2cut.view(np.int32),
                                  port_d2cut.view(np.int32))
    for h in range(centers.shape[0]):
        ref = oracle_rvir(data["pos"], data["mass"], centers[h], rgtp[h],
                          period, thr, 8)
        assert got.code[h] == ref["code"], (h, got.code[h], ref)
        if ref["code"] != 0:
            continue
        assert got.mvir[h] == pytest.approx(ref["mvir"], rel=2e-5)
        assert got.rvir[h] == pytest.approx(ref["rvir"], rel=2e-5)
        assert abs(int(got.j[h]) - ref["j"]) <= 1


def test_capacity_escalation_matches_so_tpu():
    """A dense clump at a tiny first capacity: overflow -> x4 regathers
    and ladder growth take several rounds; results are path-independent.
    so_tpu runs its XLA row gather here (its slab kernel's interpret mode
    is covered above and agrees with it bit for bit, test_pallas.py)."""
    data, centers, rgtp, thr = _clumpy(23, False)
    want = jax_solve_rvir(jax_build_grid(data["pos"], data["mass"], m=3),
                          centers, rgtp, thr)
    grid = build_grid(data["pos"], data["mass"], m=3, device="cpu")
    got = solve_rvir(grid, centers, rgtp, thr, k0_cap=256)
    assert (got.kcap > 256).any()
    for f in ("code", "mvir", "rvir", "j"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)


def test_sqrt_rn_is_correctly_rounded():
    """The scan's d2^(3/2) and every derived radius use sqrt_rn because
    torch's vectorized CPU sqrt is an ulp off for some f32 inputs. The
    correctly rounded reference is the f64 sqrt rounded to f32 (53 >=
    2*24 + 2 bits, so that double rounding is innocuous)."""
    import torch

    from so_tpu_torch.ops.ieee import sqrt_rn

    x = np.random.default_rng(4).uniform(0.0, 1.0, 1 << 20).astype(np.float32)
    x[:3] = (0.0, np.inf, 1e-30)
    want = np.sqrt(x.astype(np.float64)).astype(np.float32).view(np.int32)
    plain = torch.sqrt(torch.as_tensor(x)).numpy().view(np.int32)
    if (plain == want).all():
        pytest.skip("torch.sqrt is correctly rounded on this CPU build")
    got = sqrt_rn(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want)
