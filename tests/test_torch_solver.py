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


@pytest.mark.parametrize("uniform", [False, True],
                         ids=["general", "uniform"])
def test_capacity_escalation_matches_so_tpu(uniform):
    """A dense clump at a tiny first capacity: overflow -> x4 regathers
    and ladder growth take several rounds; results are path-independent,
    and ``progress`` reports the resolved count after each round. On
    uniform masses the scan reads the mass ladder, not K2.
    so_tpu runs its XLA row gather here (its slab kernel's interpret mode
    is covered above and agrees with it bit for bit, test_pallas.py)."""
    data, centers, rgtp, thr = _clumpy(23, uniform)
    want = jax_solve_rvir(jax_build_grid(data["pos"], data["mass"], m=3),
                          centers, rgtp, thr)
    grid = build_grid(data["pos"], data["mass"], m=3, device="cpu")
    assert (grid.uniform_mass is not None) == uniform
    seen = []
    got = solve_rvir(grid, centers, rgtp, thr, k0_cap=256,
                     progress=lambda done, total: seen.append((done, total)))
    assert (got.kcap > 256).any()
    # progress(resolved, G) after each round, as so_tpu's solve calls it
    assert len(seen) > 1 and seen[-1] == (centers.shape[0],) * 2
    assert all(a[0] <= b[0] for a, b in zip(seen, seen[1:]))
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


def vcm_bound(out, mass_s, vel_s):
    """Per halo and component, how far two f32 evaluations of scan_sorted's
    vcm may differ when they sum its n = jstar terms m*v in other orders:
    each sum is within (n - 1) 2^-24 sum|m v| of the exact one (Higham's
    bound for any order), and the quotient by Mvir adds a rounding."""
    n = out["jstar"].numpy().astype(np.float64)[:, None]
    slot = np.arange(mass_s.shape[1])[None, :]
    w = np.where(slot < n, mass_s.numpy().astype(np.float64), 0.0)
    absum = (w[:, :, None] * np.abs(vel_s.numpy())).sum(axis=1)
    mvir = out["mvir"].numpy().astype(np.float64)[:, None]
    with np.errstate(divide="ignore", invalid="ignore"):
        return (n + 2) * 2.0 ** -23 * absum / mvir


@pytest.fixture(scope="module")
def sorted_hits():
    """Distance-sorted hits of the general clumpy box (seed 11) at three
    times each halo's Rgtp, from the port's sorted gather: (d2, mass, vel,
    n_in, uniform mass, thr); the same arrays feed both packages."""
    import torch

    from so_tpu_torch.ops.gather import slab_gather

    data, centers, rgtp, thr = _clumpy(11, False)
    grid = build_grid(data["pos"], data["mass"], vel=data["vel"], m=3,
                      device="cpu")
    r = torch.as_tensor(rgtp * np.float32(3))
    sg = slab_gather(grid, 1, torch.as_tensor(centers), r, r * r, 8192, 7,
                     channels=("mass", "idx"))
    assert not sg.overflow.any()
    idx = sg.channels[1]
    vel = torch.where((idx >= 0)[..., None],
                      grid.vel_a()[idx.clamp(min=0).long()], 0.0)
    return sg.d2, sg.channels[0], vel, sg.n_in, float(data["mass"][0]), thr


@pytest.mark.parametrize("masses,with_vel,with_lad", [
    ("general", False, False), ("general", True, False),
    ("uniform", False, False), ("uniform", False, True),
    ("uniform", True, True)])
def test_scan_sorted_matches_so_tpu(sorted_hits, masses, with_vel, with_lad):
    """scan_sorted against so_tpu's on the same sorted hits: found, jstar,
    mvir and d2cut exactly. rvir is the f64 cube root of so_tpu's f32
    quotient rounded once (ops/ieee.cbrt_f32), within 2 ulp of so_tpu's:
    XLA:CPU's f32 cbrt is itself up to 2 ulp from the correctly rounded
    root. vcm within the f32 bound of two sums of the same n = jstar
    terms in other orders, (n + 2) 2^-23 sum|m v| / Mvir (so_tpu's XLA
    reduction orders them otherwise), zeros without vel_s.
    Uniform masses take the shared ladder, given (lad) or cached; uniform
    with vel_s passes the uniform per-slot masses too."""
    import torch

    import jax.numpy as jnp

    from so_tpu.engine.solver import scan_sorted as jax_scan_sorted
    from so_tpu_torch.engine.solver import FOUR_THIRDS_PI, scan_sorted

    d2, mass, vel, n_in, m0, thr = sorted_hits
    K = d2.shape[1]
    um = None
    if masses == "uniform":
        um = m0
        slot = torch.arange(K)[None, :]
        mass = torch.where(slot < n_in[:, None], torch.tensor(np.float32(um)),
                           0.0)
    mass_s = mass if (masses == "general" or with_vel) else None
    vel_s = vel if with_vel else None
    lad = (np.cumsum(np.full(K, np.float32(um), np.float32))
           if with_lad else None)
    got = scan_sorted(d2, mass_s, vel_s, n_in, thr, 8, uniform_m=um,
                      lad=None if lad is None else torch.as_tensor(lad))

    def j(t):
        return None if t is None else jnp.asarray(t.numpy())

    want = {k: np.asarray(v) for k, v in jax_scan_sorted(
        j(d2), j(mass_s), j(vel_s), jnp.asarray(n_in.numpy().astype(np.int32)),
        thr, 8, uniform_m=um,
        lad=None if lad is None else jnp.asarray(lad)).items()}
    found = got["found"].numpy()
    assert 0 < found.sum() < found.size
    np.testing.assert_array_equal(found, want["found"])
    np.testing.assert_array_equal(got["jstar"].numpy(), want["jstar"])
    for f in ("mvir", "d2cut"):
        np.testing.assert_array_equal(got[f].numpy().view(np.int32),
                                      want[f].view(np.int32), err_msg=f)
    rvir = got["rvir"].numpy()
    q = got["mvir"].numpy() / (FOUR_THIRDS_PI * np.float32(thr))
    np.testing.assert_array_equal(
        rvir, np.cbrt(q.astype(np.float64)).astype(np.float32))
    ulp = np.abs(rvir.view(np.int32).astype(np.int64)
                 - want["rvir"].view(np.int32))
    assert ulp.max() <= 2
    if with_vel:
        assert (np.abs(got["vcm"].numpy() - want["vcm"])[found]
                <= vcm_bound(got, mass_s, vel_s)[found]).all()
    else:
        assert not got["vcm"].numpy().any() and not want["vcm"].any()
    with pytest.raises(ValueError, match="mass_s"):
        scan_sorted(d2, None, vel, n_in, thr, 8, uniform_m=m0)
