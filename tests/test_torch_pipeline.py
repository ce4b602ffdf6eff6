"""so_tpu_torch run_so against so_tpu run_so on the CPU, and the port's
independence from jax.

so_tpu builds its grid with the slab payload (SO_TPU_PALLAS=1), so its
gathers run the Pallas slab kernel in interpret mode. Membership and
conflict counters must agree exactly, and so must every derived quantity
that does not read a particle's d2 bits. The quarter/half-mass radii,
Rmax and Vmax do, and XLA:CPU fuses d2's sum into fma's while the port
rounds every op (test_torch_solver.py): for each solved halo those are
re-derived in numpy from the 2*Rvir ball under both d2 forms, the port
held to the per-op form and so_tpu to the fused form, bit for bit.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)

from fixtures import make_clumpy_box  # noqa: E402
from test_torch_solver import d2_forms  # noqa: E402

from so_tpu.engine import SOParams as JaxParams, run_so as jax_run_so  # noqa: E402
from so_tpu.io.catalogs import GroupCatalog  # noqa: E402
from so_tpu.io.tipsy import DARK, GAS, MARK, STAR, ParticleSet, TipsyHeader  # noqa: E402
from so_tpu_torch.engine.pipeline import SOParams, run_so  # noqa: E402


def _box(uniform):
    rng = np.random.default_rng(404 if uniform else 808)
    clumps = [
        dict(center=(0.1, 0.1, 0.1), n=1800, rmax=0.07, mass_total=0.2),
        dict(center=(0.13, 0.12, 0.1), n=700, rmax=0.03, mass_total=0.05),
        dict(center=(-0.2, 0.25, -0.3), n=900, rmax=0.05, mass_total=0.08),
        dict(center=(0.48, -0.48, 0.2), n=600, rmax=0.04, mass_total=0.04),
    ]
    data = make_clumpy_box(rng, n_background=5000, clumps=clumps)
    n = data["pos"].shape[0]
    perm = rng.permutation(n)                # species spatially mixed
    for k in data:
        data[k] = data[k][perm]
    if uniform:
        data["mass"] = np.full(n, np.float32(1.0 / n))
        split = (0, n, 0)
    else:
        # gas lighter, stars heavier: serial sums mix unequal addends
        split = (n // 5, n - n // 5 - n // 7, n // 7)
        data["mass"][: split[0]] *= np.float32(0.3)
        data["mass"][n - split[2]:] *= np.float32(2.5)
    hdr = TipsyHeader(time=1.0, nbodies=n, ndim=3, nsph=split[0],
                      ndark=split[1], nstar=split[2])
    ps = ParticleSet(hdr, data["pos"], data["vel"], data["mass"],
                     data["phi"], np.zeros(n, np.float32))
    ps.mark = rng.uniform(size=n) < 0.3
    G = len(clumps) + 3
    centers = np.concatenate([
        np.array([c["center"] for c in clumps], np.float32),
        rng.uniform(-0.5, 0.5, (3, 3)).astype(np.float32)])
    rgtp = np.concatenate([[0.05, 0.02, 0.04, 0.03],
                           rng.uniform(0.005, 0.03, 3)]).astype(np.float32)
    gtp_mass = np.asarray([0.1, 0.01, 0.08, 0.04, 0.001, 0.002, 0.003],
                          np.float32)

    def catalog():
        return GroupCatalog(index=np.arange(1, G + 1, dtype=np.int32),
                            pos=centers.copy(), rgtp=rgtp, gtp_mass=gtp_mass,
                            n_in_gtp=G, gtp_time=1.0)
    return ps, catalog


def _d2_read_fields(pos, mass, center, rvir, mvir, fused, n_members=8):
    """(rmass, rmax, vmax) of one halo as derived_from_sorted forms them
    (kd2.c:537-569), from the 2*Rvir ball under one d2 form, grav 1."""
    d2 = d2_forms(pos, center, (1.0, 1.0, 1.0))[1 if fused else 0]
    fball = np.float32(2.0) * rvir
    sel = np.nonzero(d2 <= fball * fball)[0]
    order = sel[np.argsort(d2[sel], kind="stable")]
    d2_s = d2[order]
    cum = np.cumsum(mass[order], dtype=np.float32)
    rmass = []
    for f in (0.25, 0.5):
        ge = cum >= np.float32(f) * mvir
        rmass.append(np.sqrt(d2_s[np.argmax(ge) if ge.any() else -1]))
    r_s = np.sqrt(d2_s)
    vc = np.sqrt(cum / r_s)
    vc[: n_members - 1] = -np.inf
    jm = np.argmax(vc)
    return np.asarray(rmass, np.float32), r_s[jm], vc[jm]


@pytest.mark.parametrize("uniform", [False, True],
                         ids=["species_general", "uniform"])
def test_run_so_matches_so_tpu(uniform, monkeypatch):
    ps, catalog = _box(uniform)
    species = (DARK, GAS, STAR, MARK)
    monkeypatch.setenv("SO_TPU_PALLAS", "1")
    want = jax_run_so(ps, catalog(), JaxParams(threshold=178.0,
                                               species=species))
    got = run_so(ps, catalog(), SOParams(threshold=178.0, species=species,
                                         device="cpu"))
    assert (got.solve.code == 0).sum() >= 3
    for f in ("code", "mvir", "rvir", "j"):
        np.testing.assert_array_equal(getattr(got.solve, f),
                                      getattr(want.solve, f), err_msg=f)
    for f in ("igrp", "n_subsumed", "n_ignored", "mvir", "rvir",
              "slurped_own"):
        np.testing.assert_array_equal(getattr(got.conflicts, f),
                                      getattr(want.conflicts, f), err_msg=f)
    assert got.conflicts.groups_removed == want.conflicts.groups_removed
    assert got.conflicts.groups_slurped == want.conflicts.groups_slurped
    assert got.conflicts.groups_removed + got.conflicts.groups_slurped > 0
    for h, m in enumerate(want.members):
        if m is None:
            assert got.members[h] is None
        else:
            np.testing.assert_array_equal(got.members[h], m)
    np.testing.assert_array_equal(got.solve.vcm, want.solve.vcm)
    np.testing.assert_array_equal(got.derived.vcirc, want.derived.vcirc)
    for sp in species:
        np.testing.assert_array_equal(got.derived.profiles[sp],
                                      want.derived.profiles[sp])
    # the d2-reading fields: so_tpu's everywhere, except that each solved
    # halo kept after the conflict pass (derived rows of the others are
    # zero in both) carries the per-op witness in the port and the fused
    # one in so_tpu
    port = {f: getattr(want.derived, f).copy() for f in ("rmass", "rmax",
                                                         "vmax")}
    kept = (got.solve.code == 0) & ~got.conflicts.slurped_own
    for h in np.nonzero(kept)[0]:
        args = (ps.pos, ps.mass, catalog().pos[h], got.solve.rvir[h],
                got.solve.mvir[h])
        for f, w in zip(port, _d2_read_fields(*args, fused=True)):
            np.testing.assert_array_equal(getattr(want.derived, f)[h], w,
                                          err_msg=f"{f} {h}")
        for f, v in zip(port, _d2_read_fields(*args, fused=False)):
            port[f][h] = v
    for f, v in port.items():
        np.testing.assert_array_equal(getattr(got.derived, f), v, err_msg=f)
    assert got.stats == want.stats


def test_unported_options_raise():
    ps, catalog = _box(True)
    for kw in (dict(b_pot=True), dict(checkpoint="x.npz"),
               dict(profile_dir="trace"), dict(survey=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            run_so(ps, catalog(), SOParams(device="cpu", **kw))


def test_port_never_imports_jax(tmp_path):
    """A full CPU run through the port's CLI leaves jax unimported."""
    code = f"""
import sys
sys.path.insert(0, {HERE!r})
import so_tpu_torch.cli
from scenarios import generate_inputs
args = generate_inputs("errors", {str(tmp_path)!r})
d = {str(tmp_path)!r}
rc = so_tpu_torch.cli.main(["-i", d + "/cat.gtp", "-o", d + "/got",
                            "--tipsy", d + "/snap.bin", "--device", "cpu"]
                           + args)
assert rc == 0
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
print("JAX_FREE")
"""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "JAX_FREE" in r.stdout
    assert os.path.exists(tmp_path / "got.sogrp")
