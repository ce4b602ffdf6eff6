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
from scenarios import generate_inputs  # noqa: E402
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
    assert vars(got.stats) == vars(want.stats)   # the two packages' RunStats


@pytest.mark.parametrize("option,message", [
    (["--distributed"],
     "--distributed: no coordinator configured (set MASTER_ADDR, "
     "MASTER_PORT, WORLD_SIZE, RANK and LOCAL_RANK, or start the ranks "
     "with torchrun)"),
    (["--mesh", "2x1", "--distributed"],
     "--distributed cannot be combined with --mesh")])
def test_unported_options_raise(option, message, tmp_path, capsys,
                                monkeypatch):
    """--distributed without a coordinator exits 1 naming torchrun's
    variables, and with --mesh exits 1 with so_tpu's message; neither
    writes a file."""
    from so_tpu_torch.cli import main

    for v in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(v, raising=False)
    d = str(tmp_path)
    args = generate_inputs("basic", d)
    with pytest.raises(SystemExit) as e:
        main(["-i", d + "/cat.gtp", "-o", d + "/got", "--tipsy",
              d + "/snap.bin", "--device", "cpu"] + args + option)
    assert e.value.code == 1
    assert capsys.readouterr().err.strip().splitlines()[-1] == message
    assert not os.path.exists(d + "/got.sovcirc")


def test_port_never_imports_jax(tmp_path):
    """Full CPU runs through the port's CLI, plain, with -pot --deltas
    --survey, with --checkpoint, with --mesh 2x2 (so_tpu_torch.parallel)
    and as the one rank of a --distributed gloo group (torchrun's
    variables set; so_tpu_torch.parallel.driver), leave
    jax, so_tpu (any module) and bench unimported; the native conflict
    pass is the port's own library, built under so_tpu_torch/_build/ (so
    nothing is built into so_tpu/)."""
    import socket

    args = generate_inputs("errors", str(tmp_path))   # fixtures use so_tpu.io
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    code = f"""
import os, sys
import so_tpu_torch.cli
import so_tpu_torch.native as native
args = {args!r}
d = {str(tmp_path)!r}
base = ["-i", d + "/cat.gtp", "--tipsy", d + "/snap.bin", "--device", "cpu"]
assert so_tpu_torch.cli.main(base + ["-o", d + "/got"] + args) == 0
assert so_tpu_torch.cli.main(base + ["-o", d + "/multi", "-pot", "--deltas",
                                     "178,500", "--survey"] + args) == 0
assert so_tpu_torch.cli.main(base + ["-o", d + "/ck", "--checkpoint",
                                     d + "/state.npz"] + args) == 0
assert so_tpu_torch.cli.main(base + ["-o", d + "/mesh", "--mesh", "2x2"]
                             + args) == 0
assert "so_tpu_torch.parallel.mesh" in sys.modules
os.environ.update(MASTER_ADDR="localhost", MASTER_PORT="{port}",
                  WORLD_SIZE="1", RANK="0", LOCAL_RANK="0")
assert so_tpu_torch.cli.main(base + ["-o", d + "/dist", "--distributed"]
                             + args) == 0
assert "so_tpu_torch.parallel.driver" in sys.modules
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "so_tpu", "bench"))
assert not bad, bad
lib = native.get_lib()._name
assert lib == native.library_path() and os.path.exists(lib), lib
assert os.path.dirname(lib) == os.path.join(
    os.path.dirname(so_tpu_torch.__file__), "_build"), lib
print("JAX_FREE")
"""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "JAX_FREE" in r.stdout
    assert os.path.exists(tmp_path / "got.sogrp")
    assert os.path.exists(tmp_path / "multi.d500.sogrp")
    assert os.path.exists(tmp_path / "state.npz")
    assert os.path.exists(tmp_path / "mesh.sogrp")
    assert (tmp_path / "dist.sogrp").read_bytes() == \
        (tmp_path / "got.sogrp").read_bytes()
