"""The port's host layer (so_tpu_torch: io, stats, units, cosmology,
numerics, native, version) against so_tpu's on the same seeded numpy
input: byte-identical files, identical permutations, values and stats.
"""

import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import so_tpu.cosmology as jcos  # noqa: E402
import so_tpu.io.catalogs as jcat  # noqa: E402
import so_tpu.io.tipsy as jtipsy  # noqa: E402
import so_tpu.io.writers as jwriters  # noqa: E402
import so_tpu.numerics as jnum  # noqa: E402
import so_tpu.stats as jstats  # noqa: E402
import so_tpu.units as junits  # noqa: E402
import so_tpu.version as jversion  # noqa: E402
from so_tpu.engine.conflicts import resolve_conflicts as jax_conflicts  # noqa: E402

import so_tpu_torch.cosmology as tcos  # noqa: E402
import so_tpu_torch.io.catalogs as tcat  # noqa: E402
import so_tpu_torch.io.tipsy as ttipsy  # noqa: E402
import so_tpu_torch.io.writers as twriters  # noqa: E402
import so_tpu_torch.native as tnative  # noqa: E402
import so_tpu_torch.numerics as tnum  # noqa: E402
import so_tpu_torch.stats as tstats  # noqa: E402
import so_tpu_torch.units as tunits  # noqa: E402
import so_tpu_torch.version as tversion  # noqa: E402
from so_tpu_torch.engine.conflicts import resolve_conflicts  # noqa: E402


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture
def no_native(monkeypatch):
    """The port's native library reported missing: the numpy fallbacks."""
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_tried", True)


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_writers_byte_identical(native, tmp_path, request, monkeypatch):
    """.sovcirc (header, stats, profile notes, rows), .sodark, .sogrp and
    .sogtp from both packages' writers on the same arrays."""
    if not native:
        request.getfixturevalue("no_native")
    assert (tnative.get_lib() is not None) == native
    rng = np.random.default_rng(31)
    G, N = 40, 5000
    index = np.sort(rng.choice(60, G, replace=False) + 1).astype(np.int32)
    mvir = rng.uniform(1e-4, 0.1, G).astype(np.float32)
    mvir[::7] = -2.0
    rvir = rng.uniform(0.01, 0.2, G).astype(np.float32)
    rmass = rng.uniform(0.0, 0.1, (G, 2)).astype(np.float32)
    rmax, vmax = (rng.uniform(0.0, 1.0, G).astype(np.float32)
                  for _ in range(2))
    vcirc = rng.uniform(0.0, 2.0, (G, 8)).astype(np.float32)
    prof = rng.uniform(0.0, 0.1, (G, 16)).astype(np.float32)
    pos = rng.uniform(-0.5, 0.5, (G, 3)).astype(np.float32)
    vcm = rng.normal(size=(G, 3)).astype(np.float32)
    igrp = rng.integers(-5, 70, N).astype(np.int32)
    stats = jstats.compute_stats(
        rng.uniform(0.5, 1.5, N).astype(np.float32), igrp,
        rng.integers(0, 3, N).astype(np.int32),
        rng.integers(0, 2, N).astype(np.int32), mvir, 3, 1)
    for pkg, w, units, st, tag in (
            (jtipsy, jwriters, junits, jstats, "jax"),
            (ttipsy, twriters, tunits, tstats, "port")):
        u = units.unit_conversions(1e15, 50.0, 0.5)
        (tmp_path / tag).mkdir()
        monkeypatch.chdir(tmp_path / tag)
        base = "out"            # the .sovcirc names the profile file
        with open(base + ".sovcirc", "w") as fp:
            w.write_sovcirc_header(fp, 1.7e9, "cat.gtp", "list", None,
                                   np.float32(178.0), True, 0.5, 0.3, 0.7, 1,
                                   (1.0, 1.0, 1.0), (0.0, 0.1, 0.0), 0.0, 8,
                                   True, 1e15, 50.0)
            fp.write(st.format_stats(st.RunStats(**vars(stats)),
                                     for_file=True))
            w.write_profile_file(base + ".sodark", fp, 1.7e9, pkg.DARK, index,
                                 prof, u)
            w.write_sovcirc_rows(fp, index, mvir, rvir, rmass, rmax, vmax,
                                 vcirc, u)
        w.write_array_file(base + ".sogrp", igrp)
        w.write_sogtp(base + ".sogtp", 1.0, 60, index, mvir, rvir, pos, vcm,
                      True)
    for ext in ("sovcirc", "sodark", "sogrp", "sogtp"):
        a, b = (_read(tmp_path / tag / f"out.{ext}") for tag in ("jax", "port"))
        assert a == b and len(a) > 100, ext


def test_segment_writer_matches(tmp_path):
    rng = np.random.default_rng(5)
    v = rng.integers(-10 ** 6, 10 ** 6, 3000).astype(np.int32)
    assert (twriters.int_array_text_length(v)
            == jwriters.int_array_text_length(v))
    for tag, w in (("jax", jwriters), ("port", twriters)):
        p = str(tmp_path / tag)
        with open(p, "wb") as f:
            f.write(b"3000\n" + b" " * jwriters.int_array_text_length(v))
        w.write_int_array_segment(p, v[1000:], 5 + jwriters
                                  .int_array_text_length(v[:1000]))
        w.write_int_array_segment(p, v[:1000], 5)
    assert _read(tmp_path / "jax") == _read(tmp_path / "port")


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_indexx_tied_keys(native, request):
    """Tied f32 keys take the NR quicksort path: the same permutation as
    so_tpu's, through the C transliteration and the Python one."""
    if not native:
        request.getfixturevalue("no_native")
    rng = np.random.default_rng(17)
    for n in (1, 7, 50, 3000):
        keys = rng.integers(0, max(2, n // 5), n).astype(np.float32)
        got = tnum.indexx(keys)
        np.testing.assert_array_equal(got, jnum.indexx(keys))
        assert (np.diff(keys[got]) >= 0).all()
    keys = rng.uniform(0, 1, 500).astype(np.float32)     # distinct: argsort
    np.testing.assert_array_equal(tnum.indexx(keys), jnum.indexx(keys))
    arr1 = np.concatenate([[0.0], keys[:300].round(1)])
    np.testing.assert_array_equal(tnum._indexx_nr(arr1),
                                  jnum._indexx_nr(arr1))


def test_cosmology_agrees():
    for omega in (1.0, 0.9, 0.5, 0.3, 0.1):
        for z in (0.0, 0.5, 1.0, 3.0, 9.0):
            for lam in (False, True):
                assert (tcos.rhovir_over_rhobar(omega, lam, z)
                        == jcos.rhovir_over_rhobar(omega, lam, z))
                assert (tcos.threshold_in_box_units(omega, lam, z)
                        == jcos.threshold_in_box_units(omega, lam, z))
            assert tcos.omega_f(omega, 0.2, z) == jcos.omega_f(omega, 0.2, z)
    for args in ((0.3, 0.7, 0.0), (1.0, 0.0, 0.0), (0.3, 0.0, 0.0)):
        t, j = (m.CSM(dHubble0=2.894, dOmega0=args[0], dLambda=args[1],
                      dOmegaRad=args[2], bComove=True) for m in (tcos, jcos))
        for a in (0.1, 0.5, 1.0):
            assert tcos.csm_exp2time(t, a) == jcos.csm_exp2time(j, a)
        assert (tcos.csm_comove_kick_fac(t, 0.1, 0.02)
                == jcos.csm_comove_kick_fac(j, 0.1, 0.02))


# so_tpu's own grid and tolerance for its batched form against the host
# scalar (tests/test_cosmology.py): both are f32, whose acosh/sinh/cosh
# differ by libm, so the two batched forms are held to each other there
DELTA_GRID = (np.array([0.2, 0.3, 0.7, 1.0]), np.array([0.0, 0.5, 2.0, 1.0]))


@pytest.mark.parametrize("lam", [False, True], ids=["open", "lambda"])
def test_batched_delta_vir_matches_so_tpu(lam):
    """rhovir_over_rhobar_torch: f32 like so_tpu's rhovir_over_rhobar_jax
    and within its rtol 2e-6 of it and of the host scalar on so_tpu's
    grid; in f64, the host scalar to 1e-12 over a wider grid (1 exactly
    178)."""
    import torch

    oms, zs = DELTA_GRID
    want = np.asarray(jcos.rhovir_over_rhobar_jax(oms, lam, zs))
    got = tcos.rhovir_over_rhobar_torch(oms, lam, zs, device="cpu")
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6)
    host = [jcos.rhovir_over_rhobar(float(o), lam, float(z))
            for o, z in zip(oms, zs)]
    np.testing.assert_allclose(got.numpy(), host, rtol=2e-6)
    om, z = np.meshgrid([0.1, 0.25, 0.5, 0.9, 1.0], [0.0, 0.5, 3.0, 9.0])
    got = tcos.rhovir_over_rhobar_torch(om, lam, z, dtype=torch.float64,
                                        device="cpu")
    host = np.vectorize(lambda o, zz: tcos.rhovir_over_rhobar(o, lam, zz))(
        om, z)
    np.testing.assert_allclose(got.numpy(), host, rtol=1e-12)
    assert (got.numpy()[om == 1.0] == 178.0).all()
    # host values go to the card unless the CPU is asked for; a tensor
    # argument keeps its device
    assert tnum.tensor_device(None, 0.3, np.ones(2)).type == "cuda"
    assert tcos.rhovir_over_rhobar_torch(torch.tensor([0.3]), lam,
                                         0.0).device.type == "cpu"


def test_romberg_torch_matches_so_tpu():
    """romberg_torch: so_tpu's romberg_jax rule, batched over (a, b), f32;
    each element equal to romberg_jax's to rtol 1e-6 (f32 sums in another
    order) and to the host dromberg_o to so_tpu's rtol 1e-5, with the
    first converged extrapolant kept per element."""
    import jax.numpy as jnp
    import torch

    a = np.array([0.0, 0.5, 0.1, 1.0])
    b = np.array([2.0, 1.5, 3.0, 1.25])
    for jf, tf, hf in (
            (lambda x: 3 * x * x, lambda x: 3 * x * x, lambda x: 3 * x * x),
            (lambda x: jnp.exp(-x) * jnp.sin(x),
             lambda x: torch.exp(-x) * torch.sin(x),
             lambda x: np.exp(-x) * np.sin(x)),
            (lambda x: 1 / jnp.sqrt(x + 0.01),
             lambda x: 1 / torch.sqrt(x + 0.01),
             lambda x: 1 / np.sqrt(x + 0.01))):
        want = np.asarray(jnum.romberg_jax(jf, a, b, eps=1e-6))
        got = tnum.romberg_torch(tf, a, b, eps=1e-6, device="cpu")
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
        host = [tnum.dromberg_o(hf, float(x), float(y), 1e-10)
                for x, y in zip(a, b)]
        np.testing.assert_allclose(got.numpy(), host, rtol=1e-5)
    # a constant integrand converges at once and each element keeps that
    # first extrapolant, b - a exactly, through the later levels
    got = tnum.romberg_torch(lambda x: torch.ones_like(x), a, b, eps=1e-6,
                             device="cpu")
    np.testing.assert_array_equal(got.numpy(), (b - a).astype(np.float32))


def test_member_mv_sums_dense_equals_pair():
    """member_mv_sums and vcm_from_members take so_tpu's mvh: a dense
    (N, 3) f32 m*v or the (vel, mass) pair, bit for bit the same f64 sums
    (docs/PARITY.md #8), and so_tpu's own sums for either form."""
    from so_tpu.engine import members as jmem

    from so_tpu_torch.engine import members as tmem

    rng = np.random.default_rng(41)
    N, G = 5000, 40
    vel = rng.normal(size=(N, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, N).astype(np.float32)
    counts = rng.integers(0, 60, G)
    counts[3] = 0
    rows = rng.integers(0, N, int(counts.sum()))
    mvir = rng.uniform(1.0, 50.0, G).astype(np.float32)
    dense = vel * mass[:, None]
    pair = tmem.member_mv_sums((vel, mass), rows, counts)
    got = tmem.member_mv_sums(dense, rows, counts)
    assert got.dtype == np.float64 and got.tobytes() == pair.tobytes()
    assert got.tobytes() == jmem.member_mv_sums(dense, rows, counts).tobytes()
    assert pair.tobytes() == jmem.member_mv_sums((vel, mass), rows,
                                                 counts).tobytes()
    v = tmem.vcm_from_members(dense, rows, counts, mvir)
    assert v.tobytes() == tmem.vcm_from_members((vel, mass), rows, counts,
                                                mvir).tobytes()
    assert v.tobytes() == jmem.vcm_from_members(dense, rows, counts,
                                                mvir).tobytes()
    assert not v[3].any()


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_stats_and_units_agree(native, request):
    if not native:
        request.getfixturevalue("no_native")
    rng = np.random.default_rng(8)
    N = 20000
    args = (rng.uniform(0.5, 1.5, N).astype(np.float32),
            rng.integers(0, 50, N).astype(np.int32),
            rng.integers(0, 3, N).astype(np.int32),
            rng.integers(0, 2, N).astype(np.int32),
            rng.uniform(-3, 0.1, 49).astype(np.float32), 4, 2)
    got, want = tstats.compute_stats(*args), jstats.compute_stats(*args)
    assert vars(got) == vars(want)
    for f in (False, True):
        assert (tstats.format_stats(got, f)
                == jstats.format_stats(want, f))
    for u in ((-9.9, -9.9, 0.0), (1e15, 50.0, 0.0), (3.2e12, 0.7, 2.5)):
        assert vars(tunits.unit_conversions(*u)) == vars(
            junits.unit_conversions(*u))
    assert tversion.__version__ == jversion.__version__
    assert tversion.SOVCIRC_HEADER_VERSION == jversion.SOVCIRC_HEADER_VERSION


def test_conflict_pass_matches_so_tpu():
    """The port's native pass against so_tpu's numpy walk on overlapping
    random groups (subsume, slurp and retain all occur)."""
    rng = np.random.default_rng(2)
    G, N = 60, 5000
    index = np.arange(1, G + 1, dtype=np.int32)
    pos = rng.uniform(-0.5, 0.5, (G, 3)).astype(np.float32)
    pos[G // 2:] = pos[:G // 2] + rng.normal(size=(G // 2, 3)) * 0.02
    code = np.where(rng.uniform(size=G) < 0.15, -1, 0).astype(np.int32)
    mvir = np.where(code == 0, rng.uniform(0.01, 0.5, G), -1).astype(np.float32)
    rvir = np.where(code == 0, rng.uniform(0.01, 0.12, G), -1).astype(np.float32)
    order = rng.permutation(G).astype(np.int64)
    members = [None if c else rng.choice(N, int(rng.integers(1, 200)),
                                         replace=False).astype(np.int64)
               for c in code]
    args = (index, pos, mvir, rvir, code, order, members, N)
    got = resolve_conflicts(*args)
    want = jax_conflicts(*args, use_native=False)
    for f in ("igrp", "n_subsumed", "n_ignored", "mvir", "rvir",
              "slurped_own"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.groups_removed == want.groups_removed > 0
    assert got.groups_slurped == want.groups_slurped


@pytest.mark.parametrize("standard", [False, True], ids=["native", "xdr"])
def test_tipsy_and_catalog_round_trip(standard, tmp_path):
    """Each package reads what the other wrote: snapshot, .gtp, mark and
    .stat files."""
    rng = np.random.default_rng(13)
    recs = {}
    for name, dt, n in (("gas", ttipsy.GAS_DTYPE, 30),
                        ("dark", ttipsy.DARK_DTYPE, 70),
                        ("star", ttipsy.STAR_DTYPE, 20)):
        r = np.zeros(n, dtype=dt[False])
        for f in r.dtype.names:
            r[f] = rng.uniform(-1, 1, r[f].shape)
        recs[name] = r
    hdr = ttipsy.TipsyHeader(time=0.5, nbodies=120, ndim=3, nsph=30,
                             ndark=70, nstar=20)
    for writer, reader in ((ttipsy, jtipsy), (jtipsy, ttipsy)):
        p = str(tmp_path / f"{writer.__name__}.bin")
        writer.write_tipsy(p, writer.TipsyHeader(**vars(hdr)), recs["gas"],
                           recs["dark"], recs["star"], standard)
        a, b = reader.read_tipsy(p, standard), ttipsy.read_tipsy(p, standard)
        assert vars(a.header) == vars(b.header) == vars(hdr)
        for f in ("pos", "vel", "mass", "phi", "temp"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        np.testing.assert_array_equal(a.ptype_all(), b.ptype_all())
        seg = ttipsy.read_tipsy_segment(p, 25, 60, standard)
        np.testing.assert_array_equal(seg.pos, b.pos[25:85])
    gtp = np.zeros(20, dtype=ttipsy.STAR_DTYPE[False])
    gtp["mass"] = rng.uniform(0, 1, 20)
    gtp["pos"] = rng.uniform(-0.5, 0.5, (20, 3))
    gtp["eps"] = rng.uniform(0.01, 0.05, 20)
    ttipsy.write_tipsy(str(tmp_path / "c.gtp"), ttipsy.TipsyHeader(
        time=1.0, nbodies=20, ndim=3, nsph=0, ndark=0, nstar=20), None, None,
        gtp, standard)
    with open(tmp_path / "list", "w") as f:
        f.write("3 1 7 12 20 5\n")
    with open(tmp_path / "mark", "w") as f:
        f.write("120 30 20\n1\n5\n5\n119\n")
    with open(tmp_path / "stat", "w") as f:
        for g in (1, 3, 5, 7, 12, 20):
            f.write(f"{g} 0 " + "0 " * 16 + f"{g * 0.01} 0.2 -0.3\n")
    a = jcat.read_gtp_list(str(tmp_path / "c.gtp"), str(tmp_path / "list"),
                           0.2, standard)
    b = tcat.read_gtp_list(str(tmp_path / "c.gtp"), str(tmp_path / "list"),
                           0.2, standard)
    for f in ("index", "pos", "rgtp", "gtp_mass"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert (a.n_in_gtp, a.gtp_time) == (b.n_in_gtp, b.gtp_time)
    assert (jcat.read_stat(a, str(tmp_path / "stat"))
            == tcat.read_stat(b, str(tmp_path / "stat")))
    np.testing.assert_array_equal(a.pos, b.pos)
    ma, mb = (m.read_mark(str(tmp_path / "mark"), 120) for m in (jcat, tcat))
    np.testing.assert_array_equal(ma[0], mb[0])
    assert ma[1] == mb[1] == 4
