"""The port's parity gate on the CPU: the helpers chip_smoke.py uses on the
card to hold the port to tests/goldens and to so_tpu's outputs at scale
(tests/torch_scenarios.py, tests/torch_compare.py, tests/make_torch_refs.py
and chip_smoke's run_record / compare_to_ref), and the port's
engine.extract_members against so_tpu's.
"""

import dataclasses
import filecmp
import json
import os
import shutil
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
import fixtures  # noqa: E402
import scenarios  # noqa: E402
import torch_compare  # noqa: E402
import torch_scenarios  # noqa: E402
import util_compare  # noqa: E402
from test_torch_pipeline import _box as pipeline_box  # noqa: E402

from so_tpu.engine.members import extract_members as jax_extract  # noqa: E402
from so_tpu.ops import build_grid as jax_build_grid  # noqa: E402
from so_tpu_torch.engine import extract_members, solve_rvir  # noqa: E402
from so_tpu_torch.engine.pipeline import SOParams, run_so  # noqa: E402
from so_tpu_torch.ops.grid import build_grid  # noqa: E402


@pytest.mark.parametrize("name", sorted(scenarios.SCENARIOS))
def test_torch_scenarios_write_the_same_inputs(name, tmp_path):
    """torch_scenarios.generate_inputs writes byte-identical files (snap.bin,
    cat.gtp and any list, stat or mark file) and the same argv as
    scenarios.generate_inputs."""
    a, b = tmp_path / "so_tpu", tmp_path / "port"
    want = scenarios.generate_inputs(name, str(a))
    got = torch_scenarios.generate_inputs(name, str(b))
    assert [s.replace(str(b), "D") for s in got] == \
        [s.replace(str(a), "D") for s in want]
    files = sorted(os.listdir(a))
    assert {"snap.bin", "cat.gtp"} <= set(files)
    assert sorted(os.listdir(b)) == files
    for f in files:
        assert filecmp.cmp(a / f, b / f, shallow=False), f


def test_make_zoom_box_matches_fixtures():
    want = fixtures.make_zoom_box(np.random.default_rng(2026), 3000, 800, 12)
    got = torch_scenarios.make_zoom_box(np.random.default_rng(2026), 3000,
                                        800, 12)
    for k, v in want[0].items():
        np.testing.assert_array_equal(got[0][k], v, err_msg=k)
    assert got[1] == want[1]
    for w, g in zip(want[2:], got[2:]):
        np.testing.assert_array_equal(g, w)


def _perturb_float(d):
    path = d / "sovcirc"
    lines = path.read_text().splitlines(keepends=True)
    i = next(i for i, ln in enumerate(lines) if ln[:1].isdigit())
    tok = lines[i].split()
    tok[1] = f"{float(tok[1]) * 1.01:g}"           # Mvir, tolerance 1e-4
    lines[i] = " ".join(tok) + "\n"
    path.write_text("".join(lines))


def _perturb_sogrp(d):
    path = d / "sogrp"
    lines = path.read_text().splitlines(keepends=True)
    lines[5] = f"{int(lines[5]) + 1}\n"
    path.write_text("".join(lines))


def _perturb_sogtp(d):
    from so_tpu_torch.io.tipsy import STAR_DTYPE, header_dtype

    path = d / "sogtp"
    raw = bytearray(path.read_bytes())
    off = header_dtype(False).itemsize + STAR_DTYPE[False].fields["eps"][1]
    v = np.frombuffer(bytes(raw[off:off + 4]), np.float32) * np.float32(2)
    raw[off:off + 4] = v.tobytes()
    path.write_bytes(bytes(raw))


@pytest.mark.parametrize("perturb", [None, _perturb_float, _perturb_sogrp,
                                     _perturb_sogtp],
                         ids=["golden", "float", "sogrp_line", "sogtp_field"])
def test_torch_compare_gives_util_compare_verdicts(perturb, tmp_path):
    """torch_compare's three comparers give util_compare's lists of
    mismatches on the basic golden against itself and against three copies
    with one change each: a catalog float, a .sogrp line, a .sogtp field.
    The text comparers are util_compare's own; compare_sogtp is the port's
    reader."""
    assert torch_compare.compare_file is util_compare.compare_file
    assert torch_compare.compare_exact_file is util_compare.compare_exact_file
    golden = os.path.join(HERE, "goldens", "basic")
    got = tmp_path / "got"
    shutil.copytree(golden, got)
    if perturb is not None:
        perturb(got)
    n_errs = 0
    for ext, fn in (("sovcirc", "compare_file"),
                    ("sogrp", "compare_exact_file"),
                    ("sogtp", "compare_sogtp")):
        args = (os.path.join(golden, ext), str(got / ext))
        want = getattr(util_compare, fn)(*args)
        assert getattr(torch_compare, fn)(*args) == want, ext
        n_errs += len(want)
    assert (n_errs > 0) == (perturb is not None)


@pytest.mark.parametrize("species", [False, True],
                         ids=["standard_uniform", "standard_species"])
def test_manifest_inputs_are_chip_smokes(species):
    """The standard boxes' input sha256 in tests/torch_refs/manifest.json is
    that of chip_smoke.py's box, built again here."""
    from so_tpu_torch.io.tipsy import DARK, GAS, STAR

    with open(os.path.join(HERE, "torch_refs", "manifest.json")) as f:
        entry = json.load(f)["boxes"][
            "standard_species" if species else "standard_uniform"]
    ps, catalog = chip_smoke.particles_and_catalog(
        chip_smoke.make_standard_box(), (DARK, GAS, STAR) if species else (),
        chip_smoke.SEED)
    assert chip_smoke.inputs_sha256(ps, catalog()) == entry["inputs_sha256"]
    assert entry["reduced"] is None


def test_manifest_so_tpu_sources_match_the_tree():
    """tests/torch_refs/ holds so_tpu's outputs: the digest of so_tpu's
    sources in the manifest must be the tree's, so a change to so_tpu/
    fails here until the references are written again."""
    import make_torch_refs

    with open(os.path.join(HERE, "torch_refs", "manifest.json")) as f:
        recorded = json.load(f)["so_tpu_sources_sha256"]
    assert make_torch_refs.so_tpu_sources_sha256() == recorded, (
        "so_tpu/ changed since tests/torch_refs/ was written: run "
        "`python tests/make_torch_refs.py`")


def test_so_tpu_sources_sha256_sees_a_change(tmp_path):
    """The digest moves with a byte of any .py file or native .c source,
    and with a file's path."""
    import make_torch_refs

    for rel in ("so_tpu/__init__.py", "so_tpu/ops/grid.py",
                "so_tpu/native/so_native.c"):
        dst = tmp_path / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(os.path.join(ROOT, rel), dst)
    base = make_torch_refs.so_tpu_sources_sha256(str(tmp_path))
    for rel in ("so_tpu/ops/grid.py", "so_tpu/native/so_native.c"):
        f = tmp_path / rel
        keep = f.read_bytes()
        f.write_bytes(keep + b" ")
        assert make_torch_refs.so_tpu_sources_sha256(str(tmp_path)) != base
        f.write_bytes(keep)
    assert make_torch_refs.so_tpu_sources_sha256(str(tmp_path)) == base
    (tmp_path / "so_tpu/ops/grid.py").rename(tmp_path / "so_tpu/ops/grid2.py")
    assert make_torch_refs.so_tpu_sources_sha256(str(tmp_path)) != base


@pytest.fixture(scope="module")
def small_ref(tmp_path_factory):
    """make_torch_refs.write_box on a 2^15-particle / 256-halo make_box
    (so_tpu on the CPU), and the port's CPU run_so of the same inputs."""
    import make_torch_refs

    box = chip_smoke.make_box(np.random.default_rng(3), 1 << 15, 256)
    ps, catalog = chip_smoke.particles_and_catalog(box, (), 3)
    out_dir = str(tmp_path_factory.mktemp("refs"))
    entry = make_torch_refs.write_box("small", ps, catalog(), (), out_dir)
    with np.load(os.path.join(out_dir, "small.npz")) as z:
        ref = {k: z[k] for k in z.files}
    got = run_so(ps, catalog(), SOParams(threshold=chip_smoke.THR,
                                         device="cpu"))
    return entry, ref, got, ps, catalog().pos


def _compare(small_ref, rec, ref=None):
    _, so_tpu_ref, _, ps, centers = small_ref
    return chip_smoke.compare_to_ref(
        "small", rec, so_tpu_ref if ref is None else ref,
        chip_smoke.D2Witness(ps.pos, ps.mass, centers, rec))


def test_make_torch_refs_accepted_for_the_port(small_ref):
    """The smoke's comparison accepts the port's CPU run against so_tpu's
    reference; the halos that take the witness differ from so_tpu only in
    the d2-reading fields."""
    entry, ref, got, ps, _ = small_ref
    assert entry["solved"] >= 200 and entry["largest_solve_K"] >= 4096
    rec = chip_smoke.run_record(got)
    took = _compare(small_ref, rec)
    assert set(took) <= set(chip_smoke.D2_FIELDS)
    assert 0 < len(set().union(*took.values())) < entry["halos"]
    for f in ("code", "mvir", "rvir", "j", "members.digest", "vcirc"):
        assert rec[f].tobytes() == ref[f].tobytes(), f


@pytest.mark.parametrize("change", ["j", "member", "d2cut", "so_tpu_rmax"])
def test_make_torch_refs_rejects_a_change(small_ref, change):
    """One halo's j, or one member of one halo, changed, or a d2-reading
    field moved by one ulp: the port's d2cut, where it then equals neither
    so_tpu's value nor the per-op witness, or so_tpu's rmax at a halo
    where the port's took the witness, where so_tpu's then is not the
    fused witness. The smoke's comparison raises naming the field (and,
    for a d2-reading field, the halo)."""
    _, ref, got, _, _ = small_ref
    h = int(np.nonzero(got.solve.code == 0)[0][7])
    rec = chip_smoke.run_record(got)
    if change == "d2cut":
        rec["d2cut"] = rec["d2cut"].copy()
        rec["d2cut"][h] = np.nextafter(rec["d2cut"][h], np.float32(1))
        with pytest.raises(AssertionError, match=f"d2cut of halo {h}:"):
            _compare(small_ref, rec)
        return
    if change == "so_tpu_rmax":
        took = _compare(small_ref, rec)
        h = took["rmax"][0]
        ref = dict(ref, rmax=ref["rmax"].copy())
        ref["rmax"][h] = np.nextafter(ref["rmax"][h], np.float32(1))
        with pytest.raises(AssertionError, match=f"rmax of halo {h}:"):
            _compare(small_ref, rec, ref)
        return
    if change == "j":
        rec["j"] = rec["j"].copy()
        rec["j"][h] += 1
        field = "j: 1 halos differ"
    else:
        members = list(got.members)
        m = members[h].copy()
        m[3] = np.setdiff1d(np.arange(m.max() + 2), m)[0]  # not a member
        members[h] = m
        rec = chip_smoke.run_record(dataclasses.replace(got, members=members))
        field = "members.digest: 1 halos differ"
    with pytest.raises(AssertionError, match=field):
        _compare(small_ref, rec)


@pytest.fixture(scope="module")
def members_box():
    """test_torch_pipeline.py's general-mass box, solved by the port on the
    CPU, and so_tpu's grid of it."""
    ps, catalog = pipeline_box(False)
    cat = catalog()
    grid = build_grid(ps.pos, ps.mass, vel=ps.vel, device="cpu")
    s = solve_rvir(grid, cat.pos, cat.rgtp, chip_smoke.THR)
    ok = s.code == 0
    assert ok.sum() >= 3
    return ps, grid, jax_build_grid(ps.pos, ps.mass, vel=ps.vel), \
        (cat.pos[ok], s.d2cut[ok], s.j[ok], s.mvir[ok]), s.kcap[ok]


@pytest.mark.parametrize("hint", [False, True], ids=["no_hint", "cap_hint"])
def test_extract_members_matches_so_tpu(members_box, hint):
    """extract_members gives so_tpu's member lists, list by list, and its
    vcm bit for bit, with and without cap_hint; host_mv read from the grid
    equals the one passed."""
    ps, grid, jgrid, args, kcap = members_box
    cap = kcap if hint else None
    want, want_vcm = jax_extract(jgrid, *args, cap_hint=cap,
                                 host_mv=(ps.vel, ps.mass))
    got, vcm = extract_members(grid, *args, cap_hint=cap,
                               host_mv=(ps.vel, ps.mass))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(vcm.view(np.int32), want_vcm.view(np.int32))
    _, vcm_grid = extract_members(grid, *args, cap_hint=cap)
    np.testing.assert_array_equal(vcm_grid.view(np.int32), vcm.view(np.int32))


def test_smoke_helpers_import_nothing_of_so_tpu(tmp_path):
    """chip_smoke's parity helpers (tests/torch_scenarios.py,
    tests/torch_compare.py, run_record) run a golden scenario's inputs,
    the port's CLI and the comparison with jax, so_tpu and bench
    unimported, as on a card's machine without the JAX package."""
    import subprocess

    code = f"""
import os, sys
sys.path[:0] = [{ROOT!r}, {HERE!r}]
import chip_smoke
from torch_compare import compare_exact_file, compare_file
from torch_scenarios import generate_inputs
from so_tpu_torch.cli import main
d = {str(tmp_path)!r}
args = generate_inputs("basic", d)
assert main(["-i", d + "/cat.gtp", "-o", d + "/got", "--tipsy",
             d + "/snap.bin", "--device", "cpu"] + args) == 0
g = os.path.join({HERE!r}, "goldens", "basic")
assert not compare_file(g + "/sovcirc", d + "/got.sovcirc")
assert not compare_exact_file(g + "/sogrp", d + "/got.sogrp")
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "so_tpu", "bench")]
assert not bad, bad
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
