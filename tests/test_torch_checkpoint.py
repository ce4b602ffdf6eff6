"""so_tpu_torch --checkpoint (save/resume of the solve state) and
--profile on the CPU: the twins of test_aux.py's checkpoint tests, the
file format shared with so_tpu, and a profiler trace."""

import json
import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from scenarios import generate_inputs  # noqa: E402
from test_aux import _setup  # noqa: E402

from so_tpu.checkpoint import load_solve as jax_load_solve  # noqa: E402
from so_tpu.io.tipsy import DARK  # noqa: E402
from so_tpu_torch.checkpoint import load_solve, save_solve  # noqa: E402
from so_tpu_torch.engine.pipeline import SOParams, run_so  # noqa: E402


def _params(**kw):
    return SOParams(threshold=178.0, device="cpu", **kw)


def test_checkpoint_roundtrip(tmp_path):
    ps, cat = _setup()
    run = run_so(ps, cat, _params())
    p = str(tmp_path / "ck.npz")
    save_solve(p, run.solve, run.members, cat.pos, digest="abc")
    solve2, members2, centers2 = load_solve(p, "abc")
    for f in ("code", "mvir", "rvir", "j", "d2cut", "vcm"):
        np.testing.assert_array_equal(getattr(solve2, f),
                                      getattr(run.solve, f))
    np.testing.assert_array_equal(centers2, cat.pos)
    for a, b in zip(run.members, members2):
        if a is None:
            assert b is None or b.size == 0
        else:
            np.testing.assert_array_equal(a, b)
    # the format is so_tpu's: its loader reads the port's file
    jsolve, jmembers, _ = jax_load_solve(p, "abc")
    np.testing.assert_array_equal(jsolve.mvir, run.solve.mvir)
    assert sum(m.size for m in jmembers if m is not None) == sum(
        m.size for m in run.members if m is not None)


def test_checkpoint_resume_pipeline(tmp_path):
    """The second run resumes (only the derived pass gathers) and equals
    the first, derived quantities and per-species profiles included."""
    ps, cat1 = _setup()
    _, cat2 = _setup()
    ck = str(tmp_path / "solve.npz")
    kw = dict(checkpoint=ck, species=(DARK,))
    r1 = run_so(ps, cat1, _params(**kw))
    assert os.path.exists(ck) and "checkpoint save" in r1.phases
    r2 = run_so(ps, cat2, _params(**kw))
    assert "checkpoint resume" in r2.phases
    assert "R_Delta solve" not in r2.phases
    assert "members + derived (fused)" not in r2.phases
    assert (r1.solve.code == 0).all()
    for f in ("mvir", "rvir"):
        np.testing.assert_array_equal(getattr(r1, f), getattr(r2, f))
    np.testing.assert_array_equal(r1.solve.vcm, r2.solve.vcm)
    np.testing.assert_array_equal(r1.conflicts.igrp, r2.conflicts.igrp)
    for f in ("vcirc", "rmass", "rmax", "vmax"):
        np.testing.assert_array_equal(getattr(r1.derived, f),
                                      getattr(r2.derived, f), err_msg=f)
    np.testing.assert_array_equal(r1.derived.profiles[DARK],
                                  r2.derived.profiles[DARK])
    assert r1.stats == r2.stats


def test_checkpoint_wrong_input_refuses_resume(tmp_path):
    ps, cat1 = _setup()
    ck = str(tmp_path / "solve.npz")
    run_so(ps, cat1, _params(checkpoint=ck))
    assert os.path.exists(ck)
    ps2, cat2 = _setup()
    ps2.mass = (ps2.mass * np.float32(1.5)).astype(np.float32)
    with pytest.raises(ValueError, match="different inputs"):
        run_so(ps2, cat2, _params(checkpoint=ck))
    ps3, cat3 = _setup()
    with pytest.raises(ValueError, match="different inputs"):
        run_so(ps3, cat3, SOParams(threshold=200.0, device="cpu",
                                   checkpoint=ck))
    ps4, cat4 = _setup()
    run_so(ps4, cat4, _params(checkpoint=ck))


def test_cli_checkpoint_resume_is_byte_identical(tmp_path):
    """--checkpoint through the CLI, run twice: the second run resumes
    and writes the same files, -pot included."""
    from so_tpu_torch.cli import main

    workdir = str(tmp_path)
    args = generate_inputs("basic", workdir)
    base = ["-i", f"{workdir}/cat.gtp", "--tipsy", f"{workdir}/snap.bin",
            "--device", "cpu", "-pot", "--checkpoint",
            f"{workdir}/state.npz"] + args
    assert main(base + ["-o", f"{workdir}/first"]) == 0
    assert os.path.exists(f"{workdir}/state.npz")
    assert main(base + ["-o", f"{workdir}/second"]) == 0
    for ext in ("sogrp", "sogtp", "sosub", "soign"):
        with open(f"{workdir}/first.{ext}", "rb") as a, \
                open(f"{workdir}/second.{ext}", "rb") as b:
            assert a.read() == b.read(), ext
    # the catalog and profile files differ only in their headers' run time
    for ext in ("sovcirc", "sodark"):
        rows = [[ln for ln in open(f"{workdir}/{n}.{ext}")
                 if not ln.startswith("#")] for n in ("first", "second")]
        assert rows[0] == rows[1] and rows[0], ext
    assert any(float(r.split()[1]) > 0 for r in rows[0])


def test_profile_writes_a_trace(tmp_path):
    """--profile <dir> wraps the run in torch.profiler and leaves a Chrome
    trace holding the run's ops."""
    from so_tpu_torch.cli import main
    from so_tpu_torch.profiling import TRACE_FILE

    workdir = str(tmp_path)
    args = generate_inputs("basic", workdir)
    assert main(["-i", f"{workdir}/cat.gtp", "--tipsy", f"{workdir}/snap.bin",
                 "-o", f"{workdir}/got", "--device", "cpu", "--profile",
                 f"{workdir}/trace"] + args) == 0
    with open(os.path.join(workdir, "trace", TRACE_FILE)) as fp:
        events = json.load(fp)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
