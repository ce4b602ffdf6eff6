"""Golden-output tests through the port's CLI (python -m so_tpu_torch).

The scenarios, inputs and comparisons of tests/test_golden.py, run with
``--device cpu``: catalogs to float tolerance, .sogrp/.sosub/.soign
exactly, .sogtp field by field. -pot is not ported yet (ROADMAP.md
section 1, item 9): its scenario must fail, and the CLI says why.
"""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from scenarios import OUTPUT_FILES, SCENARIOS, generate_inputs  # noqa: E402
from util_compare import (compare_exact_file, compare_file,  # noqa: E402
                          compare_sogtp)

GOLDEN_DIR = os.path.join(HERE, "goldens")
EXACT_FILES = {"sogrp", "sosub", "soign"}
NOT_PORTED = {"flags_pot": "-pot is not ported yet (ROADMAP.md section 1, "
                           "item 9)"}


def _cases():
    for name in sorted(SCENARIOS):
        marks = ([pytest.mark.xfail(strict=True, raises=SystemExit,
                                    reason=NOT_PORTED[name])]
                 if name in NOT_PORTED else [])
        yield pytest.param(name, marks=marks)


@pytest.mark.parametrize("name", _cases())
def test_torch_golden(name, tmp_path):
    from so_tpu_torch.cli import main

    golden = os.path.join(GOLDEN_DIR, name)
    assert os.path.isdir(golden), f"no goldens for {name}"
    workdir = str(tmp_path)
    args = generate_inputs(name, workdir)
    standard = SCENARIOS[name][2]
    argv = ["-i", f"{workdir}/cat.gtp", "-o", f"{workdir}/got",
            "--tipsy", f"{workdir}/snap.bin", "--device", "cpu"] + args
    assert main(argv) == 0

    errs = []
    for ext in OUTPUT_FILES:
        gpath = os.path.join(golden, ext)
        opath = f"{workdir}/got.{ext}"
        if not os.path.exists(gpath):
            continue
        assert os.path.exists(opath), f"missing output {opath}"
        if ext == "sogtp":
            errs += compare_sogtp(gpath, opath, standard)
        elif ext in EXACT_FILES:
            errs += compare_exact_file(gpath, opath)
        else:
            errs += compare_file(gpath, opath)
    assert not errs, "\n".join(errs[:10])


def test_pot_refused_with_roadmap_item(tmp_path, capsys):
    from so_tpu_torch.cli import main

    workdir = str(tmp_path)
    args = generate_inputs("flags_pot", workdir)
    with pytest.raises(SystemExit) as e:
        main(["-i", f"{workdir}/cat.gtp", "-o", f"{workdir}/got",
              "--tipsy", f"{workdir}/snap.bin", "--device", "cpu"] + args)
    assert e.value.code == 1
    err = capsys.readouterr().err.strip().splitlines()[-1]
    assert "not yet in so_tpu_torch" in err and "ROADMAP.md" in err
