"""The control: the reference in bfloat16 put in the program's place
fails the check, where the program passes it (sobench/control.py runs the
same at the cells' own sizes on the card)."""

import pytest

from conftest import add_cell

from sobench import check as ck
from sobench import control, harness


@pytest.mark.parametrize("mix", ["uniform", "species"])
def test_control_fails_where_the_program_passes(bench_root, mix):
    check = {"halos": 24, "strata": 4, "whole_jobs": 1}
    name = add_cell(bench_root, "small", f"{mix}1", 1 << 14, 128,
                    {"snapshots": 2, "check": check}, base_mix=mix)
    cell = harness.load_cell(name, bench_root)
    r = control.readings_for_seed(cell, 2 ** 31 + 99, True, "cpu")
    assert ck.verdict(r["program"], cell.limits)[0], r["program"]
    ctl = dict(r["program"], **r["control"])
    correct, table = ck.verdict(ctl, cell.limits)
    assert not correct, table
    assert r["control"]["solve_diff"] > 0
    assert r["control"]["vcm_diff"] > 0
    assert r["control"]["stats_err"] > cell.limits["stats_err"]
