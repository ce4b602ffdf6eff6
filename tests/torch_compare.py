"""Comparison helpers for golden-output tests, for the port: util_compare's
text comparers and tolerances as they are (that module imports only numpy
until its compare_sogtp runs), and a compare_sogtp that reads the star
records with so_tpu_torch.io.tipsy, so chip_smoke.py can hold the card's
files to tests/goldens without the JAX package.
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from so_tpu_torch.io.tipsy import STAR_DTYPE, read_header  # noqa: E402
from util_compare import (ABS_TOL, REL_TOL, SKIP_SUBSTRINGS,  # noqa: E402,F401
                          compare_exact_file, compare_file, compare_text)


def compare_sogtp(golden_path: str, got_path: str,
                  standard: bool = False) -> list[str]:
    """util_compare.compare_sogtp on so_tpu_torch.io.tipsy's reader: every
    record field to float tolerance, the header padding bytes ignored (the
    reference fwrites an uninitialized struct pad, kd2.c:1297)."""
    def load(path):
        with open(path, "rb") as f:
            h = read_header(f, standard)
            rec = np.frombuffer(f.read(), dtype=STAR_DTYPE[standard])
        return h, rec

    ha, ra = load(golden_path)
    hb, rb = load(got_path)
    errs = []
    if (ha.nstar, ha.time, ha.nbodies, ha.ndim) != (hb.nstar, hb.time,
                                                    hb.nbodies, hb.ndim):
        return [f"sogtp header mismatch: {ha} vs {hb}"]
    for name in ra.dtype.names:
        fa = np.asarray(ra[name], np.float64)
        fb = np.asarray(rb[name], np.float64)
        bad = ~(np.isclose(fa, fb, rtol=REL_TOL, atol=ABS_TOL))
        if bad.any():
            i = np.argwhere(bad)[0]
            errs.append(f"sogtp {name} mismatch at {i}: "
                        f"{fa[tuple(i)]} vs {fb[tuple(i)]}")
    return errs
