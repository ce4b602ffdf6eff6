"""Output unit conversions — reference: kd2.c:899, 937-941, 981-991.
(Copy of so_tpu/units.py, so the port imports nothing of the JAX
package.)

With -u <fMassUnit> <fMpcUnit>, catalog output converts to Msol / kpc / km/s:
    kpcunit   = fMpcUnit * 1000
    kmsecunit = 25388.8 * sqrt(GRAV_cgs * fMassUnit * (1+z) / fMpcUnit) / 1e5
    massunit  = fMassUnit
Unset units (the reference's "< 0" sentinel, so.c:235-236) convert by 1.
The intermediate is computed in float64 and rounded to float32, exactly as
the reference's double->float assignment does (kd2.c:986-988).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

GRAV = 6.6726e-8  # G in cgs — reference: kd2.c:899


@dataclass(frozen=True)
class UnitConversions:
    massunit: np.float32
    kpcunit: np.float32
    kmsecunit: np.float32


def unit_conversions(f_mass_unit: float, f_mpc_unit: float, z: float) -> UnitConversions:
    """Mirror of the conversion setup in kdWriteOut (kd2.c:981-991)."""
    if f_mass_unit < 0.0:
        return UnitConversions(np.float32(1.0), np.float32(1.0), np.float32(1.0))
    dtemp = GRAV * np.float32(f_mass_unit) * (1.0 + np.float32(z)) / np.float32(f_mpc_unit)
    dtemp = 25388.8 * math.sqrt(dtemp) / 100000.0
    return UnitConversions(
        massunit=np.float32(f_mass_unit),
        kpcunit=np.float32(np.float32(f_mpc_unit) * 1000.0),
        kmsecunit=np.float32(dtemp),
    )
