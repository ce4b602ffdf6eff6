"""Cosmology: virial overdensity fits and the full csm library (copy of
so_tpu/cosmology.py, so the port imports nothing of the JAX package; its
batched JAX form is rhovir_over_rhobar_torch here).

Two layers, mirroring the reference split:

1. The *live* threshold math used by the SO pipeline — ``omega_f`` and
   ``rhovir_over_rhobar`` (Kitayama & Suto 1996 fits; reference: so.c:57-86)
   plus the threshold-in-box-units rule (so.c:469-481), on the host in
   float64 like the reference's doubles.

2. The csm library (reference: cosmo.c:8-284): Friedmann expansion rate,
   exp<->time conversions, and comoving drift/kick factors. These are linked
   but *dead* in the reference's `so` execution path (kdSetUniverse stores
   parameters and nothing ever calls csm* afterward, kd2.c:116-132); here
   they are a real, tested library. Closed forms follow cosmo.c exactly;
   the Lambda/radiation branches integrate with the same open Romberg rule.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .numerics import dromberg_o, tensor_device

EPSCOSMO = 1e-7  # reference: cosmo.c:24


# ---------------------------------------------------------------------------
# Live path: virial density threshold (so.c:57-86, 469-481)
# ---------------------------------------------------------------------------

def omega_f(omega0: float, lambda0: float, z: float) -> float:
    """Omega(z) — reference: Omegaf, so.c:57-66."""
    zplus12 = (1.0 + z) ** 2
    zplus13 = zplus12 * (1.0 + z)
    return omega0 * zplus13 / (
        omega0 * zplus13 + (1.0 - omega0 - lambda0) * zplus12 + lambda0
    )


def rhovir_over_rhobar(omega0: float, lambda_opt: bool, z: float) -> float:
    """Delta_vir(Omega, Lambda, z) — Kitayama & Suto 1996 fits.

    Reference: rhovir_over_rhobar, so.c:68-86. Omega=1 -> 178; with -L the
    flat-Lambda fit 18*pi^2*(1+0.4093 w^0.9052); otherwise the open-universe
    sinh/cosh(eta) form.
    """
    if omega0 == 1.0:
        return 178.0
    if lambda_opt:
        lambda0 = 1.0 - omega0
        wf = 1.0 / omega_f(omega0, lambda0, z) - 1.0
        return 18.0 * math.pi ** 2 * (1.0 + 0.4093 * wf ** 0.9052)
    etaf = math.acosh(2.0 / omega_f(omega0, 0.0, z) - 1.0)
    answer = 4.0 * math.pi ** 2 / (math.sinh(etaf) - etaf) ** 2
    return answer * (math.cosh(etaf) - 1.0) ** 3


def rhovir_over_rhobar_torch(omega0, lambda_opt: bool, z, *,
                             dtype=torch.float32, device=None):
    """Batched Delta_vir(z) for multi-threshold catalogs, on tensors (so_tpu's
    rhovir_over_rhobar_jax): the same fits as rhovir_over_rhobar, with
    ``omega0``/``z`` scalars or arrays that broadcast, in ``dtype`` (f32,
    JAX's default, unless asked) on ``device`` (numerics.tensor_device's
    rule). ``lambda_opt`` selects the fit family, as the -L flag does."""
    device = tensor_device(device, omega0, z)
    omega0 = torch.as_tensor(omega0, dtype=dtype, device=device)
    z = torch.as_tensor(z, dtype=dtype, device=device)
    zp13 = (1.0 + z) ** 2 * (1.0 + z)
    zp12 = (1.0 + z) ** 2
    if lambda_opt:
        lam = 1.0 - omega0
        of = omega0 * zp13 / (omega0 * zp13 + (1.0 - omega0 - lam) * zp12
                              + lam)
        wf = 1.0 / of - 1.0
        ans = 18.0 * math.pi ** 2 * (1.0 + 0.4093 * wf ** 0.9052)
    else:
        of = omega0 * zp13 / (omega0 * zp13 + (1.0 - omega0) * zp12)
        etaf = torch.acosh(2.0 / of - 1.0)
        ans = (4.0 * math.pi ** 2 / (torch.sinh(etaf) - etaf) ** 2
               * (torch.cosh(etaf) - 1.0) ** 3)
    return torch.where(omega0 == 1.0, torch.full_like(ans, 178.0), ans)


def threshold_in_box_units(omega0: float, lambda_opt: bool, z: float,
                           user_delta: float | None = None) -> float:
    """fThreshold — density threshold in box units where rho_bar = Omega.

    Reference: so.c:469-481. Auto mode multiplies Delta_vir by Omega; a user
    -delta overdensity is likewise converted to density by *Omega.
    """
    if user_delta is not None:
        return float(user_delta) * omega0
    return rhovir_over_rhobar(omega0, lambda_opt, z) * omega0


def redshift_from_time(f_time: float) -> float:
    """Default redshift 1/h.time - 1 from the snapshot header (so.c:470-472)."""
    return 1.0 / f_time - 1.0


# ---------------------------------------------------------------------------
# csm library (reference: cosmo.c) — exposed as a tested module
# ---------------------------------------------------------------------------

@dataclass
class CSM:
    """Cosmology context — reference: struct csmContext (cosmo.h), csmInitialize."""
    dHubble0: float = 0.0
    dOmega0: float = 0.0
    dLambda: float = 0.0
    dOmegaRad: float = 0.0
    bComove: bool = False


def csm_exp2hub(csm: CSM, a: float) -> float:
    """H(a) from the Friedmann equation — reference: csmExp2Hub, cosmo.c:33-44."""
    assert a > 0.0
    omega_curve = 1.0 - csm.dOmega0 - csm.dLambda - csm.dOmegaRad
    return (csm.dHubble0
            * math.sqrt(csm.dOmega0 * a + omega_curve * a * a
                        + csm.dOmegaRad + csm.dLambda * a ** 4) / (a * a))


def _cosmo_tint(csm: CSM, y: float) -> float:
    """Integrand for exp->time — reference: csmCosmoTint, cosmo.c:55-61."""
    a = y ** (2.0 / 3.0)
    assert a > 0.0
    return 2.0 / (3.0 * y * csm_exp2hub(csm, a))


def csm_exp2time(csm: CSM, a: float) -> float:
    """t(a) — closed forms for Lambda=0, Romberg otherwise.

    Reference: csmExp2Time, cosmo.c:63-121.
    """
    if not csm.bComove:
        raise ValueError("csm_exp2time: invalid call for non-comoving universe")
    om, h0 = csm.dOmega0, csm.dHubble0
    if csm.dLambda == 0.0 and csm.dOmegaRad == 0.0:
        if om == 1.0:
            assert h0 > 0.0
            return 0.0 if a == 0.0 else 2.0 / (3.0 * h0) * a ** 1.5
        elif om > 1.0:
            assert h0 >= 0.0
            if h0 == 0.0:
                b = 1.0 / math.sqrt(om)
                eta = math.acos(1.0 - a)
                return b * (eta - math.sin(eta))
            if a == 0.0:
                return 0.0
            a0 = 1.0 / h0 / math.sqrt(om - 1.0)
            aa = 0.5 * om / (om - 1.0)
            b = aa * a0
            eta = math.acos(1.0 - a / aa)
            return b * (eta - math.sin(eta))
        elif om > 0.0:
            assert h0 > 0.0
            if a == 0.0:
                return 0.0
            a0 = 1.0 / h0 / math.sqrt(1.0 - om)
            aa = 0.5 * om / (1.0 - om)
            b = aa * a0
            eta = math.acosh(a / aa + 1.0)
            return b * (math.sinh(eta) - eta)
        elif om == 0.0:
            assert h0 > 0.0
            return 0.0 if a == 0.0 else a / h0
        else:
            raise ValueError("csm_exp2time: bad Omega0")
    return dromberg_o(lambda y: _cosmo_tint(csm, y), 0.0, a ** 1.5, EPSCOSMO)


def csm_time2exp(csm: CSM, t: float) -> float:
    """a(t) via Newton root-find — reference: csmTime2Exp, cosmo.c:123-147."""
    if not csm.bComove:
        return 1.0
    a_new = t * csm.dHubble0
    it = 0
    while True:
        f = t - csm_exp2time(csm, a_new)
        fprime = 1.0 / (a_new * csm_exp2hub(csm, a_new))
        a_old = a_new
        a_new += f / fprime
        it += 1
        assert it < 20
        if abs(a_new - a_old) / a_new <= EPSCOSMO:
            return a_new


def csm_time2hub(csm: CSM, t: float) -> float:
    """H(t) — reference: csmTime2Hub, cosmo.c:47-53."""
    a = csm_time2exp(csm, t)
    assert a > 0.0
    return csm_exp2hub(csm, a)


def _drift_int(csm: CSM, i_a: float) -> float:
    """Reference: csmComoveDriftInt, cosmo.c:149-152."""
    return -i_a / csm_exp2hub(csm, 1.0 / i_a)


def _kick_int(csm: CSM, i_a: float) -> float:
    """Reference: csmComoveKickInt, cosmo.c:154-157."""
    return -1.0 / csm_exp2hub(csm, 1.0 / i_a)


def _closed_form_eta_factors(csm: CSM, t: float, delta: float):
    om, h0 = csm.dOmega0, csm.dHubble0
    a1 = csm_time2exp(csm, t)
    a2 = csm_time2exp(csm, t + delta)
    if om > 1.0:
        assert h0 >= 0.0
        if h0 == 0.0:
            aa, b = 1.0, 1.0 / math.sqrt(om)
        else:
            a0 = 1.0 / h0 / math.sqrt(om - 1.0)
            aa = 0.5 * om / (om - 1.0)
            b = aa * a0
        eta1 = math.acos(1.0 - a1 / aa)
        eta2 = math.acos(1.0 - a2 / aa)
        return a1, a2, aa, b, eta1, eta2, True
    assert om > 0.0 and h0 > 0.0
    a0 = 1.0 / h0 / math.sqrt(1.0 - om)
    aa = 0.5 * om / (1.0 - om)
    b = aa * a0
    eta1 = math.acosh(a1 / aa + 1.0)
    eta2 = math.acosh(a2 / aa + 1.0)
    return a1, a2, aa, b, eta1, eta2, False


def csm_comove_drift_fac(csm: CSM, t: float, delta: float) -> float:
    """Drift-Hamiltonian time integral — reference: csmComoveDriftFac, cosmo.c:162-220."""
    if not csm.bComove:
        return delta
    om, h0 = csm.dOmega0, csm.dHubble0
    if csm.dLambda == 0.0 and csm.dOmegaRad == 0.0:
        if om == 1.0:
            a1 = csm_time2exp(csm, t)
            a2 = csm_time2exp(csm, t + delta)
            return (2.0 / h0) * (1.0 / math.sqrt(a1) - 1.0 / math.sqrt(a2))
        if om == 0.0:
            raise ValueError("csm_comove_drift_fac: Omega0 == 0 unsupported")
        if om < 0.0:
            raise ValueError("csm_comove_drift_fac: bad Omega0")
        _, _, aa, b, eta1, eta2, closed = _closed_form_eta_factors(csm, t, delta)
        if closed:
            return b / aa / aa * (1.0 / math.tan(0.5 * eta1) - 1.0 / math.tan(0.5 * eta2))
        return b / aa / aa * (1.0 / math.tanh(0.5 * eta1) - 1.0 / math.tanh(0.5 * eta2))
    return dromberg_o(lambda x: _drift_int(csm, x),
                      1.0 / csm_time2exp(csm, t),
                      1.0 / csm_time2exp(csm, t + delta), EPSCOSMO)


def csm_comove_kick_fac(csm: CSM, t: float, delta: float) -> float:
    """Kick-Hamiltonian time integral — reference: csmComoveKickFac, cosmo.c:226-284."""
    if not csm.bComove:
        return delta
    om, h0 = csm.dOmega0, csm.dHubble0
    if csm.dLambda == 0.0 and csm.dOmegaRad == 0.0:
        if om == 1.0:
            a1 = csm_time2exp(csm, t)
            a2 = csm_time2exp(csm, t + delta)
            return (2.0 / h0) * (math.sqrt(a2) - math.sqrt(a1))
        if om == 0.0:
            raise ValueError("csm_comove_kick_fac: Omega0 == 0 unsupported")
        if om < 0.0:
            raise ValueError("csm_comove_kick_fac: bad Omega0")
        _, _, aa, b, eta1, eta2, _ = _closed_form_eta_factors(csm, t, delta)
        return b / aa * (eta2 - eta1)
    return dromberg_o(lambda x: _kick_int(csm, x),
                      1.0 / csm_time2exp(csm, t),
                      1.0 / csm_time2exp(csm, t + delta), EPSCOSMO)
