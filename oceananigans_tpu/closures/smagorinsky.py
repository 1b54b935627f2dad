"""Smagorinsky LES closures.

Reference semantics: src/TurbulenceClosures/turbulence_closure_implementations/
Smagorinskys/smagorinsky.jl (νₑ = (C Δ)² √(2 ΣᵢⱼΣᵢⱼ) with Δ the filter width
= V^(1/3)), lilly_coefficient.jl (buoyancy-modified coefficient:
ς² = max(0, 1 - Ri/Pr) factor under the root), and the `SmagorinskyLilly`
alias. The eddy diffusivity is κₑ = νₑ/Pr per tracer.

Design: all strain components are interpolated to cell centers and the
eddy viscosity is ONE ccc array in the aux dict — XLA fuses the whole
|Σ|-evaluation into the tendency kernel."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..operators.operators import LOC_CCC, interp, ix_c, iy_c, iz_c
from .diffusion_operators import (Sxx_ccc, Sxy_ffc, Sxz_fcf, Syy_ccc,
                                  Syz_cff, Szz_ccc, div_2nu_strain_u,
                                  div_2nu_strain_v, div_2nu_strain_w,
                                  div_kappa_grad)
from .scalar_diffusivity import _ClosureBase


def _sq_interp_ccc(grid, a, from_loc):
    """Interpolate a² from its location to ccc (the reference interpolates the
    squared off-diagonal strain components)."""
    out = a * a
    for axis in range(3):
        if from_loc[axis] == "f":
            out = interp(grid, out, axis, "c")
    return out


def strain_rate_sq_ccc(grid, u, v, w):
    """2 Σᵢⱼ Σᵢⱼ at cell centers."""
    diag = (Sxx_ccc(grid, u) ** 2 + Syy_ccc(grid, v) ** 2
            + Szz_ccc(grid, w) ** 2)
    off = (_sq_interp_ccc(grid, Sxy_ffc(grid, u, v), ("f", "f", "c"))
           + _sq_interp_ccc(grid, Sxz_fcf(grid, u, w), ("f", "c", "f"))
           + _sq_interp_ccc(grid, Syz_cff(grid, v, w), ("c", "f", "f")))
    return 2 * (diag + 2 * off)


def filter_width_sq(grid):
    """Δ² = V^(2/3) (reference: Δᶠ cube-root-of-volume filter width)."""
    V = grid.V(LOC_CCC)
    if np.isscalar(V):
        return float(V) ** (2.0 / 3.0)
    return np.asarray(V) ** (2.0 / 3.0)


class Smagorinsky(_ClosureBase):
    """Constant-coefficient Smagorinsky (C=0.16 default, Lilly's value) with
    optional buoyancy modification (SmagorinskyLilly)."""

    def __init__(self, coefficient=0.16, Pr=1.0, buoyancy_modified=False,
                 buoyancy=None):
        if isinstance(coefficient, LillyCoefficient):
            # reference: Smagorinsky(coefficient=LillyCoefficient(...))
            Pr = coefficient.Pr
            buoyancy_modified = True
            coefficient = coefficient.smagorinsky
        self.C = (coefficient if hasattr(coefficient, "_fp")
                  else float(coefficient))
        self.Pr = Pr
        self.buoyancy_modified = buoyancy_modified
        self.buoyancy = buoyancy

    def _fp(self):
        pr = tuple(sorted(self.Pr.items())) if isinstance(self.Pr, dict) \
            else self.Pr
        c = self.C._fp() if hasattr(self.C, "_fp") else self.C
        return ("Smagorinsky", c, pr, self.buoyancy_modified)

    def _pr_for(self, name):
        if isinstance(self.Pr, dict):
            return self.Pr.get(name, 1.0)
        return self.Pr

    def compute_diffusivities(self, grid, fields, time):
        u, v, w = fields["u"], fields["v"], fields["w"]
        S2 = strain_rate_sq_ccc(grid, u, v, w)
        if self.buoyancy_modified and self.buoyancy is not None:
            # Lilly's stability correction: ς² = max(0, 1 - N²/(Pr |Σ|²))
            from ..operators.operators import ddz, iz_c
            b = self.buoyancy.buoyancy_ccc(grid, fields)
            N2 = iz_c(grid, ddz(grid, b, ("c", "c", "f")))
            pr = self._pr_for("b")   # per-tracer dicts too (r5 review)
            zeta2 = jnp.maximum(0.0, 1.0 - N2 / (pr * jnp.maximum(S2, 1e-20)))
            S2 = S2 * zeta2
        if isinstance(self.C, DynamicCoefficient):
            if self.C.lagrangian:
                # c² from the trajectory-relaxed JLM/JMM state fields (zero
                # until the first update: the closure spins up over one step)
                JLM, JMM = fields["JLM"], fields["JMM"]
                csq = jnp.where(
                    JMM > 0,
                    jnp.maximum(JLM, self.C.minimum_numerator)
                    / jnp.where(JMM == 0, 1.0, JMM), 0.0)
            else:
                csq = dynamic_coefficient_sq(grid, u, v, w, self.C.averaging,
                                             self.C.minimum_numerator)
        else:
            csq = self.C ** 2
        nu_e = csq * filter_width_sq(grid) * jnp.sqrt(S2)
        return {"nu_e": nu_e}

    @property
    def state_fields(self):
        """Closure-owned prognostic state (reference: the 𝒥ᴸᴹ/𝒥ᴹᴹ
        diffusivity fields of the Lagrangian-averaged dynamic closure)."""
        if isinstance(self.C, DynamicCoefficient) and self.C.lagrangian:
            return ("JLM", "JMM")
        return ()

    def update_state_fields(self, grid, fields, dt, iteration):
        """Bou-Zeid et al. (2005) Lagrangian relaxation of the Germano
        contractions (reference: _lagrangian_average_LM_MM!,
        dynamic_coefficient.jl:241-291): J ← ε·new + (1-ε)·J(X - UΔt) with
        ε = (Δt/T)/(1 + Δt/T), T = 1.5Δ/(JLM·JMM)^(1/8); first step
        initializes from the spatial means."""
        u, v, w = fields["u"], fields["v"], fields["w"]
        LM, MM = germano_LM_MM(grid, u, v, w)
        jmin = self.C.minimum_numerator
        JLMp, JMMp = fields["JLM"], fields["JMM"]
        ii = grid.interior_slices
        first = iteration == 0
        initL = jnp.maximum(jnp.mean(LM[ii]), jmin)
        initM = jnp.mean(MM[ii])
        itpL = _upstream_interp(grid, JLMp, u, v, w, dt)
        itpM = _upstream_interp(grid, JMMp, u, v, w, dt)
        delta = jnp.sqrt(filter_width_sq(grid))
        prod = jnp.maximum(JLMp, jmin) * jnp.maximum(JMMp, 0.0)
        T = 1.5 * delta / jnp.maximum(prod, 1e-38) ** 0.125
        tau = dt / T
        eps = tau / (1.0 + tau)
        newM = eps * MM + (1 - eps) * itpM
        newL = jnp.maximum(eps * LM + (1 - eps) * jnp.maximum(itpL, jmin),
                           jmin)
        JLM = jnp.where(first, jnp.broadcast_to(initL, newL.shape), newL)
        JMM = jnp.where(first, jnp.broadcast_to(initM, newM.shape), newM)
        return {"JLM": JLM, "JMM": JMM}

    def momentum_tendencies(self, grid, fields, aux):
        u, v, w = fields["u"], fields["v"], fields["w"]
        nu = aux["nu_e"]
        nu_ffc = interp(grid, interp(grid, nu, 0, "f"), 1, "f")
        nu_fcf = interp(grid, interp(grid, nu, 0, "f"), 2, "f")
        nu_cff = interp(grid, interp(grid, nu, 1, "f"), 2, "f")
        return dict(
            u=div_2nu_strain_u(grid, u, v, w, nu, nu_ffc, nu_fcf),
            v=div_2nu_strain_v(grid, u, v, w, nu, nu_ffc, nu_cff),
            w=div_2nu_strain_w(grid, u, v, w, nu, nu_fcf, nu_cff))

    def tracer_tendency(self, grid, name, fields, aux):
        kappa = aux["nu_e"] / self._pr_for(name)
        return div_kappa_grad(grid, fields[name], LOC_CCC, kappa)


class LillyCoefficient:
    """Coefficient spec selecting the Lilly (1962) buoyancy-modified
    Smagorinsky variant (reference: Smagorinskys/lilly_coefficient.jl):
    ``Smagorinsky(coefficient=LillyCoefficient(smagorinsky=0.16, Pr=1.0))``."""

    def __init__(self, smagorinsky=0.16, Pr=1.0):
        self.smagorinsky = smagorinsky
        self.Pr = Pr


def SmagorinskyLilly(coefficient=0.16, Pr=1.0, buoyancy=None):
    """Reference alias: Smagorinsky with the Lilly coefficient including the
    buoyancy correction when a buoyancy model is supplied."""
    return Smagorinsky(coefficient=coefficient, Pr=Pr,
                       buoyancy_modified=buoyancy is not None,
                       buoyancy=buoyancy)


# -- dynamic (Germano/Lilly) coefficient ----------------------------------------
# reference: Smagorinskys/dynamic_coefficient.jl + scale_invariant_operators.jl

class DynamicCoefficient:
    """Germano-identity dynamic Smagorinsky coefficient with directional
    averaging of the LM/MM contractions (reference: dynamic_coefficient.jl —
    `DynamicCoefficient(averaging=(1,2))`; dims here are 0-based):

        c² = max(⟨LᵢⱼMᵢⱼ⟩, min) / ⟨MᵢⱼMᵢⱼ⟩
    """

    def __init__(self, averaging=(0, 1, 2), minimum_numerator=1e-32):
        if isinstance(averaging, LagrangianAveraging) \
                or averaging is LagrangianAveraging:
            self.averaging = LagrangianAveraging()
        else:
            self.averaging = (tuple(averaging) if np.iterable(averaging)
                              else (int(averaging),))
        self.minimum_numerator = float(minimum_numerator)

    @property
    def lagrangian(self):
        return isinstance(self.averaging, LagrangianAveraging)

    def _fp(self):
        avg = "lagrangian" if self.lagrangian else self.averaging
        return ("DynamicCoefficient", avg, self.minimum_numerator)


def test_filter(grid, a):
    """7-point box test filter of scale 2Δ (reference:
    scale_invariant_operators.jl: (6a + Σ₆ neighbors)/12)."""
    from ..operators.shifts import shift
    out = 6.0 * a
    for axis in range(3):
        if grid.is_flat(axis):
            out = out + 2.0 * a
        else:
            out = out + shift(a, +1, axis) + shift(a, -1, axis)
    return out / 12.0


def _strain_components_ccc(grid, u, v, w):
    """All six strain components interpolated to ccc."""
    from ..operators.operators import ddx, ddy, ddz
    S11 = ddx(grid, u, LOC_CCC)
    S22 = ddy(grid, v, LOC_CCC)
    S33 = ddz(grid, w, LOC_CCC)
    S12 = ix_c(grid, iy_c(grid, Sxy_ffc(grid, u, v)))
    S13 = ix_c(grid, iz_c(grid, Sxz_fcf(grid, u, w)))
    S23 = iy_c(grid, iz_c(grid, Syz_cff(grid, v, w)))
    return S11, S22, S33, S12, S13, S23


def germano_LM_MM(grid, u, v, w):
    """Padded (LM, MM) Germano-identity contractions at ccc (reference:
    LM_and_MM, dynamic_coefficient.jl:129-187). ᾱ²β = 4 (test/grid filter
    scale ratio squared)."""
    fu, fv, fw = test_filter(grid, u), test_filter(grid, v), test_filter(grid, w)

    sigma = jnp.sqrt(strain_rate_sq_ccc(grid, u, v, w) / 2)
    sigma_f = jnp.sqrt(strain_rate_sq_ccc(grid, fu, fv, fw) / 2)
    S = _strain_components_ccc(grid, u, v, w)
    Sf = _strain_components_ccc(grid, fu, fv, fw)
    d2 = filter_width_sq(grid)

    # resolved-stress (Leonard) tensor at ccc
    uc, vc, wc = ix_c(grid, u), iy_c(grid, v), iz_c(grid, w)
    fuc, fvc, fwc = ix_c(grid, fu), iy_c(grid, fv), iz_c(grid, fw)
    L = [test_filter(grid, ix_c(grid, u * u)) - ix_c(grid, fu * fu),
         test_filter(grid, iy_c(grid, v * v)) - iy_c(grid, fv * fv),
         test_filter(grid, iz_c(grid, w * w)) - iz_c(grid, fw * fw),
         test_filter(grid, uc * vc) - fuc * fvc,
         test_filter(grid, uc * wc) - fuc * fwc,
         test_filter(grid, vc * wc) - fvc * fwc]
    M = [2 * d2 * (test_filter(grid, sigma * s) - 4.0 * sigma_f * sf)
         for s, sf in zip(S, Sf)]

    weights = (1, 1, 1, 2, 2, 2)
    LM = sum(wgt * l * m for wgt, l, m in zip(weights, L, M))
    MM = sum(wgt * m * m for wgt, m, _ in zip(weights, M, M))
    return LM, MM


def dynamic_coefficient_sq(grid, u, v, w, averaging, minimum_numerator):
    """c² = ⟨LM⟩/⟨MM⟩ padded field with directional averaging (reference:
    square_smagorinsky_coefficient, dynamic_coefficient.jl)."""
    LM, MM = germano_LM_MM(grid, u, v, w)

    # directional averaging over the INTERIOR, edge-padded back
    ii = grid.interior_slices
    JLM = jnp.mean(LM[ii], axis=averaging, keepdims=True)
    JMM = jnp.mean(MM[ii], axis=averaging, keepdims=True)
    csq_int = jnp.where(JMM > 0,
                        jnp.maximum(JLM, minimum_numerator)
                        / jnp.where(JMM == 0, 1.0, JMM), 0.0)
    csq_int = jnp.broadcast_to(csq_int, LM[ii].shape)
    pads = [(h, grid.padded_shape[ax] - grid.N[ax] - h)
            for ax, h in enumerate(grid.H)]
    return jnp.pad(csq_int, pads, mode="edge")


def DynamicSmagorinsky(averaging=(0, 1, 2), Pr=1.0,
                       minimum_numerator=1e-32):
    """Reference convenience constructor (dynamic_coefficient.jl:20-28).
    ``averaging`` may be directional dims or :class:`LagrangianAveraging`."""
    return Smagorinsky(coefficient=DynamicCoefficient(
        averaging=averaging, minimum_numerator=minimum_numerator), Pr=Pr)


# -- Lagrangian-averaged dynamic coefficient ------------------------------------
# reference: dynamic_coefficient.jl:233-330 (_lagrangian_average_LM_MM!),
# Bou-Zeid, Meneveau & Parlange (2005): the LM/MM Germano contractions are
# relaxed along fluid trajectories with timescale T = 1.5Δ/(JLM·JMM)^(1/8)
# and a semi-Lagrangian (one-cell-clamped upstream trilinear) advection.

class LagrangianAveraging:
    """Sentinel selecting Lagrangian (along-trajectory) averaging for
    :class:`DynamicCoefficient`."""

    def __repr__(self):
        return "LagrangianAveraging()"


def _upstream_interp(grid, J, u, v, w, dt):
    """Trilinear interpolation of ``J`` at the upstream point X - U·Δt
    (displacement clamped to one cell, as in the reference) — expressed as
    shift/where blends per axis: no gathers."""
    from ..operators.shifts import shift
    vels = (ix_c(grid, u), iy_c(grid, v), iz_c(grid, w))
    spac = (grid.dx(LOC_CCC), grid.dy(LOC_CCC), grid.dz(LOC_CCC))
    out = J
    for ax in range(3):
        if grid.is_flat(ax):
            continue
        alpha = jnp.clip(vels[ax] * dt / jnp.asarray(spac[ax], J.dtype),
                         -1.0, 1.0)
        a = jnp.abs(alpha)
        upw = jnp.where(alpha > 0, shift(out, -1, ax), shift(out, +1, ax))
        out = (1 - a) * out + a * upw
    return out
