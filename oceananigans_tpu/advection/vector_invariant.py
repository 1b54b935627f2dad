"""Vector-invariant (rotational form) momentum advection for hydrostatic
models.

Reference semantics: src/Advection/vector_invariant_advection.jl — the
horizontal momentum advection splits into a vertical-vorticity flux, a
kinetic-energy (Bernoulli head) gradient, and vertical advection:

    u: -(ζ v̂) + ∂x K + [w ∂z u]      (at fcc)
    v: +(ζ û) + ∂y K + [w ∂z v]      (at cfc)

Four vorticity formulations (vector_invariant_advection.jl:358-390):
`EnergyConserving`, `EnstrophyConserving` (MITgcm discretizations), and
upwind-biased/WENO reconstruction of ζ along the transport direction with a
choice of smoothness stencil (`VelocityStencil` measures smoothness on the
tangential velocities interpolated to the vorticity location,
weno_interpolants.jl:340-354,459-462; `DefaultStencil` on ζ itself).

When the vertical/KE schemes are upwind, the vertical term becomes a flux
divergence plus an upwinded horizontal-divergence correction Φᵟ and the KE
gradient is split into a self-upwinded part and a centered cross part
(vector_invariant_self_upwinding.jl, vector_invariant_cross_upwinding.jl;
`OnlySelfUpwinding` / `CrossAndSelfUpwinding`). The moving-grid ∂t_σ
contribution to the divergence flux (Az·Δr·∂t_σ,
vector_invariant_self_upwinding.jl:9-11) is zero on static grids; on z-star
grids the hydrostatic models pass it via ``grid_motion=`` (∂t_σ = −δh_U/H
from the barotropic transport divergence) so the upwinding decomposition is
consistent with moving-grid continuity — see
tests/test_hydrostatic_model.py::test_zstar_upwinded_vi_heave_consistency.

`WENOVectorInvariant()` reproduces the reference convenience constructor
(vector_invariant_advection.jl:204-250): WENO-9 vorticity with
VelocityStencil, WENO-5 vertical/divergence/KE, OnlySelfUpwinding.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..operators.operators import (LOC_CCC, LOC_CCF, LOC_CFC, LOC_FCC,
                                   LOC_FFC, X, Y, Z, ddx, ddy, ddz, dx_c,
                                   dx_f, dy_c, dy_f, dz_c, ix_c, ix_f, iy_c,
                                   iy_f, iz_c, zeta3_ffc)
from .schemes import AdvectionScheme, Centered, WENO

ENERGY = "energy_conserving"
ENSTROPHY = "enstrophy_conserving"

# smoothness stencils for WENO vorticity reconstruction
VELOCITY_STENCIL = "velocity"
DEFAULT_STENCIL = "default"

# upwinding treatments for divergence flux / KE gradient
ONLY_SELF = "only_self"
CROSS_AND_SELF = "cross_and_self"

LOC_FCF = ("f", "c", "f")
LOC_CFF = ("c", "f", "f")


def _sym(scheme, grid, a, axis, beta):
    """Symmetric interpolation by a possibly-upwind scheme's centered
    counterpart (reference: `extract_centered_scheme`,
    vector_invariant_upwinding.jl:27-28)."""
    if scheme is None or not isinstance(scheme, AdvectionScheme):
        # conserving sentinel → plain 2-point mean
        scheme = Centered(2)
    return scheme.symmetric(grid, a, axis, beta)


class VectorInvariant:
    """Reference: vector_invariant_advection.jl:84-108 (kwargs and defaults).

    ``vorticity_scheme``/``vertical_advection_scheme``/etc. are either the
    conserving sentinels (ENERGY/ENSTROPHY strings) or AdvectionScheme
    instances (UpwindBiased/WENO) for upwinded reconstruction."""

    def __init__(self, vorticity_scheme=ENSTROPHY,
                 vorticity_stencil=VELOCITY_STENCIL,
                 vertical_advection_scheme=ENERGY,
                 divergence_scheme=None,
                 kinetic_energy_gradient_scheme=None,
                 upwinding=ONLY_SELF,
                 multi_dimensional_stencil=False):
        self.multi_dimensional_stencil = bool(multi_dimensional_stencil)
        for nm, s in (("vorticity_scheme", vorticity_scheme),
                      ("vertical_advection_scheme", vertical_advection_scheme),
                      ("divergence_scheme", divergence_scheme),
                      ("kinetic_energy_gradient_scheme",
                       kinetic_energy_gradient_scheme)):
            if s is not None and not isinstance(s, AdvectionScheme) \
                    and s not in (ENERGY, ENSTROPHY):
                raise ValueError(
                    f"{nm} must be ENERGY/ENSTROPHY or an AdvectionScheme "
                    f"(UpwindBiased/WENO), got {s!r}")
        self.vorticity_scheme = vorticity_scheme
        self.vorticity_stencil = vorticity_stencil
        self.vertical_advection_scheme = vertical_advection_scheme
        if divergence_scheme is None:
            divergence_scheme = vertical_advection_scheme
        if kinetic_energy_gradient_scheme is None:
            kinetic_energy_gradient_scheme = divergence_scheme
        self.divergence_scheme = divergence_scheme
        self.kinetic_energy_gradient_scheme = kinetic_energy_gradient_scheme
        self.upwinding = upwinding

        halos = [1]
        for s in (vorticity_scheme, vertical_advection_scheme,
                  divergence_scheme, kinetic_energy_gradient_scheme):
            if isinstance(s, AdvectionScheme):
                halos.append(s.required_halo)
        h = max(halos)
        # vorticity itself needs one halo, so upwind schemes need one more
        # (reference: required_halo_size_x, vector_invariant_advection.jl:253-258)
        self.required_halo = h if h == 1 else h + 1
        if self.multi_dimensional_stencil:
            self.required_halo += 2   # the tangential 5-point filter

    def _fp(self):
        def fp(s):
            return s._fp() if isinstance(s, AdvectionScheme) else s
        return ("VectorInvariant", fp(self.vorticity_scheme),
                self.vorticity_stencil, fp(self.vertical_advection_scheme),
                fp(self.divergence_scheme),
                fp(self.kinetic_energy_gradient_scheme), self.upwinding,
                self.multi_dimensional_stencil)

    def __hash__(self):
        return hash(self._fp())

    def __eq__(self, o):
        return hasattr(o, "_fp") and self._fp() == o._fp()

    def __repr__(self):
        return f"VectorInvariant({self.vorticity_scheme})"

    def _md(self, a, interp_axis):
        """Tangential 2D-WENO filter (reference:
        multi_dimensional_reconstruction.jl via MultiDimensionalVectorInvariant,
        vector_invariant_advection.jl:288-301): an interpolation along
        ``interp_axis`` is filtered along the OTHER horizontal axis."""
        if not self.multi_dimensional_stencil:
            return a
        from .multidimensional import centered_weno5_filter
        return centered_weno5_filter(a, 1 - interp_axis)

    # -- horizontal (vorticity) term ------------------------------------------

    def _horizontal(self, grid, u, v, zeta=None):
        if zeta is None:
            zeta = zeta3_ffc(grid, u, v)
        dx_cfc, dx_fcc = grid.dx(LOC_CFC), grid.dx(LOC_FCC)
        dy_fcc, dy_cfc = grid.dy(LOC_FCC), grid.dy(LOC_CFC)
        # metric-weighted transport velocities at the opposite staggering
        # (reference: ℑxᶠᵃᵃ(ℑyᵃᶜᵃ(Δx_qᶜᶠᶜ v))·Δx⁻¹ᶠᶜᶜ etc.)
        vhat = ix_f(grid, iy_c(grid, dx_cfc * v)) / dx_fcc   # fcc
        uhat = iy_f(grid, ix_c(grid, dy_fcc * u)) / dy_cfc   # cfc

        vs = self.vorticity_scheme
        if vs == ENSTROPHY:
            adv_u = -iy_c(grid, zeta) * vhat
            adv_v = +ix_c(grid, zeta) * uhat
            return adv_u, adv_v
        if vs == ENERGY:
            adv_u = -iy_c(grid, zeta * ix_f(grid, dx_cfc * v)) / dx_fcc
            adv_v = +ix_c(grid, zeta * iy_f(grid, dy_fcc * u)) / dy_cfc
            return adv_u, adv_v
        # upwinded vorticity (reference: horizontal_advection_U/V for
        # VectorInvariantUpwindVorticity, vector_invariant_advection.jl:377-396)
        if self.vorticity_stencil == VELOCITY_STENCIL and isinstance(vs, WENO):
            smooth = [iy_f(grid, u), ix_f(grid, v)]   # both at ffc
        else:
            smooth = None
        adv_u = -vhat * self._md(
            vs.biased_by(grid, zeta, Y, 1, vhat, smooth=smooth), Y)
        adv_v = +uhat * self._md(
            vs.biased_by(grid, zeta, X, 1, uhat, smooth=smooth), X)
        return adv_u, adv_v

    # -- Bernoulli head (kinetic-energy gradient) -----------------------------

    def _bernoulli(self, grid, u, v):
        ks = self.kinetic_energy_gradient_scheme
        if not isinstance(ks, AdvectionScheme):
            # energy-conserving: ∂(K)/∂x with K = (ℑx(u²)+ℑy(v²))/2
            # (reference: Khᶜᶜᶜ + bernoulli_head_U/V,
            # vector_invariant_advection.jl:315-319)
            K = 0.5 * (ix_c(grid, u * u) + iy_c(grid, v * v))
            return ddx(grid, K, LOC_FCC), ddy(grid, K, LOC_CFC)

        # self-upwinded KE gradient (vector_invariant_self_upwinding.jl:48-90)
        cross = self.upwinding_cross_scheme
        du2 = dx_c(grid, 0.5 * u * u)     # δx_u² at ccc
        dv2 = dy_c(grid, 0.5 * v * v)     # δy_v² at ccc
        du2y = dy_f(grid, 0.5 * u * u)    # δy_u² at ffc
        dv2x = dx_f(grid, 0.5 * v * v)    # δx_v² at ffc

        dKvs = self._md(_sym(cross, grid, dv2x, Y, 1), Y)   # ffc → fcc
        dKur = self._md(ks.biased_by(grid, du2, X, 0, u,
                                     smooth=[ix_c(grid, u)]), X)
        bern_u = (dKur + dKvs) / grid.dx(LOC_FCC)

        dKus = self._md(_sym(cross, grid, du2y, X, 1), X)   # ffc → cfc
        dKvr = self._md(ks.biased_by(grid, dv2, Y, 0, v,
                                     smooth=[iy_c(grid, v)]), Y)
        bern_v = (dKvr + dKus) / grid.dy(LOC_CFC)
        return bern_u, bern_v

    @property
    def upwinding_cross_scheme(self):
        ds = self.divergence_scheme
        if isinstance(ds, AdvectionScheme):
            return getattr(ds, "advecting_velocity_scheme", ds)
        return Centered(2)

    # -- vertical advection + divergence correction ---------------------------

    def _vertical(self, grid, u, v, w, grid_motion=None):
        vas = self.vertical_advection_scheme
        if grid.is_flat(Z):
            if not isinstance(vas, AdvectionScheme):
                return jnp.zeros_like(u), jnp.zeros_like(v)
            adv_u, adv_v = self._divergence_flux(grid, u, v, grid_motion)
            return adv_u / grid.V(LOC_FCC), adv_v / grid.V(LOC_CFC)

        Az_w = grid.Az(LOC_CCF) * w
        if not isinstance(vas, AdvectionScheme):
            # energy-conserving: ℑz(ℑx(Az w) ∂z u)/Az (reference:
            # ζ₂wᶠᶜᶠ/ζ₁wᶜᶠᶠ + vertical_advection_U/V,
            # vector_invariant_advection.jl:325-330)
            adv_u = iz_c(grid, ix_f(grid, Az_w)
                         * ddz(grid, u, LOC_FCF)) / grid.Az(LOC_FCC)
            adv_v = iz_c(grid, iy_f(grid, Az_w)
                         * ddz(grid, v, LOC_CFF)) / grid.Az(LOC_CFC)
            return adv_u, adv_v

        # upwind: Φᵟ + δz(Az ŵ û) all divided by V
        # (reference: vertical_advection_U/V, vector_invariant_advection.jl:336-350)
        phi_u, phi_v = self._divergence_flux(grid, u, v, grid_motion)
        what_u = _sym(vas, grid, Az_w, X, 0)     # ccf → fcf
        az_u = dz_c(grid, what_u * vas.biased_by(grid, u, Z, 0, what_u))
        what_v = _sym(vas, grid, Az_w, Y, 0)     # ccf → cff
        az_v = dz_c(grid, what_v * vas.biased_by(grid, v, Z, 0, what_v))
        return ((phi_u + az_u) / grid.V(LOC_FCC),
                (phi_v + az_v) / grid.V(LOC_CFC))

    def _divergence_flux(self, grid, u, v, grid_motion=None):
        """Upwinded horizontal-divergence flux Φᵟ at fcc/cfc (reference:
        upwinded_divergence_flux_U/V in vector_invariant_self_upwinding.jl:20-44
        and vector_invariant_cross_upwinding.jl:36-56). ``grid_motion`` is the
        moving-grid contribution Az·Δr·∂t_σ at ccc (zero on static grids): it
        enters the SYMMETRIC (cross) part of the divergence in self-upwinding
        (δy_V_plus_∂t_σ / δx_U_plus_∂t_σ) and the whole upwinded divergence
        in cross-upwinding."""
        ds = self.divergence_scheme
        cross = self.upwinding_cross_scheme
        dU = dx_c(grid, grid.Ax(LOC_FCC) * u)    # δx(Ax u) at ccc
        dV = dy_c(grid, grid.Ay(LOC_CFC) * v)    # δy(Ay v) at ccc
        gm = 0.0 if grid_motion is None else grid_motion
        if self.upwinding == CROSS_AND_SELF:
            div = dU + dV + gm
            phi_u = u * ds.biased_by(grid, div, X, 0, u)
            phi_v = v * ds.biased_by(grid, div, Y, 0, v)
        else:
            div_smooth = [dU + dV]               # divergence_smoothness
            dvs = _sym(cross, grid, dV + gm, X, 0)
            phi_u = u * self._md(dvs + ds.biased_by(grid, dU, X, 0, u,
                                                    smooth=div_smooth), X)
            dus = _sym(cross, grid, dU + gm, Y, 0)
            phi_v = v * self._md(
                dus + ds.biased_by(grid, dV, Y, 0, v, smooth=div_smooth), Y)
        return phi_u, phi_v

    # -- assembly --------------------------------------------------------------

    def momentum_tendencies(self, grid, u, v, w, grid_motion=None,
                            zeta=None):
        """Return (U·∇u, U·∇v) — the advection contributions to be SUBTRACTED
        from the tendencies (reference: U_dot_∇u/U_dot_∇v,
        vector_invariant_advection.jl:279-285). ``grid_motion`` = Az·Δr·∂t_σ
        at ccc on moving (z-star) grids.
        ``zeta``: precomputed vertical vorticity at ffc, overriding
        zeta3_ffc — the cubed-sphere model passes the valence-3
        vertex-corrected field (the reference's MultiRegion corner
        treatment)."""
        import jax as _jax
        # barriers split XLA's single giant tendency fusion into per-term
        # fusions; the monolithic fusion was the slowest part of the
        # hydrostatic step on the original accelerator. Not yet re-measured
        # on the GPU.
        bar = _jax.lax.optimization_barrier
        h_u, h_v = bar(self._horizontal(grid, u, v, zeta=zeta))
        b_u, b_v = bar(self._bernoulli(grid, u, v))
        z_u, z_v = bar(self._vertical(grid, u, v, w, grid_motion))
        return h_u + b_u + z_u, h_v + b_v + z_v


def WENOVectorInvariant(order=None, vorticity_order=None, vertical_order=None,
                        divergence_order=None,
                        kinetic_energy_gradient_order=None,
                        vorticity_stencil=VELOCITY_STENCIL,
                        upwinding=ONLY_SELF, multi_dimensional_stencil=False,
                        **weno_kw):
    """Reference: WENOVectorInvariant convenience constructor
    (vector_invariant_advection.jl:204-250): defaults to WENO-9 vorticity
    (VelocityStencil smoothness) + WENO-5 vertical/divergence/KE gradient with
    OnlySelfUpwinding."""
    if order is None:
        vorticity_order = vorticity_order or 9
        vertical_order = vertical_order or 5
        divergence_order = divergence_order or 5
        kinetic_energy_gradient_order = kinetic_energy_gradient_order or 5
    else:
        vorticity_order = vorticity_order or order
        vertical_order = vertical_order or order
        divergence_order = divergence_order or order
        kinetic_energy_gradient_order = kinetic_energy_gradient_order or order
    return VectorInvariant(
        vorticity_scheme=WENO(vorticity_order, **weno_kw),
        vorticity_stencil=vorticity_stencil,
        vertical_advection_scheme=WENO(vertical_order, **weno_kw),
        divergence_scheme=WENO(divergence_order, **weno_kw),
        kinetic_energy_gradient_scheme=WENO(kinetic_energy_gradient_order,
                                            **weno_kw),
        upwinding=upwinding,
        multi_dimensional_stencil=multi_dimensional_stencil)
