"""z* (free-surface-following) vertical coordinate support.

Reference semantics: src/Grids/vertical_discretization.jl
(MutableVerticalDiscretization with σⁿ, σ⁻, ∂t_σ scale factors),
src/Models/HydrostaticFreeSurfaceModels/z_star_vertical_spacing.jl (σ at
each horizontal staggering from THAT staggering's column depth:
σᶜᶜᵃ = (Hᶜᶜ + η)/Hᶜᶜ, σᶠᶜᵃ = (Hᶠᶜ + ℑx η)/Hᶠᶜ, … — on immersed grids H is
the FLUID column depth, column_depthᶠᶜᵃ) and
hydrostatic_free_surface_ab2_step.jl:116-130 (σ-weighted conservative tracer
update c ← (σⁿ c + Δt G)/σⁿ⁺¹).

Design: the static grid never changes; a lightweight TRACED proxy wraps it
with the σ(x, y, t) scale factors, and the operator layer — which only ever
asks for broadcastable metric factors — consumes the traced metrics
unchanged. Land columns (immersed grids) keep σ ≡ 1 so the solid-region
metrics stay finite; all transports through solid faces are masked to zero
anyway. The grid-motion contribution to the diagnostic vertical velocity
(the ∂t_σ term) is included in HydrostaticFreeSurfaceModel._w_from_continuity
and enters the upwinded vector-invariant divergence flux via the lagged
Az·Δr·∂t_σ state."""

from __future__ import annotations

import jax.numpy as jnp

from ..operators.operators import interp


class ZStarGrid:
    """Ephemeral moving-grid proxy: metrics scaled by σ = (H + η)/H.

    ``sigmas``: either a single padded (npx, npy, 1) traced array at cell
    centers (σ at faces is then interpolated), or a dict
    {("c","c"): σcc, ("f","c"): σfc, ("c","f"): σcf} of per-staggering
    scale factors (the reference's exact per-staggering form — required on
    immersed grids where the fluid depth varies per staggering)."""

    def __init__(self, base, sigmas):
        self.base = base
        if not isinstance(sigmas, dict):
            sigmas = {("c", "c"): sigmas}
        self.sigmas = sigmas

    # -- σ at staggered horizontal locations -----------------------------------

    def _sigma_at(self, loc):
        key = (loc[0], loc[1])
        s = self.sigmas.get(key)
        if s is not None:
            return s
        s = self.sigmas[("c", "c")]
        if loc[0] == "f":
            s = self.sigmas.get(("f", "c"))
            s = interp(self.base, self.sigmas[("c", "c")], 0, "f") \
                if s is None else s
            if loc[1] == "f":
                s = interp(self.base, s, 1, "f")
            return s
        if loc[1] == "f":
            s = self.sigmas.get(("c", "f"))
            return interp(self.base, self.sigmas[("c", "c")], 1, "f") \
                if s is None else s
        return s

    # -- metrics ---------------------------------------------------------------

    def dz(self, loc):
        return self.base.dz(loc) * self._sigma_at(loc)

    def dx(self, loc):
        return self.base.dx(loc)

    def dy(self, loc):
        return self.base.dy(loc)

    def Ax(self, loc):
        return self.base.dy(loc) * self.dz(loc)

    def Ay(self, loc):
        return self.base.dx(loc) * self.dz(loc)

    def Az(self, loc):
        return self.base.Az(loc)

    def V(self, loc):
        return self.base.Az(loc) * self.dz(loc)

    # -- delegation -------------------------------------------------------------

    def __getattr__(self, name):
        return getattr(self.base, name)


def sigma_from_eta(grid, eta, depth, wet=None):
    """σ = (H + η)/H at one staggering, given that staggering's (possibly
    per-column fluid) depth; land columns (``wet`` false) keep σ = 1."""
    s = 1.0 + eta / depth
    if wet is None:
        return s
    return jnp.where(wet, s, jnp.ones_like(s))
