"""Advective flux divergences for tracers and momentum (flux form).

Reference semantics: src/Advection/tracer_advection_operators.jl (div_Uc),
momentum_advection_operators.jl (div_𝐯u/v/w — flux locations and the
advecting/advected decomposition), upwind_biased_advective_fluxes.jl
(advecting velocity = scheme's symmetric interpolation of A·q; advected
quantity = biased reconstruction selected by the advecting velocity's sign).

Vectorized upwinding: the upwind reconstruction is selected by the sign of
the advecting velocity with a mask (the vector form of the reference's
scalar ``upwind_biased_product``); there is no divergent control flow.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..grids.topology import CENTER, FACE
from ..operators.operators import (LOC_CCC, LOC_CCF, LOC_CFC, LOC_FCC,
                                   _delta_c, _delta_f)

X, Y, Z = 0, 1, 2


def _upwind(q, left, right):
    """q > 0 selects the left-biased value, q < 0 the right-biased one."""
    return jnp.where(q > 0, left, right)


def _biased_by(scheme, grid, a, axis, beta, q, zbc=None):
    return scheme.biased_by(grid, a, axis, beta, q, zbc=zbc)


# -- tracer advection ----------------------------------------------------------

def div_Uc(grid, scheme, u, v, w, c, zbc=None):
    """Tracer advective flux divergence at ccc (reference:
    tracer_advection_operators.jl: div_Uc = V⁻¹[δxᶜ(Ax u ĉ) + …]).

    ``zbc``: halo-free z-boundary mode (the model's z-compact layout) — the
    dict gives each variable's z-mirror parity; the flux deltas need no
    fix-ups because boundary-face fluxes vanish (w = 0 faces) and the
    out-of-range shift zero-fill reproduces exactly that."""
    if scheme is None:
        return jnp.zeros_like(c)
    if getattr(scheme, "bounds", None) is not None:
        if zbc is not None:
            # the z-compact path lacks the limiter's parity shifts
            raise NotImplementedError(
                "bounds-preserving advection is not supported on the "
                "z-compact layout")
        return _div_Uc_bounded(grid, scheme, u, v, w, c)
    total = None
    for axis, vel, A in ((X, u, grid.Ax(LOC_FCC)),
                         (Y, v, grid.Ay(LOC_CFC)),
                         (Z, w, grid.Az(LOC_CCF))):
        if grid.is_flat(axis):
            continue
        kind = zbc["c"] if (zbc is not None and axis == Z) else None
        chat = _biased_by(scheme, grid, c, axis, 0, vel, zbc=kind)
        term = _delta_c(grid, A * vel * chat, axis)
        total = term if total is None else total + term
    if total is None:
        return jnp.zeros_like(c)
    return total / grid.V(LOC_CCC)


# Bounds-preserving limiter constants (reference:
# bounds_preserving_tracer_advection_operators.jl: _ω̂₁ = _ω̂ₙ = 5/18, ε₂)
_OMEGA_HAT = 5.0 / 18.0
_EPS2 = 1e-20


def _div_Uc_bounded(grid, scheme, u, v, w, c):
    """Bounds-preserving WENO tracer flux divergence (reference:
    bounds_preserving_tracer_advection_operators.jl): per cell, a limiter
    factor θ scales the outward face reconstructions back toward the cell
    mean so the updated tracer stays inside ``scheme.bounds``."""
    from ..operators.shifts import shift

    lo, hi = scheme.bounds
    total = None
    for axis, vel, A in ((X, u, grid.Ax(LOC_FCC)),
                         (Y, v, grid.Ay(LOC_CFC)),
                         (Z, w, grid.Az(LOC_CCF))):
        if grid.is_flat(axis):
            continue
        # biased reconstructions at every face (face i = left face of cell i)
        cl, cr = scheme.biased_pair(grid, c, axis, 0)
        # cell i's outward reconstructions: right-biased at its left face,
        # left-biased at its right face (= face i+1)
        c_minus_R = cr
        c_plus_L = shift(cl, +1, axis)
        p_tilde = (c - _OMEGA_HAT * c_minus_R - _OMEGA_HAT * c_plus_L) \
            / (1 - 2 * _OMEGA_HAT)
        M = jnp.maximum(jnp.maximum(p_tilde, c_plus_L), c_minus_R)
        m = jnp.minimum(jnp.minimum(p_tilde, c_plus_L), c_minus_R)
        theta = jnp.minimum(
            jnp.minimum(jnp.abs((hi - c) / (M - c + _EPS2)),
                        jnp.abs((lo - c) / (m - c + _EPS2))),
            jnp.ones_like(c))
        # limited face values: at face i the left-biased value belongs to
        # cell i-1, the right-biased value to cell i
        theta_left = shift(theta, -1, axis)
        c_left_lim = theta_left * (cl - shift(c, -1, axis)) \
            + shift(c, -1, axis)
        c_right_lim = theta * (cr - c) + c
        flux = A * vel * _upwind(vel, c_left_lim, c_right_lim)
        term = _delta_c(grid, flux, axis)
        total = term if total is None else total + term
    if total is None:
        return jnp.zeros_like(c)
    return total / grid.V(LOC_CCC)


# -- momentum advection (flux form) --------------------------------------------

def div_Uu(grid, scheme, u, v, w, zbc=None, advected=None):
    """∇·(𝐯 u) at fcc (reference: momentum_advection_operators.jl div_𝐯u).

    ``advected``: reconstruct this field instead of ``u`` itself (the
    reference's two-argument div_𝐯u(advection, U, u) form, used by the
    background-field cross terms) — the (u, v, w) args always build the
    advecting transports."""
    if scheme is None:
        return jnp.zeros_like(u)
    au = u if advected is None else advected
    Ax_u = grid.Ax(LOC_FCC) * u
    Ay_v = grid.Ay(LOC_CFC) * v
    Az_w = grid.Az(LOC_CCF) * w
    terms = []
    if not grid.is_flat(X):
        ut = scheme.symmetric(grid, Ax_u, X, 1)          # fcc → ccc
        uhat = _biased_by(scheme, grid, au, X, 1, ut)
        terms.append(_delta_f(grid, ut * uhat, X))       # ccc → fcc
    if not grid.is_flat(Y):
        vt = scheme.symmetric(grid, Ay_v, X, 0)          # cfc → ffc
        uhat = _biased_by(scheme, grid, au, Y, 0, vt)
        terms.append(_delta_c(grid, vt * uhat, Y))       # ffc → fcc
    if not grid.is_flat(Z):
        wt = scheme.symmetric(grid, Az_w, X, 0)          # ccf → fcf
        uhat = _biased_by(scheme, grid, au, Z, 0, wt,
                          zbc=zbc["u"] if zbc else None)
        terms.append(_delta_c(grid, wt * uhat, Z))       # fcf → fcc
    if not terms:
        return jnp.zeros_like(u)
    return sum(terms) / grid.V(LOC_FCC)


def div_Uv(grid, scheme, u, v, w, zbc=None, advected=None):
    """∇·(𝐯 v) at cfc; ``advected`` as in :func:`div_Uu`."""
    if scheme is None:
        return jnp.zeros_like(v)
    av = v if advected is None else advected
    Ax_u = grid.Ax(LOC_FCC) * u
    Ay_v = grid.Ay(LOC_CFC) * v
    Az_w = grid.Az(LOC_CCF) * w
    terms = []
    if not grid.is_flat(X):
        ut = scheme.symmetric(grid, Ax_u, Y, 0)          # fcc → ffc
        vhat = _biased_by(scheme, grid, av, X, 0, ut)
        terms.append(_delta_c(grid, ut * vhat, X))       # ffc → cfc
    if not grid.is_flat(Y):
        vt = scheme.symmetric(grid, Ay_v, Y, 1)          # cfc → ccc
        vhat = _biased_by(scheme, grid, av, Y, 1, vt)
        terms.append(_delta_f(grid, vt * vhat, Y))       # ccc → cfc
    if not grid.is_flat(Z):
        wt = scheme.symmetric(grid, Az_w, Y, 0)          # ccf → cff
        vhat = _biased_by(scheme, grid, av, Z, 0, wt,
                          zbc=zbc["v"] if zbc else None)
        terms.append(_delta_c(grid, wt * vhat, Z))       # cff → cfc
    if not terms:
        return jnp.zeros_like(v)
    return sum(terms) / grid.V(LOC_CFC)


def div_Uw(grid, scheme, u, v, w, zbc=None, advected=None):
    """∇·(𝐯 w) at ccf; ``advected`` as in :func:`div_Uu`."""
    if scheme is None:
        return jnp.zeros_like(w)
    aw = w if advected is None else advected
    Ax_u = grid.Ax(LOC_FCC) * u
    Ay_v = grid.Ay(LOC_CFC) * v
    Az_w = grid.Az(LOC_CCF) * w
    terms = []
    zw = zbc["w"] if zbc else None
    if not grid.is_flat(X):
        # NOTE the advected quantity here is w but the z-INTERPOLATED
        # advecting velocity is u (z-centered, even parity)
        ut = scheme.symmetric(grid, Ax_u, Z, 0,
                              zbc=zbc["u"] if zbc else None)  # fcc → fcf
        what = _biased_by(scheme, grid, aw, X, 0, ut)
        terms.append(_delta_c(grid, ut * what, X))       # fcf → ccf
    if not grid.is_flat(Y):
        vt = scheme.symmetric(grid, Ay_v, Z, 0,
                              zbc=zbc["v"] if zbc else None)  # cfc → cff
        what = _biased_by(scheme, grid, aw, Y, 0, vt)
        terms.append(_delta_c(grid, vt * what, Y))       # cff → ccf
    if not grid.is_flat(Z):
        wt = scheme.symmetric(grid, Az_w, Z, 1, zbc=zw)  # ccf → ccc
        what = _biased_by(scheme, grid, aw, Z, 1, wt, zbc=zw)
        terms.append(_delta_f(grid, wt * what, Z))       # ccc → ccf
    if not terms:
        return jnp.zeros_like(w)
    return sum(terms) / grid.V(LOC_CCF)


def cell_advection_timescale(grid, u, v, w):
    """min over cells of min(Δx/|u|, Δy/|v|, Δz/|w|) (reference:
    src/Advection/cell_advection_timescale.jl). Used by the CFL wizard."""
    eps = 1e-20
    terms = []
    ints = grid.interior_slices
    if not grid.is_flat(X):
        terms.append(jnp.min((grid.dx(LOC_CCC) / (jnp.abs(u) + eps))[ints]))
    if not grid.is_flat(Y):
        terms.append(jnp.min((grid.dy(LOC_CCC) / (jnp.abs(v) + eps))[ints]))
    if not grid.is_flat(Z):
        terms.append(jnp.min((grid.dz(LOC_CCC) / (jnp.abs(w) + eps))[ints]))
    return jnp.min(jnp.stack([jnp.asarray(t) for t in terms]))
