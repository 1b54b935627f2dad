"""Coriolis forces.

Reference semantics: src/Coriolis/ — `FPlane` (fplane.jl), `BetaPlane`
(beta_plane.jl), `ConstantCartesianCoriolis` (constant_cartesian_coriolis.jl),
`NonTraditionalBetaPlane` (non_traditional_beta_plane.jl). The interface is
the tendency contributions x_f_cross_U / y_f_cross_U / z_f_cross_U at the
(f,c,c)/(c,f,c)/(c,c,f) locations, built from 4-point interpolations of the
staggered transverse velocities (energy-conserving discretization).

Each object is static config; methods take (grid, u, v, w) padded arrays and
return the MINUS-f×U contribution is NOT applied here — these return the
components of f×U, which the tendency assembly subtracts."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .defaults import defaults
from .operators.operators import (ix_c, ix_f, iy_c, iy_f, iz_c, iz_f)


def _v_at_fcc(grid, v):
    # (c,f,c) → (f,c,c): interp x to face, y to center
    return ix_f(grid, iy_c(grid, v))


def _u_at_cfc(grid, u):
    return iy_f(grid, ix_c(grid, u))


def _w_at_fcc(grid, w):
    return ix_f(grid, iz_c(grid, w))


def _u_at_ccf(grid, u):
    return iz_f(grid, ix_c(grid, u))


def _w_at_cfc(grid, w):
    return iy_f(grid, iz_c(grid, w))


def _v_at_ccf(grid, v):
    return iz_f(grid, iy_c(grid, v))


class FPlane:
    """f-plane: f×U = (-f v, f u, 0) (reference: src/Coriolis/fplane.jl)."""

    def __init__(self, f=None, rotation_rate=None, latitude=None):
        if f is None:
            rr = defaults.rotation_rate if rotation_rate is None else rotation_rate
            if latitude is None:
                raise ValueError("provide f or latitude")
            f = 2 * rr * np.sin(np.deg2rad(latitude))
        self.f = float(f)

    def _fp(self):
        return ("FPlane", self.f)

    def __hash__(self):
        return hash(self._fp())

    def __eq__(self, o):
        return hasattr(o, "_fp") and self._fp() == o._fp()

    def x_f_cross_U(self, grid, u, v, w):
        return -self.f * _v_at_fcc(grid, v)

    def y_f_cross_U(self, grid, u, v, w):
        return self.f * _u_at_cfc(grid, u)

    def z_f_cross_U(self, grid, u, v, w):
        return jnp.zeros_like(w)


class ConstantCartesianCoriolis:
    """Rotation axis in an arbitrary direction: f×U with
    f = (fx, fy, fz) (reference: constant_cartesian_coriolis.jl)."""

    def __init__(self, fx=0.0, fy=0.0, fz=0.0, f=None, rotation_axis=None):
        if f is not None:
            ax = np.asarray(rotation_axis if rotation_axis is not None
                            else (0, 0, 1.0), float)
            ax = ax / np.linalg.norm(ax)
            fx, fy, fz = f * ax
        self.fx, self.fy, self.fz = float(fx), float(fy), float(fz)

    def _fp(self):
        return ("ConstantCartesianCoriolis", self.fx, self.fy, self.fz)

    __hash__ = FPlane.__hash__
    __eq__ = FPlane.__eq__

    def x_f_cross_U(self, grid, u, v, w):
        return self.fy * _w_at_fcc(grid, w) - self.fz * _v_at_fcc(grid, v)

    def y_f_cross_U(self, grid, u, v, w):
        return self.fz * _u_at_cfc(grid, u) - self.fx * _w_at_cfc(grid, w)

    def z_f_cross_U(self, grid, u, v, w):
        return self.fx * _v_at_ccf(grid, v) - self.fy * _u_at_ccf(grid, u)


class BetaPlane:
    """f = f₀ + βy (reference: beta_plane.jl)."""

    def __init__(self, f0=None, beta=None, rotation_rate=None, latitude=None,
                 radius=None):
        if f0 is None or beta is None:
            rr = defaults.rotation_rate if rotation_rate is None else rotation_rate
            R = defaults.planet_radius if radius is None else radius
            phi = np.deg2rad(latitude)
            f0 = 2 * rr * np.sin(phi)
            beta = 2 * rr * np.cos(phi) / R
        self.f0, self.beta = float(f0), float(beta)

    def _fp(self):
        return ("BetaPlane", self.f0, self.beta)

    __hash__ = FPlane.__hash__
    __eq__ = FPlane.__eq__

    def _f_at(self, grid, yloc):
        y = grid.coord_padded(1, yloc).reshape(1, -1, 1)
        return (self.f0 + self.beta * y)

    def x_f_cross_U(self, grid, u, v, w):
        return -self._f_at(grid, "c") * _v_at_fcc(grid, v)

    def y_f_cross_U(self, grid, u, v, w):
        return self._f_at(grid, "f") * _u_at_cfc(grid, u)

    def z_f_cross_U(self, grid, u, v, w):
        return jnp.zeros_like(w)


class NonTraditionalBetaPlane:
    """Full-Coriolis beta plane retaining the horizontal rotation component
    (reference: non_traditional_beta_plane.jl, Dellar 2011 §5):

        2Ωʸ(y, z) = fy (1 −  z/R) + γ y
        2Ωᶻ(y, z) = fz (1 + 2z/R) + β y

    with (fz, fy, β, γ) = (2Ω sin φ, 2Ω cos φ, 2Ω cos φ/R, −4Ω sin φ/R)
    from ``latitude``. The previous form zeroed γ's contribution to Ωᶻ
    behind a dead `* 0` and attached γ to the wrong component entirely
    (round-5 review finding)."""

    def __init__(self, fz0=None, beta=None, fy0=None, gamma=None,
                 rotation_rate=None, latitude=None, radius=None):
        rr = defaults.rotation_rate if rotation_rate is None else rotation_rate
        R = defaults.planet_radius if radius is None else radius
        if latitude is not None:
            phi = np.deg2rad(latitude)
            fz0 = 2 * rr * np.sin(phi) if fz0 is None else fz0
            beta = 2 * rr * np.cos(phi) / R if beta is None else beta
            fy0 = 2 * rr * np.cos(phi) if fy0 is None else fy0
            gamma = -4 * rr * np.sin(phi) / R if gamma is None else gamma
        self.fz0, self.beta = float(fz0), float(beta)
        self.fy0, self.gamma = float(fy0), float(gamma or 0.0)
        self.R = float(R)

    def _fp(self):
        return ("NonTraditionalBetaPlane", self.fz0, self.beta, self.fy0,
                self.gamma, self.R)

    __hash__ = FPlane.__hash__
    __eq__ = FPlane.__eq__

    def _two_Oy(self, grid, yloc, zloc):
        y = grid.coord_padded(1, yloc).reshape(1, -1, 1)
        z = grid.coord_padded(2, zloc).reshape(1, 1, -1)
        return (self.fy0 * (1 - z / self.R) + self.gamma * y)

    def _two_Oz(self, grid, yloc, zloc):
        y = grid.coord_padded(1, yloc).reshape(1, -1, 1)
        z = grid.coord_padded(2, zloc).reshape(1, 1, -1)
        return (self.fz0 * (1 + 2 * z / self.R) + self.beta * y)

    def x_f_cross_U(self, grid, u, v, w):
        # reference: ℑxᶠᵃᵃ(2Ωʸ·ℑz w − 2Ωᶻ·ℑy v) evaluated at ccc first
        from .operators.operators import ix_f, iy_c, iz_c
        Oy = self._two_Oy(grid, "c", "c")
        Oz = self._two_Oz(grid, "c", "c")
        return ix_f(grid, Oy * iz_c(grid, w) - Oz * iy_c(grid, v))

    def y_f_cross_U(self, grid, u, v, w):
        return self._two_Oz(grid, "f", "c") * _u_at_cfc(grid, u)

    def z_f_cross_U(self, grid, u, v, w):
        return -self._two_Oy(grid, "c", "f") * _u_at_ccf(grid, u)


class HydrostaticSphericalCoriolis:
    """f = 2Ω sin(φ) on a spherical grid (reference:
    src/Coriolis/hydrostatic_spherical_coriolis.jl).

    On a LatitudeLongitudeGrid (1D latitude) the transverse velocity is the
    plain 4-point mean. On curvilinear 2D-latitude grids
    (OrthogonalSphericalShellGrid: cubed-sphere panels, tripolar) f is
    evaluated at the exact (f,f) nodes and the reference's
    ENERGY-CONSERVING discretization applies: the Coriolis acceleration is
    the f-flux of the metric-weighted transport,
    fᶠᶠ·ℑx(Δx_cfc v) averaged to fcc / Δx_fcc (the f-part of the Sadourny
    vorticity flux — hydrostatic_spherical_coriolis.jl
    EnergyConserving scheme)."""

    def __init__(self, rotation_rate=None, scheme="energy_conserving"):
        self.rotation_rate = (defaults.rotation_rate if rotation_rate is None
                              else float(rotation_rate))
        if scheme not in ("energy_conserving", "enstrophy_conserving"):
            raise ValueError(scheme)
        self.scheme = scheme

    def _fp(self):
        return ("HydrostaticSphericalCoriolis", self.rotation_rate,
                self.scheme)

    __hash__ = FPlane.__hash__
    __eq__ = FPlane.__eq__

    def _f(self, grid, yloc):
        phi = grid.coord_padded(1, yloc).reshape(1, -1, 1)
        return (2 * self.rotation_rate * np.sin(np.deg2rad(
            np.clip(phi, -90, 90))))

    def _f_ffc(self, grid):
        if hasattr(grid, "nodes2d_padded"):
            _, phi = grid.nodes2d_padded(("f", "f"))
            return (2 * self.rotation_rate
                         * np.sin(np.deg2rad(phi))[..., None])
        # 1D-latitude spherical grid: f at the (f,f) node is just f(phi_f)
        phi = grid.coord_padded(1, "f").reshape(1, -1, 1)
        return (2 * self.rotation_rate
                     * np.sin(np.deg2rad(np.clip(phi, -90, 90))))

    def x_f_cross_U(self, grid, u, v, w):
        # metric-weighted Sadourny forms on EVERY spherical grid (the
        # reference applies them on LatitudeLongitudeGrid too, where
        # Δx varies with latitude — hydrostatic_spherical_coriolis.jl:71-97;
        # round-5 review: lat-lon previously got an unweighted 4-point mean
        # that ignored the requested scheme)
        from .grids.topology import LOC_CFC, LOC_FCC
        f = self._f_ffc(grid)
        dx_cfc, dx_fcc = grid.dx(LOC_CFC), grid.dx(LOC_FCC)
        if self.scheme == "energy_conserving":
            return -iy_c(grid, f * ix_f(grid, dx_cfc * v)) / dx_fcc
        return -iy_c(grid, f) * ix_f(grid, iy_c(grid, dx_cfc * v)) \
            / dx_fcc

    def y_f_cross_U(self, grid, u, v, w):
        from .grids.topology import LOC_CFC, LOC_FCC
        f = self._f_ffc(grid)
        # an x-interp of the BROADCAST (1, Ny, 1) f alone is a no-op on the
        # 1D-lat grid (f is zonally uniform) and the slice-based interp
        # helpers would halve it — but the energy form's outer ℑx acts on
        # the full f·ℑy(Δy u) product, which varies in x, so only the
        # bare-f interp of the enstrophy form may be skipped (skipping the
        # product interp broke the discrete zero-work property; round-5
        # self-review)
        fx = f if f.shape[0] == 1 else ix_c(grid, f)
        dy_fcc, dy_cfc = grid.dy(LOC_FCC), grid.dy(LOC_CFC)
        if self.scheme == "energy_conserving":
            return ix_c(grid, f * iy_f(grid, dy_fcc * u)) / dy_cfc
        return fx * iy_f(grid, ix_c(grid, dy_fcc * u)) / dy_cfc

    def z_f_cross_U(self, grid, u, v, w):
        return jnp.zeros_like(w)
