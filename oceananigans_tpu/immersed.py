"""Immersed boundaries: solid topography inside the domain.

Reference semantics: src/ImmersedBoundaries/ —
* `ImmersedBoundaryGrid` wraps an underlying grid + an immersed boundary
  object and re-exports every metric/coordinate query
  (immersed_boundary_grid.jl).
* `GridFittedBottom` (grid_fitted_bottom.jl): cells whose center lies below a
  bottom-height field z_b(x, y) are solid.
* `GridFittedBoundary` (grid_fitted_boundary.jl): a general 3D mask function.
* masking (mask_immersed_field.jl): zero prognostic fields in solid cells
  after each step; conditional fluxes zero transport through immersed faces
  (conditional_differences.jl).

Design: the immersed geometry is a set of STATIC numpy masks baked into
the compiled step as constants — `where`-selects fuse into the stencil
kernels for free (branchless SIMD; the reference's active-cells-map gather
strategy trades badly on SIMD hardware where dense masked arithmetic is
cheaper than
irregular gathers — SURVEY.md §7 note)."""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from .grids.base import AbstractGrid, _mul, broadcastable_1d
from .grids.topology import CENTER, FACE, LOC_CCC, LOC_CCF, LOC_CFC, LOC_FCC


def _pad_columns(grid, a):
    """Topology-aware horizontal halo padding of an interior per-column
    array — the analogue of filling the reference's bottom-height Field
    halos (fill_halo_regions! on the bottom field at ImmersedBoundaryGrid
    construction): periodic axes WRAP so the mask/geometry at a periodic
    seam sees the true opposite-side topography (edge-padding there left
    seam faces unmasked and leaked transport through bathymetry steps —
    a round-5 fix found by the z* invariant suite); bounded/flat axes
    extend by the edge value, as the reference's default bottom BCs do."""
    a = np.asarray(a, a.dtype if hasattr(a, "dtype") else np.float64)
    for ax in (0, 1):
        if grid.H[ax] == 0:
            continue
        mode = "wrap" if str(grid.topology[ax]) == "periodic" else "edge"
        pad = [(0, 0)] * a.ndim
        pad[ax] = (grid.H[ax], grid.H[ax])
        a = np.pad(a, pad, mode=mode)
    return a


def _interior_centers_2d(grid):
    """Interior (x, y) center coordinates as broadcastable arrays."""
    x = np.asarray(grid.coord_padded(0, CENTER))[
        grid.H[0]:grid.H[0] + grid.N[0]].reshape(-1, 1)
    y = np.asarray(grid.coord_padded(1, CENTER))[
        grid.H[1]:grid.H[1] + grid.N[1]].reshape(1, -1)
    return x, y


def _bottom_padded_2d(grid, b):
    """Padded (npx, npy, 1) bottom-height array from a scalar, callable
    (evaluated on INTERIOR nodes, halos topology-padded), interior-shaped
    array, or an already-padded array (used verbatim — cubed-sphere panels
    pass exchange-valid padded bathymetry)."""
    if np.isscalar(b):
        return np.full(grid.padded_shape[:2] + (1,), float(b))
    if callable(b):
        x, y = _interior_centers_2d(grid)
        zb = np.broadcast_to(np.asarray(b(x, y), np.float64),
                             (grid.N[0], grid.N[1]))
        return _pad_columns(grid, zb)[..., None]
    zb = np.asarray(b, np.float64)
    if zb.shape == (grid.N[0], grid.N[1]):
        zb = _pad_columns(grid, zb)
    return zb[..., None] if zb.ndim == 2 else zb


class GridFittedBottom:
    def __init__(self, bottom_height):
        self.bottom_height = bottom_height

    def solid_centers(self, grid):
        """Boolean padded array: True where the cell center is below the
        bottom."""
        zc = broadcastable_1d(grid.coord_padded(2, CENTER), 2)
        zb = _bottom_padded_2d(grid, self.bottom_height)
        return np.broadcast_to(zc < zb, grid.padded_shape).copy()

    def _fp(self):
        b = self.bottom_height
        key = (id(b) if callable(b)
               else (b if np.isscalar(b) else np.asarray(b).tobytes()))
        return ("GridFittedBottom", key)


class PartialCellBottom:
    """Fractional bottom cells: the bottommost fluid cell of each column
    shrinks so its lower face sits on the bottom height, but never below
    ``minimum_fractional_cell_height·Δz`` (reference:
    src/ImmersedBoundaries/partial_cell_bottom.jl — immersed criterion
    `z⁺ - ϵΔz < zb` :143-150, numerical bottom capping :79-104, effective
    Δz at all 8 staggered locations :159-186)."""

    def __init__(self, bottom_height, minimum_fractional_cell_height=0.2):
        self.bottom_height = bottom_height
        self.epsilon = float(minimum_fractional_cell_height)

    def _zb_padded(self, grid):
        zb = _bottom_padded_2d(grid, self.bottom_height)
        return (np.broadcast_to(zb, grid.padded_shape[:2] + (1,)).copy()
                if zb.shape[:2] != grid.padded_shape[:2] else zb)

    def _geometry(self, grid):
        """(zb_adjusted, solid, dz_ccc_eff, dz_ccf_eff) padded numpy arrays."""
        h, n = grid.H[2], grid.N[2]
        npz = grid.padded_shape[2]
        zf = np.asarray(grid.coord_padded(2, FACE), np.float64)     # bottom faces
        zc = np.asarray(grid.coord_padded(2, CENTER), np.float64)
        dzc = np.broadcast_to(
            np.asarray(grid.dz((CENTER,) * 3), np.float64).reshape(-1), (npz,))
        ztop = zf + dzc                                             # top faces

        zb = np.clip(self._zb_padded(grid), zf[h], ztop[h + n - 1])
        # numerical bottom: cap so the partial cell is ≥ ϵΔz tall
        bottom_cell = (zf[None, None, :] <= zb) & (ztop[None, None, :] >= zb)
        capped = np.minimum(ztop[None, None, :] - self.epsilon * dzc, zb)
        zb = np.where(bottom_cell.any(axis=2, keepdims=True),
                      np.max(np.where(bottom_cell, capped, -np.inf), axis=2,
                             keepdims=True), zb)

        solid = (ztop[None, None, :] - self.epsilon * dzc) < zb
        fluid = ~solid
        below_solid = np.concatenate(
            [np.ones_like(solid[..., :1]), solid[..., :-1]], axis=2)
        bottommost = fluid & below_solid
        dz_ccc = np.where(bottommost, ztop[None, None, :] - zb, dzc)
        # face k just above a partial bottom cell k-1: Δzᶜᶜᶠ = zc[k] - zf[k]
        # + Δzᶜᶜᶜ(k-1)/2 (partial_cell_bottom.jl:169-178)
        just_above = np.concatenate(
            [np.zeros_like(bottommost[..., :1]), bottommost[..., :-1]], axis=2)
        dz_ccf_full = np.broadcast_to(
            np.asarray(grid.dz((CENTER, CENTER, FACE)),
                       np.float64).reshape(1, 1, -1), solid.shape)
        dz_prev = np.concatenate([dz_ccc[..., :1], dz_ccc[..., :-1]], axis=2)
        dz_ccf = np.where(just_above,
                          (zc - zf)[None, None, :] + dz_prev / 2, dz_ccf_full)
        return zb, solid, dz_ccc, dz_ccf

    def solid_centers(self, grid):
        return self._geometry(grid)[1]

    def effective_dz(self, grid):
        """{(lx_face, ly_face, lz_face): padded 3D Δz array} for all 8
        staggered locations (horizontal staggers take the MIN of adjacent
        columns — partial_cell_bottom.jl:180-186)."""
        _, _, dz_ccc, dz_ccf = self._geometry(grid)

        def minx(a):
            return a if grid.is_flat(0) else np.minimum(a, np.roll(a, 1, 0))

        def miny(a):
            return a if grid.is_flat(1) else np.minimum(a, np.roll(a, 1, 1))

        out = {}
        for lz_face, base in ((False, dz_ccc), (True, dz_ccf)):
            out[(False, False, lz_face)] = base
            out[(True, False, lz_face)] = minx(base)
            out[(False, True, lz_face)] = miny(base)
            out[(True, True, lz_face)] = miny(minx(base))
        return out

    def _fp(self):
        b = self.bottom_height
        key = (id(b) if callable(b)
               else (b if np.isscalar(b) else np.asarray(b).tobytes()))
        return ("PartialCellBottom", key, self.epsilon)


class GridFittedBoundary:
    """General mask: solid where mask(x, y, z) is True (reference:
    grid_fitted_boundary.jl)."""

    def __init__(self, mask):
        self.mask = mask

    def solid_centers(self, grid):
        # evaluate on INTERIOR nodes, then topology-pad (periodic axes
        # wrap, like the reference's mask-Field halo fill) — see
        # _pad_columns; z extends by edge (the reference's bounded default)
        x, y = _interior_centers_2d(grid)
        z = np.asarray(grid.coord_padded(2, CENTER))[
            grid.H[2]:grid.H[2] + grid.N[2]].reshape(1, 1, -1)
        m = np.broadcast_to(np.asarray(self.mask(x[..., None], y[..., None],
                                                 z), bool),
                            (grid.N[0], grid.N[1], grid.N[2]))
        m = _pad_columns(grid, m)
        if grid.H[2] or grid.padded_shape[2] != m.shape[2]:
            tail = grid.padded_shape[2] - m.shape[2] - grid.H[2]
            m = np.pad(m, [(0, 0), (0, 0), (grid.H[2], tail)], mode="edge")
        return np.broadcast_to(m, grid.padded_shape).copy()

    def _fp(self):
        return ("GridFittedBoundary", id(self.mask))


class ImmersedBoundaryGrid(AbstractGrid):
    def __init__(self, grid, immersed_boundary):
        self._underlying = grid
        self.immersed_boundary = immersed_boundary

        # PartialCellBottom carries effective (shrunken) Δz metric arrays
        self._dz_eff = (immersed_boundary.effective_dz(grid)
                        if hasattr(immersed_boundary, "effective_dz")
                        else None)
        solid_c = immersed_boundary.solid_centers(grid)
        self.solid_ccc = solid_c
        # a face is solid (no transport) if EITHER adjacent center is solid
        self.solid_fcc = solid_c | np.roll(solid_c, 1, 0)
        self.solid_cfc = solid_c | np.roll(solid_c, 1, 1)
        self.solid_ccf = solid_c | np.roll(solid_c, 1, 2)
        # fluid masks (float multipliers)
        self.mask = {
            LOC_CCC: (~self.solid_ccc),
            LOC_FCC: (~self.solid_fcc),
            LOC_CFC: (~self.solid_cfc),
            LOC_CCF: (~self.solid_ccf),
        }

    @property
    def underlying_grid(self):
        return self._underlying

    def fluid_mask(self, loc, dtype=None):
        m = self.mask.get(tuple(loc), ~self.solid_ccc)
        return jnp.asarray(m, dtype or self.dtype)

    def fluid_mask_at(self, loc, dtype=None):
        """Fluid mask at ANY staggered location: a point is solid if any of
        the 2^f adjacent cell centers (f = number of face-located axes) is
        solid — the dense-mask analogue of the reference's
        immersed_peripheral_node used to zero conditional fluxes
        (src/ImmersedBoundaries/conditional_differences.jl)."""
        key = ("at",) + tuple(loc)
        m = self.mask.get(key)
        if m is None:
            solid = self.solid_ccc
            for axis in range(3):
                if loc[axis] == FACE:
                    solid = solid | np.roll(solid, 1, axis)
            m = ~solid
            self.mask[key] = m
        return jnp.asarray(m, dtype or self.dtype)

    def mask_immersed(self, a, loc, value=0.0):
        """Zero (or set) a field inside the solid (reference:
        mask_immersed_field.jl)."""
        m = self.mask.get(tuple(loc), ~self.solid_ccc)
        return jnp.where(jnp.asarray(m), a, value)

    # -- delegation to the underlying grid ------------------------------------

    def __getattr__(self, name):
        return getattr(self._underlying, name)

    # explicit delegation for the metric protocol (AbstractGrid methods would
    # otherwise bind to self and miss the underlying data)
    def dx(self, loc):
        return self._underlying.dx(loc)

    def dy(self, loc):
        return self._underlying.dy(loc)

    def dz(self, loc):
        if self._dz_eff is not None:
            return self._dz_eff[(loc[0] == FACE, loc[1] == FACE,
                                 loc[2] == FACE)]
        return self._underlying.dz(loc)

    def Ax(self, loc):
        if self._dz_eff is not None:
            return _mul(self.dy(loc), self.dz(loc))
        return self._underlying.Ax(loc)

    def Ay(self, loc):
        if self._dz_eff is not None:
            return _mul(self.dx(loc), self.dz(loc))
        return self._underlying.Ay(loc)

    def Az(self, loc):
        # z-normal areas are untouched by partial cells
        return self._underlying.Az(loc)

    def V(self, loc):
        if self._dz_eff is not None:
            return _mul(self.Az(loc), self.dz(loc))
        return self._underlying.V(loc)

    def with_halo(self, halo):
        return ImmersedBoundaryGrid(self._underlying.with_halo(halo),
                                    self.immersed_boundary)

    def _fingerprint(self):
        return ("ImmersedBoundaryGrid", self._underlying._fingerprint(),
                self.immersed_boundary._fp())

    def __repr__(self):
        return (f"ImmersedBoundaryGrid({self._underlying!r}, "
                f"{type(self.immersed_boundary).__name__})")
