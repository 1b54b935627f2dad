"""Lagrangian particle tracking.

Reference semantics: src/Models/LagrangianParticleTracking/ —
`LagrangianParticles` over struct-of-arrays positions
(LagrangianParticleTracking.jl:30-90), advection with velocity interpolation
+ wall bouncing with restitution (lagrangian_particle_advection.jl:195-223),
tracked-field interpolation (update_lagrangian_particle_properties.jl).

Design: positions are (n,) arrays in the state pytree; interpolation is a
vectorized trilinear gather (fractional indices from `jnp.interp` against the
padded coordinate arrays — works on stretched grids too); the whole advection
step fuses into the jitted model step. The reference's per-particle kernel
launch disappears."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .grids.topology import BOUNDED, LOC_CCC, LOC_CCF, LOC_CFC, LOC_FCC, PERIODIC


def fractional_index(grid, axis, loc_axis, x):
    """Continuous padded-array index such that integer values sit ON the data
    points of the given location."""
    coords = jnp.asarray(grid.coord_padded(axis, loc_axis))
    return jnp.interp(x, coords, jnp.arange(coords.shape[0], dtype=x.dtype))


def interpolate_field(grid, data, loc, x, y, z):
    """Trilinear interpolation of a padded field at particle positions
    (reference: src/Fields/interpolate.jl:265-281 fractional-index scheme)."""
    idx = []
    for axis, (pos, l) in enumerate(zip((x, y, z), loc)):
        if grid.is_flat(axis):
            idx.append(jnp.zeros_like(pos))
        else:
            idx.append(fractional_index(grid, axis, l, pos))
    i, j, k = idx

    i0 = jnp.clip(jnp.floor(i).astype(jnp.int32), 0, data.shape[0] - 1)
    j0 = jnp.clip(jnp.floor(j).astype(jnp.int32), 0, data.shape[1] - 1)
    k0 = jnp.clip(jnp.floor(k).astype(jnp.int32), 0, data.shape[2] - 1)
    i1 = jnp.minimum(i0 + 1, data.shape[0] - 1)
    j1 = jnp.minimum(j0 + 1, data.shape[1] - 1)
    k1 = jnp.minimum(k0 + 1, data.shape[2] - 1)
    fx = jnp.clip(i - i0, 0.0, 1.0)
    fy = jnp.clip(j - j0, 0.0, 1.0)
    fz = jnp.clip(k - k0, 0.0, 1.0)

    def g(ii, jj, kk):
        return data[ii, jj, kk]

    c000, c100 = g(i0, j0, k0), g(i1, j0, k0)
    c010, c110 = g(i0, j1, k0), g(i1, j1, k0)
    c001, c101 = g(i0, j0, k1), g(i1, j0, k1)
    c011, c111 = g(i0, j1, k1), g(i1, j1, k1)
    c00 = c000 * (1 - fx) + c100 * fx
    c10 = c010 * (1 - fx) + c110 * fx
    c01 = c001 * (1 - fx) + c101 * fx
    c11 = c011 * (1 - fx) + c111 * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


class LagrangianParticles:
    """Particle configuration + advection logic. Positions live in the model
    state under ``state["particles"]``."""

    def __init__(self, x, y, z, restitution=1.0, tracked_fields=(),
                 dynamics=None, properties=None):
        """``properties``: dict name → (n,) array of custom per-particle
        properties carried in the state pytree (reference: arbitrary
        particle struct fields, LagrangianParticleTracking.jl:30-90);
        ``dynamics``: DroguedParticleDynamics, or a traceable callable
        ``dynamics(grid, fields, particles, dt) -> particles`` run after
        advection (reference: the custom `dynamics!` hook)."""
        self.n = len(np.atleast_1d(x))
        self.initial = dict(x=jnp.asarray(np.atleast_1d(x)),
                            y=jnp.asarray(np.atleast_1d(y)),
                            z=jnp.asarray(np.atleast_1d(z)))
        for name, val in dict(properties or {}).items():
            self.initial[name] = jnp.asarray(np.atleast_1d(val))
        self.restitution = float(restitution)
        self.tracked_fields = tuple(tracked_fields)
        self.dynamics = dynamics

    def _bounce(self, grid, axis, pos):
        """Periodic wrap or wall bounce with restitution (reference:
        lagrangian_particle_advection.jl bouncing)."""
        topo = grid.topology[axis]
        c = grid.coord_padded(axis, "f")
        h = grid.H[axis]
        lo = float(c[h])
        hi = lo + float(grid.extent[axis])
        if topo == PERIODIC:
            return lo + jnp.mod(pos - lo, hi - lo)
        if topo == BOUNDED:
            r = self.restitution
            over = jnp.maximum(pos - hi, 0.0)
            under = jnp.maximum(lo - pos, 0.0)
            return jnp.clip(pos - (1 + r) * over + (1 + r) * under, lo, hi)
        return pos

    def _cell_index(self, grid, axis, pos):
        """Padded index of the cell containing ``pos`` (face ``i`` is the
        left face of cell ``i``)."""
        fi = fractional_index(grid, axis, "f", pos)
        npad = grid.padded_shape[axis]
        return jnp.clip(jnp.floor(fi).astype(jnp.int32), 0, npad - 1)

    def _bounce_immersed(self, grid, prev, pos):
        """Bounce particles that advected into a solid cell back into their
        previous (wet) cell with restitution (reference:
        lagrangian_particle_advection.jl:60-100 bounce_immersed_particle)."""
        solid = jnp.asarray(grid.solid_ccc)
        x, y, z = pos
        idx = [self._cell_index(grid, ax, p)
               if not grid.is_flat(ax) else jnp.zeros_like(p, jnp.int32)
               for ax, p in enumerate(pos)]
        immersed = solid[tuple(idx)]
        r = self.restitution
        out = []
        for ax, (p0, p) in enumerate(zip(prev, pos)):
            if grid.is_flat(ax):
                out.append(p)
                continue
            faces = jnp.asarray(grid.coord_padded(ax, "f"))
            i_prev = self._cell_index(grid, ax, p0)
            lo = faces[i_prev]
            hi = faces[jnp.minimum(i_prev + 1, faces.shape[0] - 1)]
            over = jnp.maximum(p - hi, 0.0)
            under = jnp.maximum(lo - p, 0.0)
            pb = jnp.clip(p - (1 + r) * over + (1 + r) * under, lo, hi)
            out.append(jnp.where(immersed, pb, p))
        return tuple(out)

    def advect(self, grid, u, v, w, particles, dt, fields=None):
        """Forward-Euler advection (the reference's scheme) of all particles,
        vectorized. With `DroguedParticleDynamics`, velocities are sampled at
        the drogue depths and z stays fixed (reference:
        LagrangianParticleTracking/drogued_dynamics.jl). On immersed grids,
        particles advected into the topography bounce back into their
        previous cell (reference: bounce_immersed_particle)."""
        x0, y0, z0 = particles["x"], particles["y"], particles["z"]
        x, y, z = x0, y0, z0
        drogued = isinstance(self.dynamics, DroguedParticleDynamics)
        zs = self.dynamics.depths if drogued else z
        up = interpolate_field(grid, u, LOC_FCC, x, y, zs)
        vp = interpolate_field(grid, v, LOC_CFC, x, y, zs)
        if not drogued:
            # sample w at the ORIGINAL position like u, v (the reference's
            # forward Euler interpolates all three at the pre-step
            # position; sampling at the already-moved x, y was both
            # time-inconsistent and out-of-domain for edge-crossing
            # particles — round-5 review finding)
            wp = interpolate_field(grid, w, LOC_CCF, x, y, z)
        x = x + dt * up
        y = y + dt * vp
        if not drogued:
            z = z + dt * wp
            if not grid.is_flat(2):
                z = self._bounce(grid, 2, z)
        if not grid.is_flat(0):
            x = self._bounce(grid, 0, x)
        if not grid.is_flat(1):
            y = self._bounce(grid, 1, y)
        if hasattr(grid, "solid_ccc"):
            x, y, z = self._bounce_immersed(grid, (x0, y0, z0), (x, y, z))
        new = dict(particles, x=x, y=y, z=z)
        if self.dynamics is not None and not drogued \
                and callable(self.dynamics):
            new = self.dynamics(grid, fields or {}, new, dt)
        return new

    _FIELD_LOCS = {"u": LOC_FCC, "v": LOC_CFC, "w": LOC_CCF}

    def track(self, grid, fields, particles):
        """Interpolate tracked fields onto particles at each field's OWN
        staggered location (reference:
        update_lagrangian_particle_properties.jl; velocities were
        previously sampled with cell-center coordinates, displacing every
        sample by half a cell — round-5 review finding)."""
        out = dict(particles)
        for name in self.tracked_fields:
            loc = self._FIELD_LOCS.get(name, LOC_CCC)
            out[name] = interpolate_field(grid, fields[name], loc,
                                          particles["x"], particles["y"],
                                          particles["z"])
        return out


class DroguedParticleDynamics:
    """Buoy-like particles drogued at fixed ``depths``: advected horizontally
    by the velocity at the drogue depth, z position unchanged (reference:
    src/Models/LagrangianParticleTracking/drogued_dynamics.jl)."""

    def __init__(self, depths):
        self.depths = jnp.asarray(np.atleast_1d(depths))
