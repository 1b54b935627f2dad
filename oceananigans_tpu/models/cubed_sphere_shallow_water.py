"""Shallow-water dynamics on the composed (6-panel) cubed sphere.

Reference analogue: the MultiRegion cubed-sphere model support
(src/MultiRegion/cubed_sphere_grid.jl + multi_region_models.jl) with the
ShallowWaterModel (src/Models/ShallowWaterModels/shallow_water_model.jl) —
the reference runs its models on cubed-sphere grids through per-region
kernel launches and connectivity-driven halo exchange. Here the
composition is ONE stacked (6, npx, npy, 1) array per field, panels unrolled
inside a single jitted step, with the static-gather inter-panel exchanges
(grids/cubed_sphere.py) between stages.

Scheme: C-grid vector-invariant, Sadourny (1975) energy-conserving potential
vorticity flux (the same discrete form as advection/vector_invariant.py's
ENERGY branch, with PV q = (ζ+f)/h and thickness-weighted mass fluxes),
flux-form mass continuity, Wicker-Skamarock RK3. Global mass is conserved
to roundoff because the shared-edge face fluxes are computed from identical
(exchanged) values on both panels.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..defaults import defaults
from ..grids.cubed_sphere import (ConformalCubedSphereGrid,
                                  fill_cubed_sphere_halos,
                                  fill_cubed_sphere_velocity_halos,
                                  sync_shared_velocity_faces)
from ..operators.operators import (LOC_CCC, LOC_CFC, LOC_FCC,
                                   ddx, ddy, dx_c, dy_c, ix_c, ix_f,
                                   iy_c, iy_f, zeta3_ffc)


def _unit(a):
    return a / np.linalg.norm(a, axis=-1, keepdims=True)


def staggered_points_and_bases(csgrid):
    """Per-panel staggered geometry from the extended node set: for u-points
    (x-face, y-center) and v-points, padded-layout position arrays and unit
    FACE-NORMAL direction vectors (the transport-velocity convention of
    C-grid dycores: u is the component perpendicular to its face, so the
    discrete mass flux u·h̄·Δy is the true normal transport — projecting
    onto center-difference directions instead leaves an O(θ) mass-flux
    error at the slightly non-orthogonal vertex faces, measured ~1.5° max).
    Normals are oriented along increasing index (sign fixed by the
    center-difference direction). Returns (Pu, exu, Pv, eyv), lists over
    panels with shapes (NP, NP, 3) in the padded layout (face slot i = node
    i-H; entries outside the valid staggered range are edge-padded)."""
    H = csgrid.H[0]
    N = csgrid.N[0]
    NP = N + 2 * H
    out = ([], [], [], [])
    for ext in csgrid.extended_nodes:
        Pxm = _unit(ext[:-1] + ext[1:])          # x-edge midpoints (E, E+1)
        Pym = _unit(ext[:, :-1] + ext[:, 1:])    # y-edge midpoints (E+1, E)
        Pc = _unit(Pxm[:, :-1] + Pxm[:, 1:])     # cell centers (E, E)
        # u-points: rows = faces (node lines), cols = centers
        Pu = Pym[:, :]                            # (E+1, E)
        tang = ext[:, 1:] - ext[:, :-1]           # face tangents (E+1, E)
        exu = np.cross(tang, Pu)                  # in-plane face normal
        exu = _unit(exu)
        cd = np.zeros_like(Pu)                    # orientation reference
        cd[1:-1] = Pc[1:] - Pc[:-1]
        cd[0], cd[-1] = cd[1], cd[-2]
        exu *= np.sign(np.sum(exu * cd, -1, keepdims=True))
        # v-points: rows = centers, cols = faces
        Pv = Pxm[:, :]                            # (E, E+1)
        tang = ext[1:, :] - ext[:-1, :]           # (E, E+1)
        eyv = np.cross(tang, Pv)
        eyv = _unit(eyv)
        cd = np.zeros_like(Pv)
        cd[:, 1:-1] = Pc[:, 1:] - Pc[:, :-1]
        cd[:, 0], cd[:, -1] = cd[:, 1], cd[:, -2]
        eyv *= np.sign(np.sum(eyv * cd, -1, keepdims=True))
        out[0].append(Pu[:NP, :NP])
        out[1].append(exu[:NP, :NP])
        out[2].append(Pv[:NP, :NP])
        out[3].append(eyv[:NP, :NP])
    return out


def _vertex_corner_info(grid):
    """The 8 cube vertices as groups of 3 (panel, corner-ffc-index) members,
    each with the spherical area of the dual triangle through the 3 adjacent
    cell centers. At a valence-3 vertex the standard 4-term circulation
    vorticity is invalid (it references the degenerate diagonal cell); the
    true vertex vorticity is assembled from the members' partial
    circulations — each panel sees 2 of the 3 dual edges, so the 3 partials
    sum to exactly twice the triangle circulation."""
    H, N = grid.H[0], grid.N[0]
    corners = [(H, H), (H, H + N), (H + N, H), (H + N, H + N)]
    groups = {}
    for p in range(6):
        ext = grid.extended_nodes[p]
        for (i0, j0) in corners:
            key = tuple(np.round(ext[i0, j0], 9))
            groups.setdefault(key, []).append((p, i0, j0))
    from ..grids.orthogonal_spherical_shell import _spherical_triangle_excess
    info = []
    for members in groups.values():
        assert len(members) == 3, members
        cs = []
        for (p, i0, j0) in members:
            ext = grid.extended_nodes[p]
            ci = i0 if i0 == H else i0 - 1
            cj = j0 if j0 == H else j0 - 1
            quad = (ext[ci, cj] + ext[ci + 1, cj]
                    + ext[ci, cj + 1] + ext[ci + 1, cj + 1])
            cs.append(quad / np.linalg.norm(quad))
        Av = float(_spherical_triangle_excess(*cs)) * grid.radius ** 2
        info.append((members, Av))
    return info


class CubedSphereShallowWaterModel:
    """Rotating shallow water on a :class:`ConformalCubedSphereGrid`.

    state: ``h`` (fluid thickness, centers), ``u``/``v`` (staggered local
    components), all (6, NP, NP, 1). ``rotation_rate``: planetary Ω about
    ẑ (f = 2Ω sinφ evaluated exactly at the ffc nodes)."""

    def __init__(self, grid: ConformalCubedSphereGrid, gravity=None,
                 rotation_rate=0.0, pv_scheme="energy_conserving",
                 reference_datetime=None):
        if pv_scheme not in ("energy_conserving", "enstrophy_conserving"):
            raise ValueError(pv_scheme)
        self.pv_scheme = pv_scheme
        self.reference_datetime = reference_datetime
        self.grid = grid
        self.gravity = float(gravity if gravity is not None
                             else defaults.gravitational_acceleration)
        self.rotation_rate = float(rotation_rate)
        H, N = grid.H[0], grid.N[0]
        NP = N + 2 * H
        dtype = grid.dtype
        # Coriolis at ffc nodes from the extended node set (halos exact)
        f = np.stack([2.0 * self.rotation_rate * ext[:NP, :NP, 2]
                      for ext in grid.extended_nodes])[..., None]
        self._f = jnp.asarray(f, dtype)
        shape = (6, NP, NP, 1)
        self.state = {"h": jnp.zeros(shape, dtype),
                      "u": jnp.zeros(shape, dtype),
                      "v": jnp.zeros(shape, dtype),
                      "time": jnp.zeros((), dtype),
                      "iteration": jnp.zeros((), jnp.int32)}
        self._geom = staggered_points_and_bases(grid)
        self._corner_info = _vertex_corner_info(grid)
        self._step = jax.jit(self._make_step())

    # -- initialization -------------------------------------------------------

    def set_geographic(self, h=None, u_east=None, v_north=None):
        """Initialize from functions of geographic (lon_rad, lat_rad):
        ``h(lon, lat)`` thickness; ``u_east``/``v_north`` zonal/meridional
        velocity — projected onto each panel's local staggered directions."""
        grid = self.grid
        H, N = grid.H[0], grid.N[0]
        dtype = grid.dtype
        Pu, exu, Pv, eyv = self._geom

        def lonlat(P):
            return (np.arctan2(P[..., 1], P[..., 0]),
                    np.arcsin(np.clip(P[..., 2], -1, 1)))

        def east_north(P):
            zhat = np.array([0.0, 0.0, 1.0])
            e = np.cross(zhat, P)
            n = np.linalg.norm(e, axis=-1, keepdims=True)
            e = e / np.maximum(n, 1e-30)
            return e, np.cross(P, e)

        hs, us, vs = [], [], []
        for p in range(6):
            ext = grid.extended_nodes[p]
            NPp = N + 2 * H
            Pc = _unit(_unit(ext[:-1] + ext[1:])[:, :-1]
                       + _unit(ext[:-1] + ext[1:])[:, 1:])[:NPp, :NPp]
            if h is not None:
                lam, phi = lonlat(Pc)
                hs.append(h(lam, phi))
            eu, nu = east_north(Pu[p])
            ev, nv = east_north(Pv[p])
            lamu, phiu = lonlat(Pu[p])
            lamv, phiv = lonlat(Pv[p])
            ue = u_east(lamu, phiu) if u_east is not None else 0.0
            vn = v_north(lamu, phiu) if v_north is not None else 0.0
            V = np.asarray(ue)[..., None] * eu \
                + np.asarray(vn)[..., None] * nu \
                if u_east is not None or v_north is not None else None
            if V is not None:
                us.append(np.sum(V * exu[p], -1))
            ue = u_east(lamv, phiv) if u_east is not None else 0.0
            vn = v_north(lamv, phiv) if v_north is not None else 0.0
            Vv = np.asarray(ue)[..., None] * ev \
                + np.asarray(vn)[..., None] * nv \
                if u_east is not None or v_north is not None else None
            if Vv is not None:
                vs.append(np.sum(Vv * eyv[p], -1))
        st = dict(self.state)
        if hs:
            st["h"] = jnp.asarray(np.stack(hs), dtype)[..., None]
        if us:
            st["u"] = jnp.asarray(np.stack(us), dtype)[..., None]
            st["v"] = jnp.asarray(np.stack(vs), dtype)[..., None]
        self.state = st

    # -- dynamics -------------------------------------------------------------

    def _vertex_zeta(self, zetas, hffs, h, u, v):
        """Overwrite the 24 panel-corner ffc slots: vorticity from the
        3-cell dual-triangle circulation (see :func:`_vertex_corner_info`),
        thickness from the mean of the 3 real adjacent cells."""
        grid = self.grid
        H = grid.H[0]
        for members, Av in self._corner_info:
            tot = 0.0
            for (p, i0, j0) in members:
                g = grid.panel_grids[p]
                dycf = np.asarray(g.dy(LOC_CFC))
                dxfc = np.asarray(g.dx(LOC_FCC))
                t1 = (dycf[i0, j0, 0] * v[p, i0, j0] if i0 == H
                      else -dycf[i0 - 1, j0, 0] * v[p, i0 - 1, j0])
                t2 = (-dxfc[i0, j0, 0] * u[p, i0, j0] if j0 == H
                      else dxfc[i0, j0 - 1, 0] * u[p, i0, j0 - 1])
                tot = tot + t1 + t2
            zv = tot / (2.0 * Av)
            for (p, i0, j0) in members:
                ci = i0 if i0 == H else i0 - 1
                cj = j0 if j0 == H else j0 - 1
                oi = i0 - 1 if i0 == H else i0
                oj = j0 - 1 if j0 == H else j0
                hv = (h[p, ci, cj] + h[p, oi, cj] + h[p, ci, oj]) / 3.0
                zetas[p] = zetas[p].at[i0, j0].set(zv)
                hffs[p] = hffs[p].at[i0, j0].set(hv)
        return zetas, hffs

    def _tendencies(self, h, u, v):
        grid = self.grid
        gy = self.gravity
        zetas, hffs = [], []
        for p in range(6):
            g = grid.panel_grids[p]
            zetas.append(zeta3_ffc(g, u[p], v[p]))
            hffs.append(iy_f(g, ix_f(g, h[p])))
        zetas, hffs = self._vertex_zeta(zetas, hffs, h, u, v)
        Gh, Gu, Gv = [], [], []
        for p in range(6):
            g = grid.panel_grids[p]
            hp, up, vp, fp = h[p], u[p], v[p], self._f[p]
            dy_fcc, dx_cfc = g.dy(LOC_FCC), g.dx(LOC_CFC)
            hx, hy = ix_f(g, hp), iy_f(g, hp)
            Uf = dy_fcc * hx * up                 # x mass flux (fcc)
            Vf = dx_cfc * hy * vp                 # y mass flux (cfc)
            Gh.append(-(dx_c(g, Uf) + dy_c(g, Vf)) / g.Az(LOC_CCC))
            zeta = zetas[p]
            q = (zeta + fp) / hffs[p]
            if self.pv_scheme == "energy_conserving":
                # Sadourny energy-conserving PV flux (same discrete form as
                # advection/vector_invariant.py's ENERGY branch,
                # thickness-weighted)
                cor_u = +iy_c(g, q * ix_f(g, Vf)) / g.dx(LOC_FCC)
                cor_v = -ix_c(g, q * iy_f(g, Uf)) / g.dy(LOC_CFC)
            else:
                # Sadourny enstrophy-conserving form: q̄ times the
                # twice-interpolated transport (vector_invariant.py's
                # ENSTROPHY branch)
                cor_u = +iy_c(g, q) * iy_c(g, ix_f(g, Vf)) / g.dx(LOC_FCC)
                cor_v = -ix_c(g, q) * ix_c(g, iy_f(g, Uf)) / g.dy(LOC_CFC)
            K = 0.5 * (ix_c(g, up * up) + iy_c(g, vp * vp))
            B = gy * hp + K
            Gu.append(cor_u - ddx(g, B, LOC_FCC))
            Gv.append(cor_v - ddy(g, B, LOC_CFC))
        return jnp.stack(Gh), jnp.stack(Gu), jnp.stack(Gv)

    def _make_step(self):
        grid = self.grid

        def filled(h, u, v):
            h = fill_cubed_sphere_halos(h, grid)
            u, v = sync_shared_velocity_faces(u, v, grid)
            u, v = fill_cubed_sphere_velocity_halos(u, v, grid)
            return h, u, v

        def step(state, dt):
            h0, u0, v0 = state["h"], state["u"], state["v"]
            h, u, v = h0, u0, v0
            for frac in (1.0 / 3.0, 0.5, 1.0):   # Wicker-Skamarock RK3
                hf, uf, vf = filled(h, u, v)
                Gh, Gu, Gv = self._tendencies(hf, uf, vf)
                h = h0 + frac * dt * Gh
                u = u0 + frac * dt * Gu
                v = v0 + frac * dt * Gv
            h, u, v = filled(h, u, v)
            return {"h": h, "u": u, "v": v,
                    "time": state["time"] + dt,
                    "iteration": state["iteration"] + 1}

        return step

    def time_step(self, dt):
        self.state = self._step(self.state, jnp.asarray(dt,
                                                        self.grid.dtype))

    @property
    def time(self):
        return float(self.state["time"])

    @property
    def datetime(self):
        """Calendar time = reference_datetime + model seconds (reference:
        clock.jl DateTime clocks); None without a reference_datetime."""
        from ..utils.dateclock import datetime_of
        return datetime_of(self.time, self.reference_datetime)

    @property
    def iteration(self):
        return int(self.state["iteration"])

    def field(self, name):
        """Writer/diagnostic accessor: a view with ``.interior`` =
        (6, N, N, Nz) panel interiors (fetch_output protocol — lets the
        Simulation layer, FieldWriter, and NaNChecker drive cubed-sphere
        models like the rectilinear ones)."""
        return _PanelFieldView(self.grid.interior(self.state[name]))

    def total_mass(self):
        grid = self.grid
        H, N = grid.H[0], grid.N[0]
        tot = 0.0
        for p in range(6):
            Azp = np.asarray(grid.panel_grids[p].Az(LOC_CCC))
            hp = np.asarray(self.state["h"][p])
            tot += float((hp[H:H + N, H:H + N]
                          * Azp[H:H + N, H:H + N]).sum())
        return tot


class _PanelFieldView:
    def __init__(self, interior):
        self.interior = interior
