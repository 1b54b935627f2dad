"""OrthogonalSphericalShellGrid: general curvilinear horizontal grid on the
sphere with 2D metric arrays, plus the RotatedLatitudeLongitudeGrid generator.

Reference semantics: src/Grids/orthogonal_spherical_shell_grid.jl (struct :15,
ctor :368 — 2D coordinate and metric arrays at all four horizontal
staggerings) and src/OrthogonalSphericalShellGrids/rotated_latitude_longitude_
grid.jl (a lat-lon grid rotated so its coordinate pole sits at an arbitrary
geographic location — the building block for tripolar/cubed-sphere panels).

Construction: from 2D arrays of CORNER (ffc-point) longitude/latitude in
degrees, shape (Nx+1, Ny+1), plus a vertical spec. All metrics are derived
from great-circle distances between adjacent corner/edge midpoints, padded
into halos by edge replication. The stencil operator layer consumes them as
(npx, npy, 1) broadcastable arrays — no operator changes needed."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..defaults import defaults
from . import topology as topo
from .base import AbstractGrid
from .rectilinear import _Coordinate

DEG = np.pi / 180.0


def _sph2cart(lam, phi):
    lam, phi = np.asarray(lam) * DEG, np.asarray(phi) * DEG
    return np.stack([np.cos(phi) * np.cos(lam), np.cos(phi) * np.sin(lam),
                     np.sin(phi)], axis=-1)


def _cart2sph(xyz):
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    return np.rad2deg(np.arctan2(y, x)), np.rad2deg(
        np.arcsin(np.clip(z, -1, 1)))


def _gc_distance(p1, p2, radius):
    """Great-circle distance between unit vectors p1, p2."""
    dots = np.clip(np.sum(p1 * p2, axis=-1), -1.0, 1.0)
    return radius * np.arccos(dots)


def _midpoint(p1, p2):
    m = p1 + p2
    return m / np.linalg.norm(m, axis=-1, keepdims=True)


def _spherical_triangle_excess(a, b, c):
    """Solid angle of the triangle of unit vectors (a, b, c):
    E = 2 atan2(|a·(b×c)|, 1 + a·b + b·c + c·a)."""
    num = np.abs(np.einsum("...i,...i->...", a, np.cross(b, c)))
    den = (1.0 + np.einsum("...i,...i->...", a, b)
           + np.einsum("...i,...i->...", b, c)
           + np.einsum("...i,...i->...", c, a))
    return 2.0 * np.arctan2(num, den)


def _spherical_quad_area(p00, p10, p11, p01):
    """Unit-sphere area of the quad (two triangle excesses)."""
    return (_spherical_triangle_excess(p00, p10, p11)
            + _spherical_triangle_excess(p00, p11, p01))


class OrthogonalSphericalShellGrid(AbstractGrid):
    def __init__(self, corner_longitude, corner_latitude, z=None, size=None,
                 radius=None, topology=None, halo=None, dtype=None,
                 corner_halo=0):
        """``corner_halo=h`` marks the corner arrays as EXTENDED: they cover
        the full padded horizontal extent (interior nodes plus ``h`` halo
        node rows per side taken from the true surrounding mesh, e.g.
        neighboring cubed-sphere panels). All metrics — lengths AND areas, at
        every staggering — are then exact in the halos instead of
        edge-replicated (the analogue of the reference's inter-panel metric
        halo fill in src/MultiRegion/cubed_sphere_grid.jl)."""
        self.radius = float(radius if radius is not None
                            else defaults.planet_radius)
        self.dtype = dtype if dtype is not None else defaults.FloatType
        lamF = np.asarray(corner_longitude, float)
        phiF = np.asarray(corner_latitude, float)
        ch = int(corner_halo)
        self._corner_halo = ch
        nxp1, nyp1 = lamF.shape
        Nx, Ny = nxp1 - 1 - 2 * ch, nyp1 - 1 - 2 * ch
        Nz = 1 if z is None else (size[2] if size else None)
        if z is not None and Nz is None:
            raise ValueError("pass size=(Nx, Ny, Nz) with a vertical spec")

        if topology is None:
            topology = (topo.BOUNDED, topo.BOUNDED,
                        topo.BOUNDED if z is not None else topo.FLAT)
        self.topology = topo.validate_topology(topology)
        self.N = (Nx, Ny, Nz if z is not None else 1)
        if halo is None:
            halo = tuple(3 if self.topology[i] != topo.FLAT else 0
                         for i in range(3))
        elif np.isscalar(halo):
            halo = tuple(int(halo) if self.topology[i] != topo.FLAT else 0
                         for i in range(3))
        else:
            halo = tuple(halo)
            if len(halo) != 3:
                # expand a per-nonflat-direction tuple to 3 entries (the
                # RectilinearGrid convention; a 2-tuple here used to leave
                # self.H length-2 and crash padded_shape — round-5 review)
                nonflat = [i for i in range(3)
                           if self.topology[i] != topo.FLAT]
                if len(halo) != len(nonflat):
                    raise ValueError(
                        f"halo must have 3 or {len(nonflat)} entries")
                full = [0, 0, 0]
                for i, h in zip(nonflat, halo):
                    full[i] = int(h)
                halo = tuple(full)
        self.H = tuple(halo)
        if ch and (self.H[0] != ch or self.H[1] != ch):
            raise ValueError("corner_halo must equal the horizontal halos")

        if z is not None:
            if (isinstance(z, tuple) and len(z) == 2 and np.isscalar(z[0])):
                self._zc = _Coordinate(self.N[2], self.H[2], self.topology[2],
                                       interval=z)
            else:
                self._zc = _Coordinate(self.N[2], self.H[2], self.topology[2],
                                       faces=z)
        else:
            self._zc = _Coordinate(1, 0, topo.FLAT)

        # corner unit vectors
        P = _sph2cart(lamF, phiF)                       # (Nx+1, Ny+1, 3)
        # edge midpoints and cell centers (on the sphere)
        Pxm = _midpoint(P[:-1, :], P[1:, :])            # x-edge midpoints (Nx, Ny+1)
        Pym = _midpoint(P[:, :-1], P[:, 1:])            # y-edge midpoints (Nx+1, Ny)
        Pc = _midpoint(Pxm[:, :-1], Pxm[:, 1:])         # centers (Nx, Ny)

        R = self.radius
        # metric arrays at the four horizontal staggerings over the full
        # corner-array extent (= interior, or padded extent if corner_halo)
        mx, my = nxp1 - 1, nyp1 - 1
        dx_cc = _gc_distance(Pym[:-1, :], Pym[1:, :], R)   # (mx, my) Δx at (c,c)
        dx_fc = np.empty((mx + 1, my))
        dx_fc[1:-1] = _gc_distance(Pc[:-1, :], Pc[1:, :], R)
        dx_fc[0] = dx_fc[1]
        dx_fc[-1] = dx_fc[-2]
        dx_cf = _gc_distance(P[:-1, :], P[1:, :], R)       # corner rows: Δx at (c,f) (mx, my+1)
        dx_ff = np.empty((mx + 1, my + 1))
        dx_ff[1:-1] = _gc_distance(Pxm[:-1, :], Pxm[1:, :], R)
        dx_ff[0] = dx_ff[1]
        dx_ff[-1] = dx_ff[-2]

        dy_cc = _gc_distance(Pxm[:, :-1], Pxm[:, 1:], R)
        dy_cf = np.empty((mx, my + 1))
        dy_cf[:, 1:-1] = _gc_distance(Pc[:, :-1], Pc[:, 1:], R)
        dy_cf[:, 0] = dy_cf[:, 1]
        dy_cf[:, -1] = dy_cf[:, -2]
        dy_fc = _gc_distance(P[:, :-1], P[:, 1:], R)
        dy_ff = np.empty((mx + 1, my + 1))
        dy_ff[:, 1:-1] = _gc_distance(Pym[:, :-1], Pym[:, 1:], R)
        dy_ff[:, 0] = dy_ff[:, 1]
        dy_ff[:, -1] = dy_ff[:, -2]

        self._dx = {("c", "c"): dx_cc, ("f", "c"): dx_fc,
                    ("c", "f"): dx_cf[:, :], ("f", "f"): dx_ff}
        self._dy = {("c", "c"): dy_cc, ("f", "c"): dy_fc[:, :],
                    ("c", "f"): dy_cf, ("f", "f"): dy_ff}

        lam_c, phi_c = _cart2sph(Pc)
        if ch:
            # coordinate tables stay INTERIOR-extent for API parity
            self._lam = {("c", "c"): lam_c[ch:ch + Nx, ch:ch + Ny],
                         ("f", "f"): lamF[ch:ch + Nx + 1, ch:ch + Ny + 1]}
            self._phi = {("c", "c"): phi_c[ch:ch + Nx, ch:ch + Ny],
                         ("f", "f"): phiF[ch:ch + Nx + 1, ch:ch + Ny + 1]}
            self._ext_corners = (lamF, phiF)
        else:
            self._lam = {("c", "c"): lam_c, ("f", "f"): lamF}
            self._phi = {("c", "c"): phi_c, ("f", "f"): phiF}
            self._ext_corners = None

        # z-normal areas from the SPHERICAL QUADRILATERAL excess — exact for
        # any (even non-orthogonal) quad mesh on the sphere, unlike the
        # Δx·Δy product which carries a sin(θ) bias on skewed panels
        # (reference: the spherical_area_quadrilateral computation of
        # orthogonal_spherical_shell_grid.jl)
        az_cc = _spherical_quad_area(P[:-1, :-1], P[1:, :-1],
                                     P[1:, 1:], P[:-1, 1:]) * R * R
        az_fc = np.empty((mx + 1, my))
        az_fc[1:-1] = 0.5 * (az_cc[:-1] + az_cc[1:])
        az_fc[0], az_fc[-1] = az_cc[0], az_cc[-1]
        az_cf = np.empty((mx, my + 1))
        az_cf[:, 1:-1] = 0.5 * (az_cc[:, :-1] + az_cc[:, 1:])
        az_cf[:, 0], az_cf[:, -1] = az_cc[:, 0], az_cc[:, -1]
        az_ff = np.empty((mx + 1, my + 1))
        az_ff[1:-1, :] = 0.5 * (az_cf[:-1, :] + az_cf[1:, :])
        az_ff[0, :], az_ff[-1, :] = az_cf[0, :], az_cf[-1, :]
        if ch:
            # exchanged-halo panels: at a 3-valent cube vertex the diagonal
            # halo quads/edges are fold-over slivers with ~zero measure (the
            # fourth quadrant doesn't exist geometrically). Any field value
            # there is meaningless; clamp the degenerate metrics UP so
            # divisions produce ~0 instead of inf/NaN (0·inf) that would
            # poison whole-array halo arithmetic (the reference's
            # cubed-sphere corner fills sidestep these slots with
            # special-case kernels; dense whole-array ops cannot).
            for group in (self._dx, self._dy,
                          {("c", "c"): az_cc, ("f", "c"): az_fc,
                           ("c", "f"): az_cf, ("f", "f"): az_ff}):
                for tbl in group.values():
                    big = tbl.max()
                    np.copyto(tbl, big, where=tbl < 1e-6 * big)
        self._az = {("c", "c"): az_cc, ("f", "c"): az_fc,
                    ("c", "f"): az_cf, ("f", "f"): az_ff}

        self._pad_cache = {}

    # -- metric padding -------------------------------------------------------

    def _padded2d(self, table, lx, ly):
        key = (id(table), lx, ly)
        if key in self._pad_cache:
            return self._pad_cache[key]
        arr = table[(lx, ly)]
        if self._corner_halo:
            # extended arrays already span the padded extent; crop the "+1"
            # staggered rows to the uniform padded layout
            npx = self.N[0] + 2 * self.H[0]
            npy = self.N[1] + 2 * self.H[1]
            out = arr[:npx, :npy, None]
        else:
            # crop the "+1" staggered rows to N entries (uniform padded layout)
            arr = arr[:self.N[0], :self.N[1]]
            mode_x = "wrap" if self.topology[0] == topo.PERIODIC else "edge"
            mode_y = "wrap" if self.topology[1] == topo.PERIODIC else "edge"
            out = np.pad(arr, [(self.H[0],) * 2, (0, 0)], mode=mode_x)
            out = np.pad(out, [(0, 0), (self.H[1],) * 2], mode=mode_y)
            out = out[..., None]
        self._pad_cache[key] = out
        return out

    def dx(self, loc):
        return self._padded2d(self._dx, loc[0], loc[1])

    def dy(self, loc):
        return self._padded2d(self._dy, loc[0], loc[1])

    def dz(self, loc):
        s = self._zc.spacing(loc[2])
        return s if np.isscalar(s) else s.reshape(1, 1, -1)

    def Az(self, loc):
        return self._padded2d(self._az, loc[0], loc[1])

    def V(self, loc):
        from .base import _mul
        return _mul(self.Az(loc), self.dz(loc))

    # -- nodes ----------------------------------------------------------------

    def coord_padded(self, axis, loc):
        if axis == 2:
            return self._zc.coord(loc)
        # horizontal coordinates are 2D; return the center-line for API parity
        table = self._lam if axis == 0 else self._phi
        key = ("c", "c") if loc == "c" else ("f", "f")
        arr = table.get(key, table[("c", "c")])
        line = arr[:, arr.shape[1] // 2] if axis == 0 \
            else arr[arr.shape[0] // 2, :]
        n = self.N[axis]
        h = self.H[axis]
        line = line[:n]
        return np.pad(line, (h, h), mode="edge")

    def nodes2d(self, loc=("c", "c")):
        key = tuple(loc[:2])
        return self._lam.get(key, self._lam[("c", "c")]), \
            self._phi.get(key, self._phi[("c", "c")])

    def nodes2d_padded(self, loc=("c", "c")):
        """Padded-layout 2D (λ, φ) degree arrays (npx, npy) at any horizontal
        staggering, derived from the corner nodes (EXACT in the halos on
        exchanged-metric panels, i.e. corner_halo grids; edge-replicated
        otherwise). Used by 2D-aware Coriolis/BC evaluation on curvilinear
        grids (reference: the λ/φ node arrays of
        orthogonal_spherical_shell_grid.jl at all staggerings)."""
        key = ("nodes2d_padded",) + tuple(loc[:2])
        cached = self._pad_cache.get(key)
        if cached is not None:
            return cached
        npx = self.N[0] + 2 * self.H[0]
        npy = self.N[1] + 2 * self.H[1]
        if self._corner_halo:
            lamF, phiF = self._ext_corners
        else:
            lamF, phiF = self._lam[("f", "f")], self._phi[("f", "f")]
            pad = [(self.H[0],) * 2, (self.H[1],) * 2]
            lamF = np.pad(lamF, pad, mode="edge")
            phiF = np.pad(phiF, pad, mode="edge")
        P = _sph2cart(lamF, phiF)
        Pxm = _midpoint(P[:-1, :], P[1:, :])        # (E, E+1): (c, f)
        Pym = _midpoint(P[:, :-1], P[:, 1:])        # (E+1, E): (f, c)
        Pc = _midpoint(Pxm[:, :-1], Pxm[:, 1:])     # (E, E): (c, c)
        pts = {("f", "f"): P, ("f", "c"): Pym,
               ("c", "f"): Pxm, ("c", "c"): Pc}[tuple(loc[:2])]
        lam, phi = _cart2sph(pts[:npx, :npy])
        out = (lam, phi)
        self._pad_cache[key] = out
        return out

    def znodes(self, loc="c"):
        c = self._zc
        n, h = self.N[2], self.H[2]
        if loc == topo.FACE and self.topology[2] == topo.BOUNDED:
            return c.xF[h:h + n + 1]
        return c.coord(loc)[h:h + n]

    @property
    def extent(self):
        # (approximate) angular extents + exact z extent; models use extent[2]
        lamF = self._lam[("f", "f")]
        phiF = self._phi[("f", "f")]
        return (float(lamF.max() - lamF.min()),
                float(phiF.max() - phiF.min()),
                self._zc.extent)

    @property
    def all_regular(self):
        return False

    @property
    def stretched_axes(self):
        return tuple(ax for ax in range(3) if not self.is_flat(ax))

    def regular(self, axis):
        # horizontal axes are INDEX-regular: the curvilinear (ξ, η)
        # parameters advance uniformly per cell, so advection reconstruction
        # uses the uniform index-space coefficients (the reference evaluates
        # WENO stencils in index space on OrthogonalSphericalShellGrids —
        # stretched coefficients apply to stretched COORDINATES, i.e. z)
        if axis in (0, 1):
            return True
        return self._zc.regular

    def minimum_spacing(self, axis):
        if self.is_flat(axis):
            return np.inf
        if axis == 2:
            return float(np.min(np.asarray(self.dz(("c", "c", "c")))))
        m = (self.dx if axis == 0 else self.dy)(("c", "c", "c"))
        h0, h1 = self.H[0], self.H[1]
        return float(np.min(m[h0:h0 + self.N[0], h1:h1 + self.N[1], 0]))

    def with_halo(self, halo):
        if tuple(halo) == self.H:
            return self
        if self._corner_halo:
            raise ValueError("panels with exchanged (corner_halo) metrics "
                             "cannot re-halo in isolation; rebuild the "
                             "composed grid with halo=" + repr(halo))
        lamF = self._lam[("f", "f")]
        phiF = self._phi[("f", "f")]
        zspec = None
        if not self.is_flat(2):
            c = self._zc
            zspec = ((c.origin, c.origin + c.extent) if c.regular
                     else c.xF[self.H[2]:self.H[2] + self.N[2] + 1].copy())
        return OrthogonalSphericalShellGrid(
            lamF, phiF, z=zspec, size=self.N, radius=self.radius,
            topology=self.topology, halo=halo, dtype=self.dtype)

    def _fingerprint(self):
        lam, phi = (self._ext_corners if self._corner_halo
                    else (self._lam[("f", "f")], self._phi[("f", "f")]))
        return ("OSSG", self.N, self.H, self.topology, self.radius,
                self._corner_halo, lam.tobytes(), phi.tobytes(), self._zc._fp)

    def __repr__(self):
        return f"OrthogonalSphericalShellGrid(size={self.N})"


def RotatedLatitudeLongitudeGrid(size, longitude, latitude, z=None,
                                 north_pole=(0.0, 90.0), radius=None,
                                 topology=None, halo=None, dtype=None):
    """Lat-lon grid whose coordinate north pole is moved to ``north_pole``
    = (λp, φp) in geographic coordinates (reference:
    src/OrthogonalSphericalShellGrids/rotated_latitude_longitude_grid.jl)."""
    Nx, Ny = size[0], size[1]
    lam1 = np.linspace(longitude[0], longitude[1], Nx + 1)
    phi1 = np.linspace(latitude[0], latitude[1], Ny + 1)
    lam2, phi2 = np.meshgrid(lam1, phi1, indexing="ij")
    P = _sph2cart(lam2, phi2)
    # rotate the coordinate pole (0,0,1) to north_pole
    lp, pp = north_pole
    # Ry(90° - φp) then Rz(λp)
    a = (90.0 - pp) * DEG
    b = lp * DEG
    Ry = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                   [-np.sin(a), 0, np.cos(a)]])
    Rz = np.array([[np.cos(b), -np.sin(b), 0], [np.sin(b), np.cos(b), 0],
                   [0, 0, 1]])
    Pr = P @ (Rz @ Ry).T
    lamF, phiF = _cart2sph(Pr)
    return OrthogonalSphericalShellGrid(lamF, phiF, z=z, size=size,
                                        radius=radius, topology=topology,
                                        halo=halo, dtype=dtype)


def rotation_angle_ccc(grid):
    """(cos θ, sin θ) padded broadcastables of the angle between the grid's
    local x-direction and geographic EAST at cell centers (reference:
    src/Operators/vector_rotation_operators.jl — the basis rotation used to
    convert intrinsic (grid-aligned) vectors to extrinsic (east/north)
    components on curvilinear grids)."""
    lamF, phiF = grid._lam[("f", "f")], grid._phi[("f", "f")]
    P = _sph2cart(lamF, phiF)
    # cell-center position and local +x direction (mean of the two x-edges)
    Pc = _midpoint(_midpoint(P[:-1, :-1], P[:-1, 1:]),
                   _midpoint(P[1:, :-1], P[1:, 1:]))
    ex = (_midpoint(P[1:, :-1], P[1:, 1:]) - _midpoint(P[:-1, :-1], P[:-1, 1:]))
    # project onto the tangent plane and normalize
    ex = ex - np.sum(ex * Pc, axis=-1, keepdims=True) * Pc
    ex = ex / np.maximum(np.linalg.norm(ex, axis=-1, keepdims=True), 1e-30)
    zhat = np.array([0.0, 0.0, 1.0])
    east = np.cross(zhat, Pc)
    east = east / np.maximum(np.linalg.norm(east, axis=-1, keepdims=True),
                             1e-30)
    north = np.cross(Pc, east)
    cos = np.sum(ex * east, axis=-1)
    sin = np.sum(ex * north, axis=-1)
    # pad to the grid's full padded horizontal extent (any rows beyond
    # the halo land on the high side)
    ps = grid.padded_shape
    pad = [(grid.H[a], ps[a] - cos.shape[a] - grid.H[a]) for a in (0, 1)]
    cos = np.pad(cos, pad, mode="edge")[..., None]
    sin = np.pad(sin, pad, mode="edge")[..., None]
    return cos, sin


def rotate_to_geographic(grid, u_ccc, v_ccc):
    """(u_east, v_north) from intrinsic center-located velocity components
    (reference: intrinsic_vector/extrinsic_vector,
    vector_rotation_operators.jl)."""
    cos, sin = rotation_angle_ccc(grid)
    cos = jnp.asarray(cos, u_ccc.dtype)
    sin = jnp.asarray(sin, u_ccc.dtype)
    return cos * u_ccc - sin * v_ccc, sin * u_ccc + cos * v_ccc


def rotate_from_geographic(grid, ue_ccc, vn_ccc):
    """Inverse of :func:`rotate_to_geographic` (geographic → intrinsic)."""
    cos, sin = rotation_angle_ccc(grid)
    cos = jnp.asarray(cos, ue_ccc.dtype)
    sin = jnp.asarray(sin, ue_ccc.dtype)
    return cos * ue_ccc + sin * vn_ccc, -sin * ue_ccc + cos * vn_ccc
