"""LatitudeLongitudeGrid: spherical-shell grid with exact spherical metrics.

Reference semantics: src/Grids/latitude_longitude_grid.jl (struct :4, ctor
:197) and the lat-lon metric section of
src/Operators/spacings_and_areas_and_volumes.jl:

    Δx(λ-loc, φ-loc) = R cos(φ) Δλ          (depends on latitude!)
    Δy               = R Δφ
    Az               = R² Δλ (sin φ⁺ - sin φ⁻)   (exact cell area)

Longitude λ and latitude φ are in degrees, z in meters. The reference offers
precomputed or on-the-fly metrics; here the metrics are numpy constants
baked into the compiled program (1D/2D broadcastable arrays — tiny next to
the device-resident state)."""

from __future__ import annotations

import numpy as np

from ..defaults import defaults
from . import topology as topo
from .base import AbstractGrid
from .rectilinear import _Coordinate

DEG = np.pi / 180.0


class LatitudeLongitudeGrid(AbstractGrid):
    def __init__(self, size=None, longitude=None, latitude=None, z=None,
                 radius=None, topology=None, halo=None, dtype=None):
        self.radius = float(radius if radius is not None
                            else defaults.planet_radius)
        self.dtype = dtype if dtype is not None else defaults.FloatType

        if topology is None:
            # default: bounded latitude, periodic longitude iff it spans 360°
            lon_span = None
            if isinstance(longitude, tuple):
                lon_span = longitude[1] - longitude[0]
            tx = topo.PERIODIC if (lon_span is not None
                                   and np.isclose(lon_span, 360)) \
                else topo.BOUNDED
            tz = topo.BOUNDED if z is not None else topo.FLAT
            topology = (tx, topo.BOUNDED, tz)
        self.topology = topo.validate_topology(topology)

        nonflat = [i for i in range(3) if self.topology[i] != topo.FLAT]
        size = tuple(int(s) for s in (size if not np.isscalar(size) else (size,)))
        if len(size) == len(nonflat) and len(size) != 3:
            N = [1, 1, 1]
            for i, s in zip(nonflat, size):
                N[i] = s
        else:
            N = list(size)
        self.N = tuple(N)

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

        def build(axis, spec):
            if self.topology[axis] == topo.FLAT:
                return _Coordinate(1, 0, topo.FLAT)
            if (isinstance(spec, tuple) and len(spec) == 2
                    and np.isscalar(spec[0])):
                return _Coordinate(self.N[axis], self.H[axis],
                                   self.topology[axis], interval=spec)
            return _Coordinate(self.N[axis], self.H[axis],
                               self.topology[axis], faces=spec)

        self._lam = build(0, longitude)   # degrees
        self._phi = build(1, latitude)    # degrees
        self._zc = build(2, z)
        self._coords = [self._lam, self._phi, self._zc]

        # INTERIOR latitudes outside ±90° are user error (halo rows may
        # extend past the poles legitimately — their cosines are clamped
        # in the metric methods); the old no-op check here promised a
        # clamp it never performed (round-5 review)
        phi_f = np.asarray(self._phi.coord(topo.FACE))
        H1, N1 = self.H[1], self.N[1]
        if np.any(np.abs(phi_f[H1:H1 + N1 + 1]) > 90 + 1e-9):
            raise ValueError("latitude extent exceeds ±90°")

        # pole-touching grids get polar boundary conditions (reference:
        # polar_boundary_condition.jl): the halo value is the recomputed
        # zonal mean of the boundary row
        self.polar_south = self.polar_north = False
        if self.topology[1] == topo.BOUNDED:
            H1, N1 = self.H[1], self.N[1]
            phi_f = self._phi.coord(topo.FACE)
            self.polar_south = bool(np.isclose(phi_f[H1], -90.0))
            self.polar_north = bool(np.isclose(phi_f[H1 + N1], 90.0))

    # -- coordinate access (degrees for λ/φ) ---------------------------------

    def coord_padded(self, axis, loc):
        return self._coords[axis].coord(loc)

    def nodes1d(self, axis, loc):
        c = self._coords[axis]
        n, h = self.N[axis], self.H[axis]
        if loc == topo.FACE and self.topology[axis] == topo.BOUNDED:
            return c.xF[h:h + n + 1]
        return c.coord(loc)[h:h + n]

    def xnodes(self, loc="c"):
        return self.nodes1d(0, loc)

    def lambda_nodes(self, loc="c"):
        """Longitude nodes in degrees (reference: λnodes)."""
        return self.xnodes(loc)

    def phi_nodes(self, loc="c"):
        """Latitude nodes in degrees (reference: φnodes)."""
        return self.ynodes(loc)

    def lambda_spacings(self, loc="c"):
        """Angular longitude spacings in degrees (reference: λspacings,
        src/Grids/nodes_and_spacings.jl)."""
        return self._lam.spacing(loc)

    def phi_spacings(self, loc="c"):
        """Angular latitude spacings in degrees (reference: φspacings)."""
        return self._phi.spacing(loc)

    def ynodes(self, loc="c"):
        return self.nodes1d(1, loc)

    def znodes(self, loc="c"):
        return self.nodes1d(2, loc)

    def nodes(self, loc=topo.LOC_CCC):
        return tuple(self.nodes1d(i, loc[i]) for i in range(3))

    @property
    def extent(self):
        return tuple(c.extent for c in self._coords)

    def regular(self, axis):
        return self._coords[axis].regular

    @property
    def all_regular(self):
        return False  # metrics vary with latitude: no FFT in y

    @property
    def stretched_axes(self):
        return tuple(i for i in range(3)
                     if not self._coords[i].regular and not self.is_flat(i))

    # -- metrics --------------------------------------------------------------

    def _cosphi(self, yloc):
        phi = self._phi.coord(yloc)
        cos = np.cos(np.clip(phi, -90.0, 90.0) * DEG)
        return np.maximum(cos, 1e-12).reshape(1, -1, 1)

    def _dlam_rad(self, xloc):
        s = self._lam.spacing(xloc)
        if np.isscalar(s):
            return s * DEG
        return (s * DEG).reshape(-1, 1, 1)

    def _dphi_rad(self, yloc):
        s = self._phi.spacing(yloc)
        if np.isscalar(s):
            return s * DEG
        return (s * DEG).reshape(1, -1, 1)

    def dx(self, loc):
        """R cos(φ) Δλ — varies with latitude (reference: Δxᶠᶜᵃ etc. for
        lat-lon grids)."""
        return self.radius * self._cosphi(loc[1]) * self._dlam_rad(loc[0])

    def dy(self, loc):
        return self.radius * self._dphi_rad(loc[1])

    def dz(self, loc):
        s = self._zc.spacing(loc[2])
        if np.isscalar(s):
            return s
        return s.reshape(1, 1, -1)

    def Az(self, loc):
        """Exact spherical cell area R² Δλ (sin φ⁺ - sin φ⁻) (reference:
        Azᶜᶜᵃ for lat-lon grids)."""
        yloc = loc[1]
        npad = self.N[1] + 2 * self.H[1]
        if yloc == topo.CENTER:
            # cell j band: [φF[j], φF[j+1]]
            phi_minus = self._phi.xF[:npad]
            phi_plus = self._phi.xF[1:npad + 1]
        else:
            # face j band: [φC[j-1], φC[j]]
            xC = self._phi.xC
            phi_minus = np.empty(npad)
            phi_minus[1:] = xC[:npad - 1]
            phi_minus[0] = xC[0] - (xC[1] - xC[0])
            phi_plus = xC[:npad]
        sin_d = np.sin(np.clip(phi_plus, -90, 90) * DEG) \
            - np.sin(np.clip(phi_minus, -90, 90) * DEG)
        sin_d = np.maximum(sin_d, 1e-15)
        return (self.radius ** 2 * np.asarray(self._dlam_rad(loc[0]))
                * sin_d.reshape(1, -1, 1))

    def V(self, loc):
        """Exact volume: Az · Δz (base-class Ax/Ay products are correct
        as-is)."""
        return self.Az(loc) * np.asarray(self.dz(loc))

    def minimum_spacing(self, axis):
        if self.is_flat(axis):
            return np.inf
        if axis == 0:
            h, n = self.H[1], self.N[1]
            return float(np.min(np.asarray(self.dx(("c", "c", "c")))
                                [:, h:h + n, :]))
        metric = (self.dy, self.dz)[axis - 1](("c", "c", "c"))
        if np.isscalar(metric):
            return float(metric)
        h, n = self.H[axis], self.N[axis]
        return float(np.min(np.asarray(metric).reshape(-1)[h:h + n]))

    def with_halo(self, halo):
        if tuple(halo) == self.H:
            return self

        def spec(c, i):
            if c.topology == topo.FLAT:
                return None
            if c.regular:
                return (c.origin, c.origin + c.extent)
            h = self.H[i]
            return c.xF[h:h + self.N[i] + 1].copy()

        return LatitudeLongitudeGrid(
            size=self.N, longitude=spec(self._lam, 0),
            latitude=spec(self._phi, 1), z=spec(self._zc, 2),
            radius=self.radius, topology=self.topology, halo=halo,
            dtype=self.dtype)

    def _fingerprint(self):
        return ("LatitudeLongitudeGrid", self.N, self.H, self.topology,
                self.radius, np.dtype(self.dtype).name,
                tuple(c._fp for c in self._coords))

    def __repr__(self):
        return (f"LatitudeLongitudeGrid(size={self.N}, "
                f"longitude≈{self.xnodes()[0]:.1f}…, "
                f"latitude≈{self.ynodes()[0]:.1f}…)")
