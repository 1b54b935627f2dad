"""RectilinearGrid: Cartesian grid with per-direction regular or stretched
spacing.

Reference semantics: src/Grids/rectilinear_grid.jl (struct :3-25, constructor
:65-180) and src/Grids/grid_generation.jl (coordinate generation with halo
extrapolation). API differences are deliberate: the grid is a static hashable
object; coordinates/metrics are numpy (compile-time constants), and every field
shares one padded shape (see grids/base.py).

Construction mirrors the reference constructor:

    RectilinearGrid(size=(64, 64, 64), extent=(1.0, 2.0, 3.0))      # z in (-Lz, 0)
    RectilinearGrid(size=(64, 64), x=(0, 1), y=(0, 1),
                    topology=("periodic", "periodic", "flat"))
    RectilinearGrid(size=(8, 8, 8), x=(0,1), y=(0,1), z=np.array([...]))  # faces
    RectilinearGrid(size=(8, 8, 8), x=(0,1), y=(0,1), z=lambda k: ...)
"""

from __future__ import annotations

import numpy as np

from ..defaults import defaults
from . import topology as topo
from .base import AbstractGrid, broadcastable_1d

_AXES = ("x", "y", "z")


class _Coordinate:
    """One direction's discretization: either regular (scalar spacing) or
    stretched (face-position array). Holds *padded* coordinate/spacing arrays
    covering the halo region, with end spacings extrapolated uniformly into
    the halos (reference: src/Grids/grid_generation.jl)."""

    __slots__ = ("N", "H", "topology", "regular", "delta", "origin",
                 "xF", "xC", "dC", "dF", "_fp")

    def __init__(self, N, H, topology, interval=None, faces=None, dtype=np.float64):
        self.N = int(N)
        self.H = int(H)
        self.topology = topology

        if topology == topo.FLAT:
            self.regular = True
            self.delta = 1.0
            self.origin = 0.0
            self.xF = np.zeros(2)
            self.xC = np.full(1, 0.5)
            self.dC = np.ones(1)
            self.dF = np.ones(2)
            self._fp = (N, H, topology)
            return

        Npad = self.N + 2 * self.H

        if faces is None:
            a, b = float(interval[0]), float(interval[1])
            self.regular = True
            self.delta = (b - a) / self.N
            self.origin = a
            # Padded faces: indices -H .. N+H  (length Npad + 1)
            idx = np.arange(-self.H, self.N + self.H + 1, dtype=np.float64)
            xF = a + idx * self.delta
        else:
            self.regular = False
            self.delta = None
            if callable(faces):
                f = np.asarray([faces(k) for k in range(self.N + 1)], dtype=np.float64)
            else:
                f = np.asarray(faces, dtype=np.float64)
            if f.shape != (self.N + 1,):
                raise ValueError(
                    f"face array must have length N+1={self.N + 1}, got {f.shape}")
            if np.any(np.diff(f) <= 0):
                raise ValueError("face positions must be strictly increasing")
            self.origin = float(f[0])
            # Extrapolate into halos with uniform end spacing
            dl, dr = f[1] - f[0], f[-1] - f[-2]
            left = f[0] - dl * np.arange(self.H, 0, -1)
            right = f[-1] + dr * np.arange(1, self.H + 1)
            xF = np.concatenate([left, f, right])

        assert xF.shape == (Npad + 1,)
        self.xF = xF
        self.xC = 0.5 * (xF[:-1] + xF[1:])            # length Npad
        self.dC = np.diff(xF)                          # Δx at centers (cell widths)
        dF = np.empty(Npad + 1)
        dF[1:-1] = np.diff(self.xC)                    # Δx at faces (center-to-center)
        dF[0] = dF[1]
        dF[-1] = dF[-2]
        self.dF = dF

        if self.regular:
            self._fp = (self.N, self.H, topology, self.delta, self.origin)
        else:
            self._fp = (self.N, self.H, topology, xF.tobytes())

    def spacing(self, loc):
        """Spacing at location 'c' or 'f': scalar if regular, else padded 1D
        array (length Npad; face spacing is truncated to Npad entries so every
        metric broadcasts against the uniform padded shape — the N-th bounded
        face's spacing dF[Npad] is never consumed by interior stencils)."""
        if self.regular:
            return self.delta
        return self.dC if loc == topo.CENTER else self.dF[:-1]

    def coord(self, loc):
        """Padded coordinates at 'c' or 'f' (length Npad)."""
        return self.xC if loc == topo.CENTER else self.xF[:-1]

    @property
    def extent(self):
        if self.topology == topo.FLAT:
            return 0.0
        return float(self.xF[self.N + self.H] - self.xF[self.H])


class RectilinearGrid(AbstractGrid):
    def __init__(self, size=None, extent=None, x=None, y=None, z=None,
                 topology=None, halo=None, dtype=None):
        if topology is None:
            topology = (topo.PERIODIC, topo.PERIODIC, topo.BOUNDED)
        self.topology = topo.validate_topology(topology)
        self.dtype = dtype if dtype is not None else defaults.FloatType

        # -- normalize sizes against Flat dims (reference allows passing only
        #    non-flat sizes, e.g. size=(64, 64) with topology (P, P, Flat))
        nonflat = [i for i in range(3) if self.topology[i] != topo.FLAT]
        if size is None:
            raise ValueError("RectilinearGrid requires `size`")
        if np.isscalar(size):
            size = (size,)
        size = tuple(int(s) for s in size)
        if len(size) == 3:
            N = list(size)
            for i in range(3):
                if self.topology[i] == topo.FLAT and N[i] != 1:
                    raise ValueError(f"size must be 1 along flat dimension {i}")
        elif len(size) == len(nonflat):
            N = [1, 1, 1]
            for i, s in zip(nonflat, size):
                N[i] = s
        else:
            raise ValueError(f"size {size} incompatible with topology {self.topology}")

        # -- halos (auto-inflated later by models for high-order advection;
        #    reference default halo is 3 — rectilinear_grid.jl)
        if halo is None:
            halo = tuple(3 if self.topology[i] != topo.FLAT else 0 for i in range(3))
        elif np.isscalar(halo):
            halo = tuple(int(halo) if self.topology[i] != topo.FLAT else 0
                         for i in range(3))
        else:
            halo = tuple(halo)
            if len(halo) == len(nonflat) and len(nonflat) != 3:
                full = [0, 0, 0]
                for i, h in zip(nonflat, halo):
                    full[i] = h
                halo = tuple(full)
        self.N = tuple(N)
        self.H = tuple(int(h) for h in halo)

        # -- coordinate specs: extent=(…) covers non-flat dims, with the
        #    reference convention z ∈ (-Lz, 0), x,y ∈ (0, L)
        specs = {"x": x, "y": y, "z": z}
        if extent is not None:
            if any(v is not None for v in specs.values()):
                raise ValueError("pass either `extent` or `x`/`y`/`z`, not both")
            if np.isscalar(extent):
                extent = (extent,)
            if len(extent) != len(nonflat):
                raise ValueError("extent length must match number of non-flat dims")
            Ls = dict(zip([_AXES[i] for i in nonflat], extent))
            for ax, L in Ls.items():
                specs[ax] = (-L, 0.0) if ax == "z" else (0.0, L)

        self._coords = []
        for i, ax in enumerate(_AXES):
            spec = specs[ax]
            if self.topology[i] == topo.FLAT:
                self._coords.append(_Coordinate(1, 0, topo.FLAT))
                continue
            if spec is None:
                raise ValueError(f"missing coordinate spec for non-flat direction {ax}")
            if (isinstance(spec, tuple) and len(spec) == 2
                    and np.isscalar(spec[0]) and np.isscalar(spec[1])):
                c = _Coordinate(self.N[i], self.H[i], self.topology[i], interval=spec)
            else:
                c = _Coordinate(self.N[i], self.H[i], self.topology[i], faces=spec)
            self._coords.append(c)

    # -- regularity queries (drive pressure-solver selection, the analogue of
    #    the reference's XRegularRG… type aliases, rectilinear_grid.jl:45-51)

    def regular(self, axis):
        return self._coords[axis].regular

    @property
    def all_regular(self):
        return all(c.regular for c in self._coords)

    @property
    def stretched_axes(self):
        return tuple(i for i in range(3)
                     if not self._coords[i].regular and not self.is_flat(i))

    # -- metrics --------------------------------------------------------------

    def _spacing(self, axis, loc):
        c = self._coords[axis]
        s = c.spacing(loc[axis])
        if np.isscalar(s):
            return s
        return broadcastable_1d(s, axis)

    def dx(self, loc):
        return self._spacing(0, loc)

    def dy(self, loc):
        return self._spacing(1, loc)

    def dz(self, loc):
        return self._spacing(2, loc)

    # -- coordinates / nodes --------------------------------------------------

    def coord_padded(self, axis, loc):
        """Padded 1D coordinate array along ``axis`` at location ``loc``
        ('c'/'f')."""
        return self._coords[axis].coord(loc)

    def nodes1d(self, axis, loc):
        """Interior coordinates along ``axis``: N values at centers, N+1 at
        faces when Bounded (reference: xnodes, src/Grids/nodes_and_spacings.jl)."""
        c = self._coords[axis]
        arr = c.coord(loc)
        n, h = self.N[axis], self.H[axis]
        if loc == topo.FACE and self.topology[axis] == topo.BOUNDED:
            return c.xF[h:h + n + 1]
        return arr[h:h + n]

    def xnodes(self, loc="c"):
        return self.nodes1d(0, loc)

    def ynodes(self, loc="c"):
        return self.nodes1d(1, loc)

    def znodes(self, loc="c"):
        return self.nodes1d(2, loc)

    def nodes(self, loc=topo.LOC_CCC):
        """Meshgrid-able interior coordinate arrays for a given 3-location."""
        return tuple(self.nodes1d(i, loc[i]) for i in range(3))

    @property
    def extent(self):
        return tuple(c.extent for c in self._coords)

    def minimum_spacing(self, axis):
        c = self._coords[axis]
        if c.topology == topo.FLAT:
            return np.inf
        if c.regular:
            return c.delta
        h, n = self.H[axis], self.N[axis]
        return float(np.min(c.dC[h:h + n]))

    def with_halo(self, halo):
        """Rebuild this grid with a new halo size (reference:
        inflate_grid_halo_size, src/Models/NonhydrostaticModels/
        nonhydrostatic_model.jl:248-262)."""
        if tuple(halo) == self.H:
            return self
        specs = {}
        for i, ax in enumerate(_AXES):
            c = self._coords[i]
            if c.topology == topo.FLAT:
                specs[ax] = None
            elif c.regular:
                specs[ax] = (c.origin, c.origin + c.extent)
            else:
                h = self.H[i]
                specs[ax] = c.xF[h:h + self.N[i] + 1].copy()
        return RectilinearGrid(size=self.N, x=specs["x"], y=specs["y"], z=specs["z"],
                               topology=self.topology, halo=halo, dtype=self.dtype)

    # -- hashing --------------------------------------------------------------

    def _fingerprint(self):
        return ("RectilinearGrid", self.N, self.H, self.topology,
                np.dtype(self.dtype).name,
                tuple(c._fp for c in self._coords))

    def __repr__(self):
        topo_s = "×".join(t.capitalize() for t in self.topology)
        return (f"RectilinearGrid(size={self.N}, halo={self.H}, "
                f"topology=({topo_s}), extent={self.extent})")
