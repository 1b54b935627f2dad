"""Abstract grid machinery shared by all grid types.

Design (not a port):

* A grid is a **static, hashable** Python object. It is never traced: passing it
  into a jitted function as a static argument makes XLA specialize the whole
  step program on sizes, topology, and metrics — the JAX analogue of the
  reference's Julia type-parameter dispatch (reference: src/Grids/Grids.jl).
* All fields on a grid share ONE padded array shape
  ``(Nx + 2Hx, Ny + 2Hy, Nz + 2Hz)`` regardless of staggered location.
  Interior cell ``i`` lives at padded index ``i + H``. For ``Face`` locations in
  a ``Bounded`` direction, the extra boundary face ``i = N`` lives in the first
  halo slot (``H + N``), which always exists because ``H >= 1`` for non-Flat
  dims. (The reference instead allocates N+1 points for bounded face fields —
  reference: src/Grids/new_data.jl — but a uniform shape lets every field stack
  into one pytree and every kernel share one shape, which XLA strongly prefers.)
* Metric accessors return either Python scalars (regular spacing — folded into
  the XLA program as constants) or numpy arrays broadcastable against padded
  3D arrays. 1D/2D metric arrays are baked into the compiled program as
  constants: they are tiny compared to HBM-resident state.
"""

from __future__ import annotations

import numpy as np

from . import topology as topo


class AbstractGrid:
    """Protocol: concrete grids define

    - ``N = (Nx, Ny, Nz)``, ``H = (Hx, Hy, Hz)``, ``topology``, ``dtype``
    - metric methods ``dx(loc) / dy(loc) / dz(loc)`` with ``loc`` a 3-tuple of
      ``"c"``/``"f"``, returning scalars or arrays broadcastable to the padded
      shape (reference analogue: src/Operators/spacings_and_areas_and_volumes.jl)
    - coordinate methods ``x(lx) / y(ly) / z(lz)`` (padded 1D numpy arrays)
    """

    def minimum_xspacing(self):
        """Reference: nodes_and_spacings.jl minimum_xspacing."""
        return self.minimum_spacing(0)

    def minimum_yspacing(self):
        return self.minimum_spacing(1)

    def minimum_zspacing(self):
        return self.minimum_spacing(2)

    # -- shapes ---------------------------------------------------------------

    @property
    def shape(self):
        """Interior shape (Nx, Ny, Nz)."""
        return tuple(self.N)

    @property
    def padded_shape(self):
        return tuple(n + 2 * h for n, h in zip(self.N, self.H))

    @property
    def interior_slices(self):
        return tuple(slice(h, h + n) for n, h in zip(self.N, self.H))

    def interior(self, a):
        """View of the interior of a padded array."""
        return a[self.interior_slices]

    def cells(self):
        return int(np.prod(self.N))

    # -- derived metrics (areas and volumes) ---------------------------------
    # reference: src/Operators/spacings_and_areas_and_volumes.jl — areas are
    # products of the two transverse spacings at the relevant location.

    def Ax(self, loc):
        """Area of the x-normal cell face at location ``loc``."""
        return _mul(self.dy(loc), self.dz(loc))

    def Ay(self, loc):
        return _mul(self.dx(loc), self.dz(loc))

    def Az(self, loc):
        return _mul(self.dx(loc), self.dy(loc))

    def V(self, loc):
        """Cell volume at location ``loc``."""
        return _mul(_mul(self.dx(loc), self.dy(loc)), self.dz(loc))

    # -- topology helpers -----------------------------------------------------

    def is_flat(self, axis):
        return self.topology[axis] == topo.FLAT

    def is_periodic(self, axis):
        return self.topology[axis] == topo.PERIODIC

    def is_bounded(self, axis):
        return self.topology[axis] == topo.BOUNDED

    # -- hashing / equality ---------------------------------------------------
    # Grids are static jit arguments: equality and hash go through a
    # fingerprint so numpy-array members don't break hashing.

    def _fingerprint(self):
        raise NotImplementedError

    def __hash__(self):
        return hash(self._fingerprint())

    def __eq__(self, other):
        return type(self) is type(other) and self._fingerprint() == other._fingerprint()


def _mul(a, b):
    """Multiply metric factors (scalars or broadcastable numpy arrays)."""
    return a * b


def broadcastable_1d(arr, axis):
    """Reshape a 1D numpy metric array for broadcasting along ``axis`` of a 3D
    padded array."""
    shape = [1, 1, 1]
    shape[axis] = -1
    return np.asarray(arr).reshape(shape)
