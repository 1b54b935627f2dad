"""Cubed-sphere grids: panels + 6-panel composition with derived connectivity.

Reference semantics:
* `ConformalCubedSpherePanel` (src/Grids/orthogonal_spherical_shell_grid.jl
  ctor via CubedSphere.jl's Rancic conformal mapping) — ONE face of the cube
  projected to the sphere as an OrthogonalSphericalShellGrid.
* `ConformalCubedSphereGrid` (src/MultiRegion/cubed_sphere_grid.jl:465) — six
  panels composed with rotated inter-panel connectivity
  (cubed_sphere_connectivity.jl) and halo exchange
  (cubed_sphere_boundary_conditions.jl).

Map note: the reference's panels use the Rancic et al. (1996) CONFORMAL map
via the external CubedSphere.jl coefficient tables. Here:
* the composed `ConformalCubedSphereGrid` defaults to the SAME Rancic
  conformal map, computed from first principles in grids/conformal_map.py
  (collocation fit of the vertex series; reproduces the published Table-B1
  coefficients — asserted in tests/test_cubed_sphere.py);
* `mesh="elliptic"` gives an ELLIPTICALLY RELAXED node set (Jacobi
  "normalize-the-neighbor-average" smoothing with the 8 cube vertices
  pinned): also kink-free at panel edges (cos(crossing angle) = 1 to
  machine precision — the property that makes the staggered C-grid
  circulation operators CONSISTENT at edges), and it reproduces the
  conformal map's r^(1/3) vertex behavior, but it is not conformal;
* `mesh="equiangular"` keeps raw gnomonic panels (kinked edge crossings:
  edge-face vorticity carries an O(1) non-converging error; fine for
  tracer-only work). Single panels (`ConformalCubedSpherePanel`) use the
  equiangular map (the FV3/MITgcm-standard variant).

Composition: a cubed-sphere field is ONE array with a leading panel
axis (6, npx, npy, npz) — the panel axis is shardable across devices, and the
inter-panel halo exchange is a static gather (panel, index-slice, optional
reversal) derived NUMERICALLY from the panel corner geometry at construction
(no transcribed connectivity tables — each edge pairing and orientation is
found by matching corner points, which eliminates the classic source of
cubed-sphere bugs)."""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..defaults import defaults
from .orthogonal_spherical_shell import (OrthogonalSphericalShellGrid,
                                         _cart2sph)

# panel rotation matrices: panel 0 is the +x face; 1..3 the other equatorial
# faces; 4 north (+z), 5 south (-z)
def _rz(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])


def _ry(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1.0, 0], [-s, 0, c]])


PANEL_ROTATIONS = [np.eye(3), _rz(np.pi / 2), _rz(np.pi), _rz(3 * np.pi / 2),
                   _ry(-np.pi / 2), _ry(np.pi / 2)]


def panel_corner_coordinates(N, panel):
    """(lon, lat) degree arrays of shape (N+1, N+1): the equiangular gnomonic
    cube face ``panel`` (0-5)."""
    xi = np.linspace(-np.pi / 4, np.pi / 4, N + 1)
    X, Y = np.tan(xi)[:, None], np.tan(xi)[None, :]
    d = np.stack(np.broadcast_arrays(np.ones_like(X * Y), X, Y), axis=-1)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    d = d @ PANEL_ROTATIONS[panel].T
    return _cart2sph(d)


def ConformalCubedSpherePanel(size, panel=0, z=None, radius=None, halo=None,
                              dtype=None):
    """One cubed-sphere panel as an OrthogonalSphericalShellGrid (reference:
    ConformalCubedSpherePanel, orthogonal_spherical_shell_grid.jl)."""
    N = size[0]
    if size[1] != N:
        raise ValueError("cubed-sphere panels are square: Nx == Ny")
    lon, lat = panel_corner_coordinates(N, panel)
    return OrthogonalSphericalShellGrid(lon, lat, z=z, size=size,
                                        radius=radius, halo=halo, dtype=dtype)


# -- connectivity ---------------------------------------------------------------

_SIDES = ("west", "east", "south", "north")


def _edge_points(lon, lat, side):
    """Ordered boundary corner points (unit vectors) of a panel side."""
    from .orthogonal_spherical_shell import _sph2cart
    P = _sph2cart(lon, lat)
    if side == "west":
        return P[0, :]
    if side == "east":
        return P[-1, :]
    if side == "south":
        return P[:, 0]
    return P[:, -1]


def _edge_basis(P, side):
    """Unit (e_x, e_y) index-direction vectors of a panel at the midpoint
    node of ``side`` (one-sided difference into the panel for the
    edge-crossing direction)."""
    n = P.shape[0] - 1
    k = n // 2
    if side == "west":
        ex, ey = P[1, k] - P[0, k], P[0, k + 1] - P[0, k - 1]
    elif side == "east":
        ex, ey = P[n, k] - P[n - 1, k], P[n, k + 1] - P[n, k - 1]
    elif side == "south":
        ex, ey = P[k + 1, 0] - P[k - 1, 0], P[k, 1] - P[k, 0]
    else:
        ex, ey = P[k + 1, n] - P[k - 1, n], P[k, n] - P[k, n - 1]
    return ex / np.linalg.norm(ex), ey / np.linalg.norm(ey)


def derive_edge_rotations(N, conn):
    """{(panel, side): R} where R is the 2x2 signed permutation relating the
    neighbor's local (x, y) velocity components to this panel's at the shared
    edge: (u_p, v_p) = R @ (u_q, v_q). On the edge the two panels' index
    directions are exactly parallel/antiparallel or orthogonal (shared
    equiangular edge parameter), so the basis dot products snap to {0, ±1}
    (reference: the sign conventions hand-coded per edge pair in
    src/MultiRegion/cubed_sphere_boundary_conditions.jl — here derived
    numerically from the panel geometry)."""
    from .orthogonal_spherical_shell import _sph2cart
    corners = [_sph2cart(*panel_corner_coordinates(N, p)) for p in range(6)]
    rots = {}
    for (p, s), (q, t, _rev) in conn.items():
        exp_, eyp = _edge_basis(corners[p], s)
        exq, eyq = _edge_basis(corners[q], t)
        R = np.array([[exp_ @ exq, exp_ @ eyq],
                      [eyp @ exq, eyp @ eyq]])
        Rs = np.rint(R).astype(int)
        if not (np.abs(R - Rs).max() < 0.2
                and (np.abs(Rs).sum(0) == 1).all()
                and (np.abs(Rs).sum(1) == 1).all()):
            raise RuntimeError(f"edge basis did not snap: {(p, s)} -> "
                               f"{(q, t)}: {R}")
        rots[(p, s)] = Rs
    return rots


def derive_connectivity(N):
    """{(panel, side): (neighbor_panel, neighbor_side, reversed)} found by
    geometric corner matching (the numerically-derived analogue of the
    reference's cubed_sphere_connectivity.jl tables)."""
    corners = [panel_corner_coordinates(N, p) for p in range(6)]
    edges = {(p, s): _edge_points(*corners[p], s)
             for p in range(6) for s in _SIDES}
    conn = {}
    for (p, s), pts in edges.items():
        for (q, t), qts in edges.items():
            if q == p:
                continue
            if np.allclose(pts, qts, atol=1e-12):
                conn[(p, s)] = (q, t, False)
                break
            if np.allclose(pts, qts[::-1], atol=1e-12):
                conn[(p, s)] = (q, t, True)
                break
        else:
            raise RuntimeError(f"no neighbor found for panel {p} side {s}")
    return conn


def _extended_corner_nodes(N, H, conn, base=None):
    """Per-panel corner-node cartesian arrays (N+2H+1, N+2H+1, 3) whose halo
    node rows are the TRUE nodes of the neighboring panels (gathered via the
    connectivity; two passes fill the three-panel corner squares). Building
    panel grids from these makes every halo metric — length and area, all
    staggerings — exact, the analogue of the reference's inter-panel metric
    fill (src/MultiRegion/cubed_sphere_grid.jl). ``base``: interior node
    arrays (N+1, N+1, 3) per panel (default: equiangular gnomonic)."""
    from .orthogonal_spherical_shell import _sph2cart
    if base is None:
        base = [_sph2cart(*panel_corner_coordinates(N, p)) for p in range(6)]
    E = N + 2 * H
    ext = [np.full((E + 1, E + 1, 3), np.nan) for _ in range(6)]
    for p in range(6):
        ext[p][H:H + N + 1, H:H + N + 1] = base[p]
    for _ in range(2):
        src = [e.copy() for e in ext]
        for p in range(6):
            for s in _SIDES:
                q, t, rev = conn[(p, s)]
                na_p, na_q = _NORMAL_AXIS[s], _NORMAL_AXIS[t]
                kmap = (E - np.arange(E + 1)) if rev else np.arange(E + 1)
                for m in range(1, H + 1):
                    di = (H - m) if _LOW_SIDE[s] else (H + N + m)
                    si = (H + m) if _LOW_SIDE[t] else (H + N - m)
                    row = np.take(src[q], si, axis=na_q)[kmap]
                    if na_p == 0:
                        ext[p][di, :, :] = row
                    else:
                        ext[p][:, di, :] = row
    for p in range(6):
        bad = np.isnan(ext[p][..., 0])
        if bad.any():
            raise RuntimeError(f"unfilled corner nodes on panel {p}")
    return ext


def _node_exchange(nodes, N, conn, H=1, passes=1):
    """One-halo node exchange (see :func:`_extended_corner_nodes`) returning
    extended (N+2H+1,)² arrays; with ``passes=1`` the diagonal corner squares
    stay NaN — fine for plus-stencil consumers."""
    E = N + 2 * H
    ext = [np.full((E + 1, E + 1, 3), np.nan) for _ in range(6)]
    for p in range(6):
        ext[p][H:H + N + 1, H:H + N + 1] = nodes[p]
    for _ in range(passes):
        src = [e.copy() for e in ext]
        for p in range(6):
            for s in _SIDES:
                q, t, rev = conn[(p, s)]
                na_p, na_q = _NORMAL_AXIS[s], _NORMAL_AXIS[t]
                kmap = (E - np.arange(E + 1)) if rev else np.arange(E + 1)
                for m in range(1, H + 1):
                    di = (H - m) if _LOW_SIDE[s] else (H + N + m)
                    si = (H + m) if _LOW_SIDE[t] else (H + N - m)
                    row = np.take(src[q], si, axis=na_q)[kmap]
                    if na_p == 0:
                        ext[p][di, :, :] = row
                    else:
                        ext[p][:, di, :] = row
    return ext


def _canonicalize_edges(nodes, N, conn):
    """Force bitwise equality of the duplicated edge-node rows: the
    lower-numbered panel owns each shared edge."""
    jmap_fwd = np.arange(N + 1)
    jmap_rev = N - jmap_fwd
    for (p, s), (q, t, rev) in conn.items():
        if p >= q:
            continue
        pi = (0 if _LOW_SIDE[s] else N)
        mine = (nodes[p][pi, :] if _NORMAL_AXIS[s] == 0
                else nodes[p][:, pi])
        row = mine[jmap_rev if rev else jmap_fwd]
        qi = (0 if _LOW_SIDE[t] else N)
        if _NORMAL_AXIS[t] == 0:
            nodes[q][qi, :] = row
        else:
            nodes[q][:, qi] = row
    return nodes


_VERTEX_IDX = [(0, 0), (0, -1), (-1, 0), (-1, -1)]


def _relax_level(nodes, N, conn, tol=1e-13, max_sweeps=20000):
    """Jacobi 'normalize the 4-neighbor average' relaxation of the global
    node set, cube-vertex nodes pinned. At convergence the mesh is mirror-
    symmetric about every panel-edge plane, so grid lines cross panel edges
    WITHOUT kinks — the property that makes the staggered C-grid circulation
    operators consistent (convergent) at the edges. The reference gets the
    same property from the Rancic et al. (1996) conformal map (via the
    external CubedSphere.jl coefficient tables, unavailable offline); an
    elliptically-smoothed mesh is the self-contained equivalent."""
    pinned = [[nodes[p][i, j].copy() for (i, j) in _VERTEX_IDX]
              for p in range(6)]
    for sweep in range(max_sweeps):
        ext = _node_exchange(nodes, N, conn)
        moved = 0.0
        new_nodes = []
        for p in range(6):
            e = ext[p]
            avg = e[:-2, 1:-1] + e[2:, 1:-1] + e[1:-1, :-2] + e[1:-1, 2:]
            avg = avg / np.linalg.norm(avg, axis=-1, keepdims=True)
            for k, (i, j) in enumerate(_VERTEX_IDX):
                avg[i, j] = pinned[p][k]
            moved = max(moved, np.abs(avg - nodes[p]).max())
            new_nodes.append(avg)
        nodes = new_nodes
        if moved < tol:
            break
    return _canonicalize_edges(nodes, N, conn)


def _subdivide(nodes):
    """Spherical midpoint refinement of a panel node array: (n+1)² → (2n+1)²."""
    n = nodes.shape[0] - 1
    out = np.empty((2 * n + 1, 2 * n + 1, 3))
    out[::2, ::2] = nodes
    out[1::2, ::2] = nodes[:-1, :] + nodes[1:, :]
    out[::2, 1::2] = nodes[:, :-1] + nodes[:, 1:]
    out[1::2, 1::2] = (nodes[:-1, :-1] + nodes[1:, :-1]
                       + nodes[:-1, 1:] + nodes[1:, 1:])
    return out / np.linalg.norm(out, axis=-1, keepdims=True)


_ELLIPTIC_CACHE = {}


def elliptic_cubed_sphere_nodes(N):
    """Per-panel node arrays of the elliptically-relaxed cubed sphere at
    resolution N (cascade: relax at N0=4, subdivide + re-relax up to N).
    N must be a power-of-two multiple of a base in {3,4,5,7} (any N works if
    even-divisible down to ≤8; otherwise relaxed directly from gnomonic)."""
    if N in _ELLIPTIC_CACHE:
        return _ELLIPTIC_CACHE[N]
    from .orthogonal_spherical_shell import _sph2cart
    # cascade schedule: halve while even and > 8
    sched = [N]
    while sched[-1] % 2 == 0 and sched[-1] > 8:
        sched.append(sched[-1] // 2)
    sched.reverse()
    n0 = sched[0]
    conn0 = derive_connectivity(n0)
    nodes = [_sph2cart(*panel_corner_coordinates(n0, p)) for p in range(6)]
    nodes = _relax_level(nodes, n0, conn0)
    for n in sched[1:]:
        # the connectivity dict is resolution-independent (same panel
        # topology); reuse the base-level one
        nodes = [_subdivide(a) for a in nodes]
        nodes = _relax_level(nodes, n, conn0, max_sweeps=600)
    _ELLIPTIC_CACHE[N] = nodes
    return nodes


class ConformalCubedSphereGrid:
    """Six-panel composition. Fields live as (6, npx, npy, npz) arrays; use
    ``fill_cubed_sphere_halos`` (centers) and
    ``fill_cubed_sphere_velocity_halos`` (staggered u/v with component
    rotation) between steps. ``panel_grids[p]`` is the
    OrthogonalSphericalShellGrid of panel p, built with EXCHANGED halo
    metrics (exact neighbor-panel lengths/areas in the halos)."""

    def __init__(self, panel_size, z=None, radius=None, halo=None,
                 dtype=None, mesh="conformal"):
        """``mesh``: "conformal" (default) — the Rancic et al. (1996)
        conformal cubed sphere, computed from first principles in
        grids/conformal_map.py (the SAME map the reference gets from
        CubedSphere.jl); "elliptic" — elliptically-relaxed node set (also
        kink-free edge crossings, not conformal); "equiangular" — raw
        gnomonic panels (kinked edge crossings: edge-face vorticity carries
        an O(1) non-converging error; fine for tracer-only work)."""
        from .orthogonal_spherical_shell import (OrthogonalSphericalShellGrid,
                                                 _cart2sph)
        N = panel_size[0]
        if panel_size[1] != N:
            raise ValueError("cubed-sphere panels are square: Nx == Ny")
        if z is not None and len(panel_size) < 3:
            raise ValueError("a z-structured cubed sphere needs "
                             "panel_size=(N, N, Nz)")
        self.connectivity = derive_connectivity(N)
        self.edge_rotations = derive_edge_rotations(N, self.connectivity)
        if mesh not in ("conformal", "elliptic", "equiangular"):
            raise ValueError(f"mesh must be 'conformal', 'elliptic' or "
                             f"'equiangular', got {mesh!r}")
        self.mesh = mesh
        self._z_halo_request = None
        if halo is None:
            H = 3
        elif np.isscalar(halo):
            H = int(halo)
        else:
            halo = tuple(int(h) for h in halo)
            if len(halo) >= 2 and halo[0] != halo[1]:
                # the inter-panel exchange rotates x into y at panel seams,
                # so heterogeneous horizontal halos cannot be honored —
                # refuse instead of silently coercing (round-5 review)
                raise ValueError("cubed-sphere panels need equal horizontal "
                                 f"halos, got {halo[:2]}")
            H = halo[0]
            if len(halo) == 3:
                self._z_halo_request = halo[2]
        if mesh == "conformal":
            from .conformal_map import conformal_cubed_sphere_nodes
            base = conformal_cubed_sphere_nodes(N)
        elif mesh == "elliptic":
            base = elliptic_cubed_sphere_nodes(N)
        else:
            base = None
        ext = _extended_corner_nodes(N, H, self.connectivity, base=base)
        self.extended_nodes = ext
        zh = 0
        if z is not None:
            zh = (self._z_halo_request
                  if self._z_halo_request is not None else 3)
            zh = max(int(zh), 3)   # the shared physics needs >= 3
        # panels are FULLY_CONNECTED horizontally (reference: the local
        # topologies of MultiRegion cubed-sphere panels): halos are
        # exchange-valid neighbor-panel data, so advection keeps FULL order
        # up to the panel edge (no Bounded near-wall cascade) and no lateral
        # BC machinery applies
        from .topology import BOUNDED, FLAT, FULLY_CONNECTED
        ptopo = (FULLY_CONNECTED, FULLY_CONNECTED,
                 BOUNDED if z is not None else FLAT)
        self.panel_grids = [
            OrthogonalSphericalShellGrid(*_cart2sph(ext[p]), z=z,
                                         size=panel_size, radius=radius,
                                         topology=ptopo,
                                         halo=(H, H, zh), dtype=dtype,
                                         corner_halo=H)
            for p in range(6)]
        self.N = self.panel_grids[0].N
        self.H = self.panel_grids[0].H
        self.radius = self.panel_grids[0].radius
        self.dtype = self.panel_grids[0].dtype

    @property
    def padded_shape(self):
        return (6,) + self.panel_grids[0].padded_shape

    def interior(self, a):
        return a[(slice(None),) + self.panel_grids[0].interior_slices]


def _interior_strip(a, grid, side, depth):
    """Interior strip of width ``depth`` adjacent to ``side`` of panel array
    ``a`` (padded (npx, npy, ...)), ordered outward from the boundary."""
    Hx, Hy = grid.H[0], grid.H[1]
    Nx, Ny = grid.N[0], grid.N[1]
    if side == "west":
        return a[Hx:Hx + depth], 0
    if side == "east":
        return a[Hx + Nx - depth:Hx + Nx][::-1], 0
    if side == "south":
        return a[:, Hy:Hy + depth], 1
    return a[:, Hy + Ny - depth:Hy + Ny][:, ::-1], 1


def fill_cubed_sphere_halos(a, csgrid, loc=("c", "c", "c"), passes=2):
    """Inter-panel halo exchange for a CENTER-located cubed-sphere field
    (reference: cubed_sphere_boundary_conditions.jl — here as one static
    gather per side derived from the connectivity; for the staggered u/v
    pair use :func:`fill_cubed_sphere_velocity_halos`).

    Two passes by default: the second pass propagates freshly-filled
    tangential halos into the three-panel corner cells (the reference's
    multi-pass corner treatment)."""
    grid = csgrid.panel_grids[0]
    Hx, Hy = grid.H[0], grid.H[1]
    assert Hx == Hy, "cubed-sphere exchange needs equal x/y halos"
    Nx, Ny = grid.N[0], grid.N[1]
    out = a
    for _ in range(passes):
        src = out
        for p in range(6):
            panel = out[p]
            for side in _SIDES:
                q, t, rev = csgrid.connectivity[(p, side)]
                depth = Hx if side in ("west", "east") else Hy
                strip, axis_q = _interior_strip(src[q], grid, t, depth)
                # strip[0] = neighbor's boundary-adjacent row; align the
                # tangential direction to THIS panel's index direction
                if axis_q == 1:
                    strip = jnp.moveaxis(strip, 1, 0)
                if rev:
                    strip = strip[:, ::-1]
                if side == "west":
                    # halo slot Hx-1 is boundary-adjacent -> reversed depth
                    panel = panel.at[:Hx].set(strip[::-1])
                elif side == "east":
                    panel = panel.at[Hx + Nx:Hx + Nx + Hx].set(strip)
                elif side == "south":
                    dst = jnp.moveaxis(strip, 0, 1)   # (npx, depth, ...)
                    panel = panel.at[:, :Hy].set(dst[:, ::-1])
                else:
                    dst = jnp.moveaxis(strip, 0, 1)
                    panel = panel.at[:, Hy + Ny:Hy + Ny + Hy].set(dst)
            out = out.at[p].set(panel)
    return out


# -- staggered velocity exchange --------------------------------------------------

# axis perpendicular to each side (0 = x, 1 = y)
_NORMAL_AXIS = {"west": 0, "east": 0, "south": 1, "north": 1}
# sides whose boundary sits at the LOW index end of the normal axis
_LOW_SIDE = {"west": True, "east": False, "south": True, "north": False}


def _tang_map(NP, rev, face):
    """Full-padded-range tangential index map into the neighbor panel.
    Centers mirror as j -> NP-1-j; faces (one more valid slot) as
    j -> NP-j, with the out-of-range j=0 slot clipped to its neighbor
    (an outermost corner-halo face, outside every interior stencil)."""
    j = np.arange(NP)
    if not rev:
        return j
    return (NP - 1 - j) if not face else np.clip(NP - j, 1, NP - 1)


def _normal_indices(side_p, side_q, H, N, face):
    """(my destination slice, neighbor source indices) along the normal axes.
    Row m = 1.. counts outward from my boundary = inward from the neighbor's.
    Face-located data owns the shared boundary face (not exchanged); on my
    high side the outermost face halo slot does not exist in the padded
    array (faces need N+1 slots), so face depth there is H-1."""
    if _LOW_SIDE[side_p]:
        ms = range(H, 0, -1)                       # dst slots H-m ascending
        dst = slice(0, H)
    else:
        if face:
            ms = range(1, H)                       # dst slots H+N+m
            dst = slice(H + N + 1, H + N + H)
        else:
            ms = range(1, H + 1)                   # dst slots H+N-1+m
            dst = slice(H + N, H + N + H)
    if _LOW_SIDE[side_q]:
        src = [H + m - 1 + (1 if face else 0) for m in ms]
    else:
        src = [H + N - m for m in ms]
    return dst, src


def _gather(B, naxis_q, nidx, taxis_q, jmap, swap):
    T = jnp.take(B, jnp.asarray(np.asarray(nidx)), axis=naxis_q)
    T = jnp.take(T, jnp.asarray(jmap), axis=taxis_q)
    return jnp.swapaxes(T, 0, 1) if swap else T


def fill_cubed_sphere_velocity_halos(u, v, csgrid, passes=2):
    """Inter-panel halo exchange for the staggered horizontal velocity pair
    (u at x-faces, v at y-faces), both shaped (6, npx, npy, ...).

    Across a panel edge the neighbor's x/y components rotate into this
    panel's: the signed permutation ``csgrid.edge_rotations[(p, side)]``
    selects which neighbor component (and sign) supplies each halo component
    (reference: fill_halo_regions! for velocity tuples in
    src/MultiRegion/cubed_sphere_boundary_conditions.jl). My halo NORMAL
    component (faces normal / centers tangential) always comes from the
    neighbor's own normal component at its side, my TANGENTIAL component
    (centers normal / faces tangential) from the neighbor's tangential one —
    both are the same physical staggered points of the global mesh, so the
    exchange is an exact copy up to the snapped sign."""
    grid = csgrid.panel_grids[0]
    H, N = grid.H[0], grid.N[0]
    assert grid.H[1] == H and grid.N[1] == N
    NP = N + 2 * H
    conn, rots = csgrid.connectivity, csgrid.edge_rotations
    for _ in range(passes):
        su, sv = u, v
        for p in range(6):
            pu, pv = u[p], v[p]
            for s in _SIDES:
                q, t, rev = conn[(p, s)]
                R = rots[(p, s)]
                na_p, na_q = _NORMAL_AXIS[s], _NORMAL_AXIS[t]
                ta_p, ta_q = 1 - na_p, 1 - na_q
                qn = su[q] if na_q == 0 else sv[q]   # neighbor normal comp
                qt = sv[q] if na_q == 0 else su[q]   # neighbor tangential
                sgn_n = R[na_p, na_q]
                sgn_t = R[ta_p, ta_q]
                assert abs(sgn_n) == 1 and abs(sgn_t) == 1
                swap = na_p != na_q
                # my normal component: faces along normal, centers tangential
                dst, src = _normal_indices(s, t, H, N, face=True)
                blk = _gather(qn, na_q, src, ta_q, _tang_map(NP, rev, False),
                              swap)
                idx = (dst, slice(None)) if na_p == 0 else (slice(None), dst)
                if na_p == 0:
                    pu = pu.at[idx].set(sgn_n * blk)
                else:
                    pv = pv.at[idx].set(sgn_n * blk)
                # my tangential component: centers normal, faces tangential
                dst, src = _normal_indices(s, t, H, N, face=False)
                blk = _gather(qt, na_q, src, ta_q, _tang_map(NP, rev, True),
                              swap)
                idx = (dst, slice(None)) if na_p == 0 else (slice(None), dst)
                if na_p == 0:
                    pv = pv.at[idx].set(sgn_t * blk)
                else:
                    pu = pu.at[idx].set(sgn_t * blk)
            u = u.at[p].set(pu)
            v = v.at[p].set(pv)
    return u, v


def sync_shared_velocity_faces(u, v, csgrid):
    """Make the duplicated shared-edge NORMAL-velocity faces bitwise
    consistent: the lower-numbered panel owns each edge; the other copy is
    overwritten through the edge rotation. With synced faces (and exchanged
    h/metrics) both panels compute bitwise-identical mass fluxes through a
    shared face, so global mass conservation holds to summation roundoff."""
    grid = csgrid.panel_grids[0]
    H, N = grid.H[0], grid.N[0]
    NP = N + 2 * H
    for (p, s), (q, t, rev) in csgrid.connectivity.items():
        if p >= q:
            continue
        na_p, na_q = _NORMAL_AXIS[s], _NORMAL_AXIS[t]
        sgn = csgrid.edge_rotations[(q, t)][na_q, na_p]
        pi = H if _LOW_SIDE[s] else H + N
        qi = H if _LOW_SIDE[t] else H + N
        src_field = u if na_p == 0 else v
        row = jnp.take(src_field[p], pi, axis=na_p)          # (NP, ...)
        # normal velocity lives on tangential CENTERS: mirror is NP-1-j
        jmap = np.arange(NP) if not rev else (NP - 1 - np.arange(NP))
        row = jnp.take(row, jnp.asarray(jmap), axis=0) * sgn
        if na_q == 0:
            idx = (q, qi, slice(None))
        else:
            idx = (q, slice(None), qi)
        if na_q == 0:
            u = u.at[idx].set(row)
        else:
            v = v.at[idx].set(row)
    return u, v


# -- concat-assembly exchange --------------------------------------------------

def build_concat_exchange(csgrid):
    """The 2-pass exchange assembled with CONCATENATES instead of
    update-slice chains: per pass, every side-class halo block is built
    from the pass-start snapshot (small static slices/takes, stacked over
    the panel axis) and the array is rebuilt by one concat along x then one
    along y. Reads, sign flips and the S/N-overwrite-corners order are
    identical to fill_cubed_sphere_halos / fill_cubed_sphere_velocity_halos,
    so results are bitwise-equal (tested) — but a pass is ~10 kernels
    instead of ~50 full-array dynamic-update-slices (each of which can
    rewrite the whole buffer)."""
    grid = csgrid.panel_grids[0]
    H, N = csgrid.H[0], csgrid.N[0]
    NP = N + 2 * H
    conn, rots = csgrid.connectivity, csgrid.edge_rotations

    def _c_strip(src, p, side):
        q, t, rev = conn[(p, side)]
        strip, axis_q = _interior_strip(src[q], grid, t, H)
        if axis_q == 1:
            strip = jnp.moveaxis(strip, 1, 0)
        if rev:
            strip = strip[:, ::-1]
        return strip                      # (H, NP, ...), row 0 boundary-adjacent

    def _c_pass(a):
        src = a
        W = jnp.stack([_c_strip(src, p, "west")[::-1] for p in range(6)])
        E = jnp.stack([_c_strip(src, p, "east") for p in range(6)])
        a = jnp.concatenate([W, a[:, H:H + N], E], axis=1)
        S = jnp.stack([jnp.moveaxis(_c_strip(src, p, "south"), 0, 1)[:, ::-1]
                       for p in range(6)])
        Nb = jnp.stack([jnp.moveaxis(_c_strip(src, p, "north"), 0, 1)
                        for p in range(6)])
        return jnp.concatenate([S, a[:, :, H:H + N], Nb], axis=2)

    def exchange_c(a):
        return _c_pass(_c_pass(a))

    def _uv_blocks(su, sv, s, face):
        """(6, ...) stacked halo block of side class ``s`` for the component
        that is ``face``-located along the side's normal axis (the normal
        velocity for face=True, the tangential one for face=False), read
        from snapshots (su, sv) with the edge rotation's sign."""
        blks = []
        for p in range(6):
            q, t, rev = conn[(p, s)]
            R = rots[(p, s)]
            na_p, na_q = _NORMAL_AXIS[s], _NORMAL_AXIS[t]
            ta_q = 1 - na_q
            if face:
                qsrc = su[q] if na_q == 0 else sv[q]
                sgn = R[na_p, na_q]
            else:
                qsrc = sv[q] if na_q == 0 else su[q]
                sgn = R[1 - na_p, 1 - na_q]
            swap = na_p != na_q
            dst, srcidx = _normal_indices(s, t, H, N, face=face)
            blk = _gather(qsrc, na_q, srcidx, ta_q,
                          _tang_map(NP, rev, not face), swap)
            blks.append(sgn * blk)
        return jnp.stack(blks)

    def _uv_pass(u, v):
        su, sv = u, v
        # x-direction: u's normal (face) blocks, v's tangential blocks
        Wn = _uv_blocks(su, sv, "west", True)
        En = _uv_blocks(su, sv, "east", True)
        Wt = _uv_blocks(su, sv, "west", False)
        Et = _uv_blocks(su, sv, "east", False)
        u = jnp.concatenate([Wn, u[:, H:H + N + 1], En], axis=1)
        v = jnp.concatenate([Wt, v[:, H:H + N], Et], axis=1)
        # y-direction (overwrites corners, as the reference's S/N-last order)
        Sn = _uv_blocks(su, sv, "south", True)
        Nn = _uv_blocks(su, sv, "north", True)
        St = _uv_blocks(su, sv, "south", False)
        Nt = _uv_blocks(su, sv, "north", False)
        u = jnp.concatenate([St, u[:, :, H:H + N], Nt], axis=2)
        v = jnp.concatenate([Sn, v[:, :, H:H + N + 1], Nn], axis=2)
        return u, v

    def exchange_uv(u, v):
        u, v = sync_shared_velocity_faces(u, v, csgrid)
        u, v = _uv_pass(u, v)
        return _uv_pass(u, v)

    return exchange_c, exchange_uv


def build_concat_exchange_catform(csgrid):
    """:func:`build_concat_exchange` operating natively on the PANEL-
    CONCATENATED layout (6·npx, npy, ...) — panel p is the x-block
    ``a[p*npx:(p+1)*npx]``. Used by the batched CubedSphereHydrostaticModel
    step, which keeps every in-flight array in concat form: XLA picks one
    layout for the whole step and no stacked↔concat reshapes (which lower to
    physical relayout copies under the compiler's preferred {y,x-minor}
    tiling) ever appear. Bitwise-identical to the stacked variant (tested).

    Returns ``(exchange_c, exchange_uv, sync_uv)``."""
    grid = csgrid.panel_grids[0]
    H, N = csgrid.H[0], csgrid.N[0]
    NP = N + 2 * H
    conn, rots = csgrid.connectivity, csgrid.edge_rotations

    def Pq(a, q):
        return a[q * NP:(q + 1) * NP]

    def _c_strip(src, p, side):
        q, t, rev = conn[(p, side)]
        strip, axis_q = _interior_strip(Pq(src, q), grid, t, H)
        if axis_q == 1:
            strip = jnp.moveaxis(strip, 1, 0)
        if rev:
            strip = strip[:, ::-1]
        return strip

    def _c_pass(a):
        src = a
        parts = []
        for p in range(6):
            parts += [_c_strip(src, p, "west")[::-1],
                      Pq(a, p)[H:H + N],
                      _c_strip(src, p, "east")]
        a = jnp.concatenate(parts, axis=0)
        S = jnp.concatenate(
            [jnp.moveaxis(_c_strip(src, p, "south"), 0, 1)[:, ::-1]
             for p in range(6)], axis=0)
        Nb = jnp.concatenate(
            [jnp.moveaxis(_c_strip(src, p, "north"), 0, 1)
             for p in range(6)], axis=0)
        return jnp.concatenate([S, a[:, H:H + N], Nb], axis=1)

    def exchange_c(a):
        return _c_pass(_c_pass(a))

    def _uv_block(su, sv, p, s, face):
        q, t, rev = conn[(p, s)]
        R = rots[(p, s)]
        na_p, na_q = _NORMAL_AXIS[s], _NORMAL_AXIS[t]
        ta_q = 1 - na_q
        if face:
            qsrc = Pq(su, q) if na_q == 0 else Pq(sv, q)
            sgn = R[na_p, na_q]
        else:
            qsrc = Pq(sv, q) if na_q == 0 else Pq(su, q)
            sgn = R[1 - na_p, 1 - na_q]
        swap = na_p != na_q
        dst, srcidx = _normal_indices(s, t, H, N, face=face)
        return sgn * _gather(qsrc, na_q, srcidx, ta_q,
                             _tang_map(NP, rev, not face), swap)

    def _uv_pass(u, v):
        su, sv = u, v
        up, vp = [], []
        for p in range(6):
            up += [_uv_block(su, sv, p, "west", True),
                   Pq(u, p)[H:H + N + 1],
                   _uv_block(su, sv, p, "east", True)]
            vp += [_uv_block(su, sv, p, "west", False),
                   Pq(v, p)[H:H + N],
                   _uv_block(su, sv, p, "east", False)]
        u = jnp.concatenate(up, axis=0)
        v = jnp.concatenate(vp, axis=0)
        St = jnp.concatenate([_uv_block(su, sv, p, "south", False)
                              for p in range(6)], axis=0)
        Nt = jnp.concatenate([_uv_block(su, sv, p, "north", False)
                              for p in range(6)], axis=0)
        Sn = jnp.concatenate([_uv_block(su, sv, p, "south", True)
                              for p in range(6)], axis=0)
        Nn = jnp.concatenate([_uv_block(su, sv, p, "north", True)
                              for p in range(6)], axis=0)
        u = jnp.concatenate([St, u[:, H:H + N], Nt], axis=1)
        v = jnp.concatenate([Sn, v[:, H:H + N + 1], Nn], axis=1)
        return u, v

    def sync_uv(u, v):
        for (p, s), (q, t, rev) in conn.items():
            if p >= q:
                continue
            na_p, na_q = _NORMAL_AXIS[s], _NORMAL_AXIS[t]
            sgn = rots[(q, t)][na_q, na_p]
            pi = H if _LOW_SIDE[s] else H + N
            qi = H if _LOW_SIDE[t] else H + N
            src = u if na_p == 0 else v
            row = (src[p * NP + pi] if na_p == 0
                   else src[p * NP:(p + 1) * NP, pi])
            jmap = (np.arange(NP) if not rev
                    else (NP - 1 - np.arange(NP)))
            row = jnp.take(row, jnp.asarray(jmap), axis=0) * sgn
            if na_q == 0:
                u = u.at[q * NP + qi].set(row)
            else:
                v = v.at[q * NP:(q + 1) * NP, qi].set(row)
        return u, v

    def exchange_uv(u, v):
        u, v = sync_uv(u, v)
        u, v = _uv_pass(u, v)
        return _uv_pass(u, v)

    def exchange_c_1pass(a):
        """Single-pass center exchange: every straight-edge halo ring is
        exchange-valid; only 3-panel CORNER blocks (which need pass 2's
        propagation) stay stale. Sufficient for +-shaped radius-1 stencil
        consumers — the barotropic subcycle's divergence/gradient never
        read corner slots."""
        return _c_pass(a)

    def exchange_uv_1pass(u, v):
        u, v = sync_uv(u, v)
        return _uv_pass(u, v)

    exchange_c.single_pass = exchange_c_1pass
    exchange_uv.single_pass = exchange_uv_1pass
    return exchange_c, exchange_uv, sync_uv


# -- vectorized (single-gather) exchange -------------------------------------------

def build_fast_exchange(csgrid):
    """Derive the COMPLETE inter-panel exchange as static gather maps.

    The 2-pass exchange is linear in (u, v) and every output position copies
    exactly one (possibly sign-flipped) source element, so probing the
    per-panel reference implementation with index-valued fields recovers the
    whole operation as one signed permutation-with-duplication per source
    component. The runtime exchange is then 1 gather (centers) or 2 gathers
    + masked add (staggered velocity pair) — collapsing the ~48-op
    .at[].set chain that made 6-panel XLA graphs huge (remote compiles of
    tens of minutes at production sizes) and leaving a single efficient
    take per field.

    Returns ``(exchange_c, exchange_uv)``:
    * ``exchange_c(a)``      == fill_cubed_sphere_halos(a, csgrid)
    * ``exchange_uv(u, v)``  == fill_cubed_sphere_velocity_halos(
                                    *sync_shared_velocity_faces(u, v,
                                                                csgrid),
                                    csgrid)
    both bitwise-identical to the reference path (tested)."""
    g0 = csgrid.panel_grids[0]
    H, N = csgrid.H[0], csgrid.N[0]
    NP = N + 2 * H
    n = 6 * NP * NP
    idx = np.arange(1.0, n + 1.0, dtype=np.float64).reshape(6, NP, NP, 1)

    # centers: one probe
    rc = np.asarray(
        fill_cubed_sphere_halos(jnp.asarray(idx), csgrid)).reshape(n)
    cmap = np.rint(np.abs(rc)).astype(np.int32) - 1
    assert (np.sign(rc) > 0).all()      # center exchange never flips sign

    def exchange_c(a):
        flat = a.reshape((n,) + a.shape[3:])
        return jnp.take(flat, jnp.asarray(cmap), axis=0).reshape(a.shape)

    # staggered pair: two probes of the composed sync+fill
    def composed(u, v):
        u, v = sync_shared_velocity_faces(u, v, csgrid)
        return fill_cubed_sphere_velocity_halos(u, v, csgrid)

    ia = jnp.asarray(idx)
    ruA, rvA = composed(ia, ia)          # s * idx_src
    ruB, rvB = composed(ia, -ia)         # s * (+idx if from u else -idx)
    maps = []
    for rA, rB in ((np.asarray(ruA).reshape(n), np.asarray(ruB).reshape(n)),
                   (np.asarray(rvA).reshape(n), np.asarray(rvB).reshape(n))):
        src = np.rint(np.abs(rA)).astype(np.int32) - 1
        s = np.sign(rA)
        from_u = np.isclose(rA, rB)
        wu = np.where(from_u, s, 0.0)
        wv = np.where(from_u, 0.0, s)
        maps.append((src, wu, wv))
    (usrc, u_wu, u_wv), (vsrc, v_wu, v_wv) = maps
    dtype = g0.dtype
    usrc_j = jnp.asarray(usrc)
    vsrc_j = jnp.asarray(vsrc)
    u_wu_j = jnp.asarray(u_wu, dtype)[:, None]
    u_wv_j = jnp.asarray(u_wv, dtype)[:, None]
    v_wu_j = jnp.asarray(v_wu, dtype)[:, None]
    v_wv_j = jnp.asarray(v_wv, dtype)[:, None]

    def exchange_uv(u, v):
        sh = u.shape
        uf = u.reshape(n, -1)
        vf = v.reshape(n, -1)
        ug = jnp.take(uf, usrc_j, axis=0)
        vg_for_u = jnp.take(vf, usrc_j, axis=0)
        un = u_wu_j * ug + u_wv_j * vg_for_u
        ug_for_v = jnp.take(uf, vsrc_j, axis=0)
        vg = jnp.take(vf, vsrc_j, axis=0)
        vn = v_wu_j * ug_for_v + v_wv_j * vg
        return un.reshape(sh), vn.reshape(sh)

    return exchange_c, exchange_uv


def fast_exchange(csgrid):
    """Cached (exchange_c, exchange_uv) for ``csgrid``.

    Three variants, all bitwise equal; ``platform.cubed_sphere_exchange``
    picks one:
    * "gather" (build_fast_exchange): single-gather maps that shrink the
      XLA graph, and so the compile time, enormously;
    * "concat" (build_concat_exchange): concat-assembled side-class strips,
      about ten fused copies per pass instead of about fifty full-array
      update-slices of the slice chain and without irregular row gathers;
    * "slice": the reference-shaped per-panel slice-copy chain, kept as
      the semantic baseline the others are tested against."""
    cached = getattr(csgrid, "_fast_exchange_sel", None)
    if cached is not None:
        return cached
    from ..platform import cubed_sphere_exchange
    kind = cubed_sphere_exchange()
    if kind == "gather":
        cached = build_fast_exchange(csgrid)
    elif kind == "concat":
        cached = build_concat_exchange(csgrid)
    else:
        def exchange_c(a):
            return fill_cubed_sphere_halos(a, csgrid)

        def exchange_uv(u, v):
            u, v = sync_shared_velocity_faces(u, v, csgrid)
            return fill_cubed_sphere_velocity_halos(u, v, csgrid)

        cached = (exchange_c, exchange_uv)
    csgrid._fast_exchange_sel = cached
    return cached


# -- panel-batched (concatenated) grid ------------------------------------------
#
# The 6-panel tendency assembly used to run the shared physics per panel in a
# Python loop: six copies of every kernel over (npx, npy, npz) arrays.
# Kernels that small are launch-bound, and six structurally-identical XLA
# subgraphs (differing only in baked metric constants) sextuple the program.
# ConcatPanelsGrid presents the six panels as ONE grid whose metric tables are
# concatenated along x — a (6, npx, npy, npz) stacked field reshapes (for
# free: the leading-axis merge is layout-preserving) to (6*npx, npy, npz) and
# every whole-array stencil/closure/solver pass runs ONCE on a 6x larger
# array. Stencil reads that cross a panel seam land exclusively in outermost-
# halo slots (the same slots whose values are garbage in the per-panel path —
# operators/shifts.py zero-fills them at array edges), and the inter-panel
# exchange overwrites every halo slot between stages, so the two evaluations
# agree bitwise on all exchange-consumed values. The reference's analogue is
# launching one kernel per region per stage (src/MultiRegion/
# multi_region_models.jl); this is the same region-wise math batched into
# single device programs.


class _ConcatBoundary:
    """Immersed boundary carrying precomputed concatenated solid masks (and,
    for PartialCellBottom panels, the concatenated effective spacings)."""

    def __init__(self, solid_cat, fingerprint):
        self._solid = solid_cat
        self._fingerprint = fingerprint

    def solid_centers(self, grid):
        return self._solid.copy()

    def _fp(self):
        return ("_ConcatBoundary", self._fingerprint)


class _ConcatPartialBoundary(_ConcatBoundary):
    def __init__(self, solid_cat, dz_eff_cat, fingerprint):
        super().__init__(solid_cat, fingerprint)
        self._dz_eff = dz_eff_cat

    def effective_dz(self, grid):
        return self._dz_eff


class ConcatPanelsGrid:
    """Grid-protocol adapter over six cubed-sphere panels with every 2D
    metric table concatenated along x (see module note above). Horizontal
    "interior" spans ALL columns (halo slots carry exchange-valid neighbor-
    panel data, and per-column diagnostics — w, hydrostatic pressure, depth
    integrals — are wanted on them too); z keeps its true interior window."""

    def __init__(self, panel_grids):
        from .base import AbstractGrid  # noqa: F401  (protocol reference)
        self._panels = list(panel_grids)
        g0 = self._panels[0]
        if any(g.padded_shape != g0.padded_shape for g in self._panels):
            raise ValueError("panels must share shape")
        self.NPX = g0.padded_shape[0]
        self.H = g0.H
        self.N = (6 * self.NPX - 2 * g0.H[0], g0.N[1], g0.N[2])
        self.topology = g0.topology
        self.dtype = g0.dtype
        self.radius = getattr(g0, "radius", None)
        self._zc = g0._zc
        self._cache = {}

    # -- shape/topology protocol ------------------------------------------------

    @property
    def padded_shape(self):
        s = self._panels[0].padded_shape
        return (6 * s[0], s[1], s[2])

    @property
    def interior_slices(self):
        # x spans every column between the two outermost strips (inter-panel
        # halo columns carry exchange-valid data and are duplicated interior
        # points); y/z keep their true windows. Matches the AbstractGrid
        # formula with this grid's N, so the ImmersedBoundaryGrid wrapper
        # reports the same slices.
        return tuple(slice(h, h + n) for n, h in zip(self.N, self.H))

    def interior(self, a):
        return a[self.interior_slices]

    def is_flat(self, axis):
        return self._panels[0].is_flat(axis)

    def is_periodic(self, axis):
        return self._panels[0].is_periodic(axis)

    def is_bounded(self, axis):
        return self._panels[0].is_bounded(axis)

    def regular(self, axis):
        return self._panels[0].regular(axis)

    @property
    def stretched_axes(self):
        return self._panels[0].stretched_axes

    @property
    def extent(self):
        return self._panels[0].extent

    @property
    def all_regular(self):
        return False

    # -- metrics (concatenated along x) ------------------------------------------

    def _cat2d(self, name, loc):
        key = (name, tuple(loc))
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        parts = [getattr(g, name)(loc) for g in self._panels]
        shp = self._panels[0].padded_shape
        # broadcast scalars / 1D z-profiles to full blocks only when the
        # panels disagree; identical tables stay shared (no concat)
        if all(p is parts[0] or (np.shape(p) == np.shape(parts[0])
                                 and np.array_equal(p, parts[0]))
               for p in parts[1:]):
            out = parts[0]
        else:
            blocks = [np.broadcast_to(np.asarray(p, np.float64),
                                      (shp[0], shp[1],
                                       np.shape(p)[2] if np.ndim(p) == 3
                                       and np.shape(p)[2] != 1 else 1))
                      for p in parts]
            zdims = {b.shape[2] for b in blocks}
            if len(zdims) > 1:
                blocks = [np.broadcast_to(b, (shp[0], shp[1], shp[2]))
                          for b in blocks]
            out = np.ascontiguousarray(np.concatenate(blocks, axis=0))
        self._cache[key] = out
        return out

    def dx(self, loc):
        return self._cat2d("dx", loc)

    def dy(self, loc):
        return self._cat2d("dy", loc)

    def dz(self, loc):
        return self._cat2d("dz", loc)

    def Az(self, loc):
        return self._cat2d("Az", loc)

    def Ax(self, loc):
        from .base import _mul
        return _mul(self.dy(loc), self.dz(loc))

    def Ay(self, loc):
        from .base import _mul
        return _mul(self.dx(loc), self.dz(loc))

    def V(self, loc):
        from .base import _mul
        return _mul(self.Az(loc), self.dz(loc))

    # -- nodes -------------------------------------------------------------------

    def nodes2d_padded(self, loc=("c", "c")):
        key = ("nodes2d_padded", tuple(loc[:2]))
        hit = self._cache.get(key)
        if hit is None:
            lam = np.concatenate([g.nodes2d_padded(loc)[0]
                                  for g in self._panels], axis=0)
            phi = np.concatenate([g.nodes2d_padded(loc)[1]
                                  for g in self._panels], axis=0)
            hit = (lam, phi)
            self._cache[key] = hit
        return hit

    def coord_padded(self, axis, loc):
        if axis == 2:
            return self._panels[0].coord_padded(2, loc)
        raise ValueError(
            "ConcatPanelsGrid has no 1D horizontal coordinates (curvilinear "
            "panels); use nodes2d_padded")

    def znodes(self, loc="c"):
        return self._panels[0].znodes(loc)

    def minimum_spacing(self, axis):
        return min(g.minimum_spacing(axis) for g in self._panels)

    # -- identity ------------------------------------------------------------------

    def with_halo(self, halo):
        raise ValueError("rebuild the composed ConformalCubedSphereGrid "
                         "instead of re-haloing its panel concatenation")

    def _fingerprint(self):
        return ("ConcatPanelsGrid",) + tuple(g._fingerprint()
                                             for g in self._panels)

    def __hash__(self):
        return hash(self._fingerprint())

    def __eq__(self, other):
        return (type(other) is type(self)
                and other._fingerprint() == self._fingerprint())

    def __repr__(self):
        return f"ConcatPanelsGrid(6x{self._panels[0].N})"


def concat_panels_grid(panel_grids):
    """Build the batched-panels grid from (possibly immersed-wrapped) panel
    grids: the underlying OSSGs concatenate into a :class:`ConcatPanelsGrid`;
    immersed panels wrap it in a regular ImmersedBoundaryGrid whose solid
    masks (and PartialCell effective spacings) are the panel concatenations —
    so every immersed code path (fluid_mask/mask_immersed/column depths) is
    the shared implementation."""
    from ..immersed import ImmersedBoundaryGrid
    if not isinstance(panel_grids[0], ImmersedBoundaryGrid):
        return ConcatPanelsGrid(panel_grids)
    under = ConcatPanelsGrid([g.underlying_grid for g in panel_grids])
    solid_cat = np.concatenate([g.solid_ccc for g in panel_grids], axis=0)
    fp = tuple(g._fingerprint() for g in panel_grids)
    dzs = [getattr(g, "_dz_eff", None) for g in panel_grids]
    if any(d is not None for d in dzs):
        if not all(d is not None for d in dzs):
            raise ValueError("mixed PartialCell/GridFitted panels")
        shp = panel_grids[0].padded_shape
        dz_eff_cat = {
            key: np.ascontiguousarray(np.concatenate(
                [np.broadcast_to(np.asarray(d[key], np.float64), shp)
                 for d in dzs], axis=0))
            for key in dzs[0]}
        return ImmersedBoundaryGrid(under,
                                    _ConcatPartialBoundary(solid_cat,
                                                           dz_eff_cat, fp))
    return ImmersedBoundaryGrid(under, _ConcatBoundary(solid_cat, fp))
