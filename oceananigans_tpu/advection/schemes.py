"""Advection schemes: Centered, UpwindBiased, WENO.

Reference semantics: src/Advection/centered_reconstruction.jl,
upwind_biased_reconstruction.jl, weno_reconstruction.jl (struct :7-22, ctor
:77-93) and Advection.jl:52-60 (orders up to Centered(12)/UpwindBiased(11)/
WENO(11) via buffer 1–6).

Each scheme is a static hashable object exposing two methods over padded
arrays:

    symmetric(grid, a, axis, beta)            # face value, no bias
    biased(grid, a, axis, beta, side)         # 'left'/'right' biased value
    biased_pair(grid, a, axis, beta)          # (left, right) in one pass

``beta`` is 0 for center→face output, 1 for face→center output.

Like the reference, an upwind/WENO scheme carries a lower-order centered
scheme for interpolating the *advecting* velocity (reference:
``advecting_velocity_scheme``, upwind_biased_reconstruction.jl), and WENO
computes smoothness indicators in float32 by default (the reference's FT2
low-precision path — weno_reconstruction.jl:7-22).
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from .reconstruction import (_ShiftCache, eno_coefficients,
                             eno_coefficients_nonuniform, left_shifts, mirror,
                             optimal_weights, optimal_weights_nonuniform,
                             smoothness_factors, smoothness_value,
                             stencil_value)
from ..operators.shifts import shift


def _is_stretched(grid, axis):
    reg = getattr(grid, "regular", None)
    if reg is None or grid.is_flat(axis):
        return False
    return not reg(axis)


def _padded_faces(grid, axis):
    """npad+1 face positions along ``axis`` (the last one extrapolated)."""
    f = np.asarray(grid.coord_padded(axis, "f"), np.float64)
    d = f[-1] - f[-2] if len(f) > 1 else 1.0
    return np.append(f, f[-1] + d)


@functools.lru_cache(maxsize=None)
def _nonuniform_eno_np(faces_key, nfaces, beta, k, s, mirrored, npad):
    """Cached numeric core of _nonuniform_eno: raw 1D numpy coefficient
    arrays keyed by the face positions (pure data — no grid objects)."""
    faces = np.frombuffer(faces_key, np.float64).reshape(nfaces)
    if not mirrored:
        return tuple(eno_coefficients_nonuniform(faces, k, s, beta, npad))
    # right-biased stencil s covers cells at shifts mirror(left) =
    # (β+s-j for j), i.e. absolute cells i+β-1 - (s'...) reflected: derive by
    # evaluating a reconstruction whose cells are exactly those shifts.
    shifts = mirror(left_shifts(k, s, beta), beta)
    lo_shift = min(shifts)
    s_equiv = beta - 1 - lo_shift  # cells span lo_shift..lo_shift+k-1
    cs = eno_coefficients_nonuniform(faces, k, s_equiv, beta, npad)
    # cells ascend from lo_shift; shifts list descends — reverse pairing
    return tuple(reversed(cs))


def _nonuniform_eno(grid, axis, beta, k, s, mirrored):
    """Per-index ENO coefficient arrays (broadcastable along ``axis``) for a
    stretched grid direction (reference: the grid-aware coefficient tables of
    reconstruction_coefficients.jl; here derived exactly from the face
    positions — and, unlike the reference where this is opt-in via
    WENO(grid=...), applied automatically on stretched axes)."""
    from ..grids.base import broadcastable_1d
    npad = grid.padded_shape[axis]
    faces = _padded_faces(grid, axis)
    cs = _nonuniform_eno_np(faces.tobytes(), faces.size, beta, k, s,
                            mirrored, npad)
    return tuple(broadcastable_1d(c, axis) for c in cs)




class _SelectedShiftCache:
    """Shift reader returning ``where(pos, a[o], a[mirror(o)])`` — the
    upwind-selected cell for offset ``o`` (see AdvectionScheme.biased_by).
    ``zbc`` activates halo-free boundary-aware reads."""

    def __init__(self, a, axis, pos, beta, zbc=None):
        self.a, self.axis, self.pos, self.beta = a, axis, pos, beta
        self.zbc = zbc
        self.cache = {}

    def _shift(self, off):
        if self.zbc is not None:
            from ..operators.shifts import shift_zbc
            return shift_zbc(self.a, off, self.axis, self.zbc)
        return shift(self.a, off, self.axis)

    def __call__(self, off):
        if off not in self.cache:
            l = self._shift(off)
            r = self._shift(2 * self.beta - 1 - off)
            self.cache[off] = jnp.where(self.pos, l, r)
        return self.cache[off]

# WENO regularization (reference: weno_interpolants.jl `const ϵ = 1f-8`)
WENO_EPSILON = 1e-8

# Global smoothness indicator τ coefficients per buffer k (Don & Borges 2013,
# reference: weno_interpolants.jl:308-313 `global_smoothness_indicator`):
# τ = |Σ_s t_s β_s| with β ordered from the downwind-most stencil (s=0).
TAU_COEFFS = {
    2: (1, -1),
    3: (1, 0, -1),
    4: (1, 3, -3, -1),
    5: (1, 2, -6, 2, 1),
    6: (1, 36, 135, -135, -36, -1),
}


def _axis_bounded(grid, axis):
    """Whether ``axis`` is a Bounded direction the near-boundary order
    cascade applies to (reference:
    topologically_conditional_interpolation.jl)."""
    topo = getattr(grid, "topology", None)
    if topo is None or grid.is_flat(axis):
        return False
    from ..grids.topology import BOUNDED
    return topo[axis] == BOUNDED


def _immersed_ok(grid, axis, R):
    """Static fluid-window mask for the immersed near-boundary order
    cascade (reference: immersed_advective_fluxes.jl — within the
    scheme's buffer of a solid cell the reconstruction drops to the
    buffer scheme, recursively down to the 2-point order-1 stencil whose
    reads at a fluid face never touch solid values). True where NO solid
    cell lies within ±R cells along ``axis`` — conservative for both
    face (β=0) and center (β=1) targets. None on non-immersed grids."""
    solid = getattr(grid, "solid_ccc", None)
    if solid is None or grid.is_flat(axis):
        return None
    cache = getattr(grid, "_imm_adv_masks", None)
    if cache is None:
        cache = grid._imm_adv_masks = {}
    key = (axis, R)
    m = cache.get(key)
    if m is None:
        s = np.asarray(solid)
        near = s.copy()
        for r in range(1, R + 1):
            near = near | np.roll(s, r, axis) | np.roll(s, -r, axis)
        m = cache[key] = jnp.asarray(~near)
    return m


def _cascade_select(grid, axis, beta, R, hi, lo):
    """Blend the scheme's reconstruction ``hi`` with its buffer-scheme value
    ``lo`` by the static outside-the-boundary-buffer mask (reference:
    topologically_conditional_interpolation.jl `outside_biased_halo` /
    `outside_symmetric_halo`): with R = the scheme's buffer, high order
    applies at faces i ∈ [R+1, N+1−R] (1-based; face i ↔ padded slot
    H+i−1) and centers i ∈ [R, N+1−R]."""
    from jax import lax

    H, N = grid.H[axis], grid.N[axis]
    i0 = H + R - beta
    i1 = H + N - R
    iota = lax.broadcasted_iota(jnp.int32, hi.shape, axis)
    return jnp.where((iota >= i0) & (iota <= i1), hi, lo)


class AdvectionScheme:
    required_halo = 1

    def _fp(self):
        return (type(self).__name__, self.order)

    def __hash__(self):
        return hash(self._fp())

    def __eq__(self, other):
        return isinstance(other, AdvectionScheme) and self._fp() == other._fp()

    def __repr__(self):
        return f"{type(self).__name__}(order={self.order})"

    def buffer_scheme(self):
        """The lower-order scheme evaluated inside the boundary buffer of a
        Bounded direction (reference: `buffer_scheme` fields of
        weno/upwind_biased/centered_reconstruction.jl). None = this scheme
        is evaluated unconditionally (order ≤ the 1-buffer floor)."""
        return None

    def _cascade(self, grid, axis, beta, hi, lo_eval):
        bs = self.buffer_scheme()
        if bs is None:
            return hi
        bounded = _axis_bounded(grid, axis)
        imask = _immersed_ok(grid, axis, self.buffer)
        if not bounded and imask is None:
            return hi
        lo = lo_eval(bs)
        out = hi
        if bounded:
            out = _cascade_select(grid, axis, beta, self.buffer, out, lo)
        if imask is not None:
            out = jnp.where(imask, out, lo)
        return out

    def biased_pair(self, grid, a, axis, beta, smooth=None, zbc=None):
        """(left, right) biased reconstructions. ``smooth`` optionally lists
        arrays whose summed Jiang–Shu indicators replace the reconstructed
        variable's own (the reference's VelocityStencil/FunctionStencil,
        weno_interpolants.jl:340-354,538-545); ignored by linear schemes.
        ``zbc`` activates halo-free boundary-aware reads along ``axis``.
        Near Bounded walls the order cascades to the buffer scheme
        (reference: topologically_conditional_interpolation.jl)."""
        sc = _ShiftCache(a, axis, zbc)
        scs = ([_ShiftCache(s, axis, zbc) for s in smooth]
               if smooth is not None else None)
        l = self._biased(grid, sc, axis, beta, "left", scs)
        r = self._biased(grid, sc, axis, beta, "right", scs)
        bs = self.buffer_scheme()
        bounded = _axis_bounded(grid, axis)
        imask = _immersed_ok(grid, axis, getattr(self, "buffer", 1))
        if bs is None or (not bounded and imask is None):
            return l, r
        ll, lr = bs.biased_pair(grid, a, axis, beta, smooth=smooth, zbc=zbc)
        if bounded:
            l = _cascade_select(grid, axis, beta, self.buffer, l, ll)
            r = _cascade_select(grid, axis, beta, self.buffer, r, lr)
        if imask is not None:
            l = jnp.where(imask, l, ll)
            r = jnp.where(imask, r, lr)
        return l, r

    def biased(self, grid, a, axis, beta, side, smooth=None, zbc=None):
        scs = ([_ShiftCache(s, axis, zbc) for s in smooth]
               if smooth is not None else None)
        hi = self._biased(grid, _ShiftCache(a, axis, zbc), axis, beta,
                          side, scs)
        return self._cascade(grid, axis, beta, hi,
                             lambda bs: bs.biased(grid, a, axis, beta, side,
                                                  smooth=smooth, zbc=zbc))

    def biased_by(self, grid, a, axis, beta, q, smooth=None, zbc=None):
        hi = self._biased_by_plain(grid, a, axis, beta, q, smooth=smooth,
                                   zbc=zbc)
        if not grid.is_flat(axis) and _is_stretched(grid, axis):
            # the stretched fallback in _biased_by_plain goes through
            # biased_pair, which already applies the boundary/immersed
            # order cascade — wrapping again would re-trace the entire
            # buffer-scheme chain a second time (identical values, ~2×
            # the traced graph; round-5 review finding)
            return hi
        return self._cascade(grid, axis, beta, hi,
                             lambda bs: bs.biased_by(grid, a, axis, beta, q,
                                                     smooth=smooth, zbc=zbc))

    def _biased_by_plain(self, grid, a, axis, beta, q, smooth=None, zbc=None):
        """Upwind reconstruction selected by the sign of ``q``: equals
        ``where(q > 0, biased 'left', biased 'right')`` but computed with ONE
        reconstruction pass over sign-selected stencil cells. The left- and
        right-biased stencils are mirror images sharing the same coefficients
        and smoothness factors, so selecting each cell read first —
        ``where(q > 0, a[shift], a[mirror(shift)])`` — and reconstructing once
        is exact, at ~half the flops (the vector replacement for the
        reference's scalar branchy `upwind_biased_product`,
        upwind_biased_advective_fluxes.jl)."""
        if grid.is_flat(axis):
            return a
        if _is_stretched(grid, axis):
            # nonuniform coefficients are not mirror-symmetric: compute both
            # sides explicitly (stretched axes are usually the short vertical
            # direction, so the extra flops are minor)
            l, r = self.biased_pair(grid, a, axis, beta, smooth=smooth,
                                    zbc=zbc)
            return jnp.where(q > 0, l, r)
        pos = q > 0
        sel = _SelectedShiftCache(a, axis, pos, beta, zbc)
        scs = ([_SelectedShiftCache(s, axis, pos, beta, zbc) for s in smooth]
               if smooth is not None else None)
        return self._biased(grid, sel, axis, beta, "left", scs)


class Centered(AdvectionScheme):
    """Symmetric reconstruction of even order (reference:
    centered_reconstruction.jl)."""

    def __init__(self, order=2):
        if order % 2 != 0:
            raise ValueError("Centered order must be even")
        self.order = order
        self.buffer = order // 2
        self.required_halo = self.buffer
        # symmetric stencil of `order` cells: buffer cells on each side of the
        # interface ⇒ k = order, s = buffer - 1 relative to the left cell
        self._coeffs = eno_coefficients(order, self.buffer - 1)

    def _coeffs_for(self, grid, axis, beta):
        if _is_stretched(grid, axis):
            return _nonuniform_eno(grid, axis, beta, self.order,
                                   self.buffer - 1, False)
        return self._coeffs

    def buffer_scheme(self):
        if self.order <= 2:
            return None
        if not hasattr(self, "_buffer_scheme"):
            self._buffer_scheme = Centered(order=self.order - 2)
        return self._buffer_scheme

    def _symmetric_plain(self, grid, a, axis, beta, zbc=None):
        if grid.is_flat(axis):
            return a
        sc = _ShiftCache(a, axis, zbc)
        shifts = left_shifts(self.order, self.buffer - 1, beta)
        return stencil_value(sc, shifts, self._coeffs_for(grid, axis, beta))

    def symmetric(self, grid, a, axis, beta, zbc=None):
        hi = self._symmetric_plain(grid, a, axis, beta, zbc)
        if grid.is_flat(axis):
            return hi
        return self._cascade(grid, axis, beta, hi,
                             lambda bs: bs.symmetric(grid, a, axis, beta,
                                                     zbc=zbc))

    def _biased(self, grid, sc, axis, beta, side, smooth=None):
        # a centered scheme has no bias: both sides get the symmetric value
        shifts = left_shifts(self.order, self.buffer - 1, beta)
        return stencil_value(sc, shifts, self._coeffs_for(grid, axis, beta))


class UpwindBiased(AdvectionScheme):
    """Odd-order upwind-biased reconstruction (reference:
    upwind_biased_reconstruction.jl)."""

    def __init__(self, order=3):
        if order % 2 != 1:
            raise ValueError("UpwindBiased order must be odd")
        self.order = order
        self.buffer = (order + 1) // 2
        self.required_halo = self.buffer
        # k = order cells with buffer-1 cells strictly upwind of the
        # interface-adjacent cell
        self._s = self.buffer - 1
        self._coeffs = eno_coefficients(order, self._s)
        self.advecting_velocity_scheme = Centered(order=max(order - 1, 2))

    def buffer_scheme(self):
        if self.order <= 1:
            return None
        if not hasattr(self, "_buffer_scheme"):
            self._buffer_scheme = UpwindBiased(order=self.order - 2)
        return self._buffer_scheme

    def symmetric(self, grid, a, axis, beta, zbc=None):
        # the cascade mask uses THIS scheme's buffer and chain (reference:
        # _symmetric_interpolate_* receives the advecting scheme's parent)
        hi = self.advecting_velocity_scheme._symmetric_plain(
            grid, a, axis, beta, zbc)
        if grid.is_flat(axis):
            return hi
        return self._cascade(grid, axis, beta, hi,
                             lambda bs: bs.symmetric(grid, a, axis, beta,
                                                     zbc=zbc))

    def _biased(self, grid, sc, axis, beta, side, smooth=None):
        if grid.is_flat(axis):
            return sc(0)
        stretched = _is_stretched(grid, axis)
        # Parity note (round-5 review): on stretched axes the PER-STENCIL
        # reconstruction coefficients go nonuniform (below) but the optimal
        # weights γ_s stay the uniform table — exactly the reference's
        # behavior (its C★(scheme, Val(s)) in the zweno_alpha_loop is a
        # scheme constant even under WENO(grid=...), weno_interpolants.jl:
        # 289-303). reconstruction.optimal_weights_nonuniform implements
        # the fully-nonuniform γ_s(i) for a future super-reference mode.
        shifts = left_shifts(self.order, self._s, beta)
        if side == "right":
            shifts = mirror(shifts, beta)
            # uniform: mirror symmetry reuses the same coefficients;
            # stretched: derive the mirrored-stencil coefficients exactly
            coeffs = (_nonuniform_eno(grid, axis, beta, self.order, self._s,
                                      True) if stretched else self._coeffs)
        else:
            coeffs = (_nonuniform_eno(grid, axis, beta, self.order, self._s,
                                      False) if stretched else self._coeffs)
        return stencil_value(sc, shifts, coeffs)


class WENO(AdvectionScheme):
    """Weighted ENO of odd order 3–11 (reference: weno_reconstruction.jl,
    weno_interpolants.jl). WENO-Z nonlinear weights (Don & Borges 2013,
    matching the reference's `zweno_alpha_loop`, weno_interpolants.jl:290-335):

        α_s = γ_s · (1 + (τ / (β_s + ε))²),   τ = |Σ_s t_s β_s|

    with smoothness math in ``smoothness_dtype`` (float32 by default — the
    reference's FT2 low-precision inner-weight path, `newton_div(FT2, ...)`).
    ``smooth`` lets the caller measure smoothness on different arrays than the
    reconstructed one (summing per-stencil β over them), which implements the
    reference's VelocityStencil/FunctionStencil used by the vector-invariant
    WENO momentum advection (weno_interpolants.jl:340-354)."""

    def __init__(self, order=5, smoothness_dtype=jnp.float32, bounds=None):
        if order % 2 != 1:
            raise ValueError("WENO order must be odd (3, 5, 7, 9, 11)")
        self.order = order
        self.buffer = k = (order + 1) // 2
        self.required_halo = self.buffer
        self.smoothness_dtype = smoothness_dtype
        # bounds-preserving limiter range (reference: WENO(bounds=(0, 1)),
        # bounds_preserving_tracer_advection_operators.jl) — activates the
        # positivity/bounds limiter in div_Uc
        self.bounds = tuple(float(b) for b in bounds) if bounds is not None \
            else None
        self._gammas = optimal_weights(k)
        self._coeffs = [eno_coefficients(k, s) for s in range(k)]
        self._sfactors = [smoothness_factors(k, s) for s in range(k)]
        self.advecting_velocity_scheme = Centered(order=order - 1)

    def buffer_scheme(self):
        # reference weno_reconstruction.jl:80-91: WENO(order-2), bottoming
        # out at WENO(1) ≡ UpwindBiased(1)
        if not hasattr(self, "_buffer_scheme"):
            if self.order > 3:
                self._buffer_scheme = WENO(
                    order=self.order - 2,
                    smoothness_dtype=self.smoothness_dtype)
            else:
                self._buffer_scheme = UpwindBiased(order=1)
        return self._buffer_scheme

    def _fp(self):
        return (type(self).__name__, self.order, str(self.smoothness_dtype),
                self.bounds)

    def symmetric(self, grid, a, axis, beta, zbc=None):
        hi = self.advecting_velocity_scheme._symmetric_plain(
            grid, a, axis, beta, zbc)
        if grid.is_flat(axis):
            return hi
        return self._cascade(grid, axis, beta, hi,
                             lambda bs: bs.symmetric(grid, a, axis, beta,
                                                     zbc=zbc))

    def _biased(self, grid, sc, axis, beta, side, smooth=None):
        if grid.is_flat(axis):
            return sc(0)
        k = self.buffer
        out_dtype = sc(0).dtype
        stretched = _is_stretched(grid, axis)
        ps, betas = [], []
        for s in range(k):
            shifts = left_shifts(k, s, beta)
            cs = self._coeffs[s]
            if side == "right":
                shifts = mirror(shifts, beta)
                if stretched:
                    cs = _nonuniform_eno(grid, axis, beta, k, s, True)
            elif stretched:
                cs = _nonuniform_eno(grid, axis, beta, k, s, False)
            ps.append(stencil_value(sc, shifts, cs))
            if smooth is None:
                b = smoothness_value(sc, shifts, self._sfactors[s],
                                     compute_dtype=self.smoothness_dtype)
            else:
                b = None
                for scm in smooth:
                    bm = smoothness_value(scm, shifts, self._sfactors[s],
                                          compute_dtype=self.smoothness_dtype)
                    b = bm if b is None else b + bm
            betas.append(b)
        tau = None
        for t, b in zip(TAU_COEFFS[k], betas):
            if t == 0:
                continue
            term = t * b
            tau = term if tau is None else tau + term
        tau = jnp.abs(tau)
        num = None
        den = None
        for s in range(k):
            eps = jnp.asarray(WENO_EPSILON, betas[s].dtype)
            r = tau / (betas[s] + eps)
            # metric-weighted smoothness operands (δ(A·u) ~ 1e5 on
            # earth-scale grids) give β ~ 1e11, so a perfectly-smooth
            # stencil (β = 0, e.g. the still region beside an immersed
            # boundary) yields r = τ/ε ~ 1e19 whose SQUARE overflows the
            # float32 smoothness dtype → inf → inf·0 = NaN. Saturate r
            # before squaring: the weight ratio is already ~saturated at
            # r ≥ 1e6, so this changes no resolvable weight.
            r = jnp.minimum(r, jnp.asarray(1e12, r.dtype))
            alpha = (self._gammas[s] * (1.0 + r * r)).astype(out_dtype)
            nterm = alpha * ps[s]
            num = nterm if num is None else num + nterm
            den = alpha if den is None else den + alpha
        return num / den


def adapt_advection_order(advection, grid):
    """Shrink the advection order per direction to fit small grids
    (reference: src/Advection/adapt_advection_order.jl — a scheme of buffer B
    needs N ≥ B points; otherwise Centered drops to order 2N, upwind/WENO to
    2N-1). Returns a FluxFormAdvection when any direction changed."""
    if advection is None or not isinstance(advection, AdvectionScheme):
        return advection  # VectorInvariant & friends are not adapted

    def adapt_one(scheme, N):
        if N >= scheme.buffer:
            return scheme
        if isinstance(scheme, Centered):
            return Centered(order=max(2, 2 * N))
        if isinstance(scheme, WENO) and 2 * N - 1 >= 3:
            return WENO(order=2 * N - 1,
                        smoothness_dtype=scheme.smoothness_dtype,
                        bounds=scheme.bounds)
        if isinstance(scheme, (WENO, UpwindBiased)):
            return UpwindBiased(order=max(1, 2 * N - 1))
        return scheme

    per_axis = (advection.schemes if isinstance(advection, FluxFormAdvection)
                else (advection,) * 3)
    new = tuple(s if grid.is_flat(ax) else adapt_one(s, grid.N[ax])
                for ax, s in enumerate(per_axis))
    if all(n is o for n, o in zip(new, per_axis)):
        return advection
    return FluxFormAdvection(*new)


class FluxFormAdvection(AdvectionScheme):
    """A different scheme per direction (reference:
    src/Advection/flux_form_advection.jl)."""

    def __init__(self, x, y=None, z=None):
        self.schemes = (x, y if y is not None else x,
                        z if z is not None else x)
        self.order = max(s.order for s in self.schemes)
        self.required_halo = max(s.required_halo for s in self.schemes)
        # propagate the bounds-preserving limiter: without this, wrapping a
        # bounded WENO in FluxFormAdvection (which adapt_advection_order
        # does automatically near small directions) silently dropped the
        # limiter in div_Uc's dispatch (round-5 review finding)
        all_bounds = {getattr(s, "bounds", None) for s in self.schemes}
        all_bounds.discard(None)
        if len(all_bounds) > 1:
            raise ValueError("FluxFormAdvection members declare different "
                             f"bounds: {sorted(all_bounds)}")
        self.bounds = all_bounds.pop() if all_bounds else None

    def _fp(self):
        return ("FluxFormAdvection",) + tuple(s._fp() for s in self.schemes)

    def symmetric(self, grid, a, axis, beta, zbc=None):
        return self.schemes[axis].symmetric(grid, a, axis, beta, zbc)

    def biased_pair(self, grid, a, axis, beta, smooth=None, zbc=None):
        return self.schemes[axis].biased_pair(grid, a, axis, beta, smooth,
                                              zbc)

    def biased(self, grid, a, axis, beta, side, smooth=None, zbc=None):
        return self.schemes[axis].biased(grid, a, axis, beta, side, smooth,
                                         zbc)

    def biased_by(self, grid, a, axis, beta, q, smooth=None, zbc=None):
        return self.schemes[axis].biased_by(grid, a, axis, beta, q, smooth,
                                            zbc)
