"""Krylov solvers (GMRES / BiCGStab / CG) over traceable linear operators.

Reference semantics: src/Solvers/krylov_solver.jl (:101) — a thin wrapper
around Krylov.jl's gmres/cg with a generic linear-operator callback and
optional preconditioner. Design: `jax.scipy.sparse.linalg` provides
matrix-free GMRES/BiCGStab/CG that trace into the jitted step (restarted
GMRES runs as lax control flow, no host iteration)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.sparse import linalg as jsla


class KrylovSolver:
    """Matrix-free Krylov solver.

    Parameters
    ----------
    linear_operator : callable(x) -> Ax on pytrees/arrays (traceable)
    method : "gmres" | "bicgstab" | "cg"
    preconditioner : callable(r) -> approx A⁻¹r, or None
    reltol, maxiter, restart : standard Krylov knobs
    """

    def __init__(self, linear_operator, method="gmres", preconditioner=None,
                 reltol=1e-7, abstol=0.0, maxiter=100, restart=20):
        if method not in ("gmres", "bicgstab", "cg"):
            raise ValueError(f"unknown Krylov method {method!r} "
                             "(gmres, bicgstab, cg)")
        self.A = linear_operator
        self.method = method
        self.M = preconditioner
        self.reltol = float(reltol)
        self.abstol = float(abstol)
        self.maxiter = int(maxiter)
        self.restart = int(restart)

    def solve(self, b, x0=None):
        kw = dict(tol=self.reltol, atol=self.abstol, maxiter=self.maxiter)
        if self.M is not None:
            kw["M"] = self.M
        if self.method == "gmres":
            x, _ = jsla.gmres(self.A, b, x0=x0, restart=self.restart, **kw)
        elif self.method == "bicgstab":
            x, _ = jsla.bicgstab(self.A, b, x0=x0, **kw)
        else:
            x, _ = jsla.cg(self.A, b, x0=x0, **kw)
        return x
