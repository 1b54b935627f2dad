"""Time steppers: 3rd-order Runge-Kutta (Le & Moin 1991) and quasi-Adams-
Bashforth-2.

Reference semantics: src/TimeSteppers/runge_kutta_3.jl (γ¹=8/15, γ²=5/12,
γ³=3/4, ζ²=-17/60, ζ³=-5/12; substep Uᵐ⁺¹ = Uᵐ + Δt(γᵐGᵐ + ζᵐGᵐ⁻¹) with a
pressure correction per substep) and quasi_adams_bashforth_2.jl
(Uⁿ⁺¹ = Uⁿ + Δt[(3/2+χ)Gⁿ - (1/2+χ)Gⁿ⁻¹]; χ = -0.5 reduces to forward Euler,
used on the first step and after Δt changes).

Design: a stepper is pure configuration. The model builds ONE jitted
``step(state, dt) -> state`` closing over it; the RK3 substep loop is unrolled
at trace time (3 fused stages), and AB2's Euler fallback is a traced
``jnp.where`` on the iteration counter rather than host control flow
(the Reactant extension charts the same rewrite —
ext/OceananigansReactantExt/TimeSteppers.jl:55-137)."""

from __future__ import annotations

RK3_GAMMAS = (8.0 / 15.0, 5.0 / 12.0, 3.0 / 4.0)
RK3_ZETAS = (0.0, -17.0 / 60.0, -5.0 / 12.0)


class RungeKutta3TimeStepper:
    name = "RungeKutta3"
    n_stages = 3
    needs_previous_tendencies = False  # ζ¹ = 0: G⁻ never crosses a time step

    def _fp(self):
        return ("RungeKutta3",)

    def __hash__(self):
        return hash(self._fp())

    def __eq__(self, o):
        return hasattr(o, "_fp") and self._fp() == o._fp()


class QuasiAdamsBashforth2TimeStepper:
    name = "QuasiAdamsBashforth2"
    n_stages = 1
    needs_previous_tendencies = True

    def __init__(self, chi=0.1):
        self.chi = float(chi)

    def _fp(self):
        return ("QuasiAdamsBashforth2", self.chi)

    __hash__ = RungeKutta3TimeStepper.__hash__
    __eq__ = RungeKutta3TimeStepper.__eq__


class SplitRungeKutta3TimeStepper:
    """Knoth & Wensch (2014) split RK3: each stage is an Euler step from the
    CACHED step-start state with Δt/βᵐ, β = (3, 2, 1) (reference:
    src/TimeSteppers/split_hydrostatic_runge_kutta_3.jl)."""

    name = "SplitRungeKutta3"
    n_stages = 3
    needs_previous_tendencies = False
    betas = (3.0, 2.0, 1.0)

    def _fp(self):
        return ("SplitRungeKutta3",)

    __hash__ = RungeKutta3TimeStepper.__hash__
    __eq__ = RungeKutta3TimeStepper.__eq__


def Clock(time=0.0, iteration=0, last_dt=None, dtype=None):
    """Build a clock state-pytree entry (reference: src/TimeSteppers/clock.jl
    Clock(time=..., iteration=...)). The clock here is traced data inside the
    model's state pytree rather than a mutable struct; this constructor gives
    reference users the familiar entry point:

        model.state["clock"] = Clock(time=30.0, iteration=5)

    ``last_dt`` defaults to +inf, which makes a QuasiAdamsBashforth2 stepper
    take its Euler first step (the reference's convention)."""
    import jax.numpy as jnp
    import numpy as np
    dtype = dtype or (np.float64 if jnp.zeros(()).dtype == jnp.float64
                      else np.float32)
    return dict(time=jnp.asarray(time, dtype),
                iteration=jnp.asarray(iteration, jnp.int32),
                last_dt=jnp.asarray(np.inf if last_dt is None else last_dt,
                                    dtype))
