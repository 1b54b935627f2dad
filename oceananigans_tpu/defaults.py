"""Global defaults, mirroring the reference's ``Oceananigans.defaults`` /
``Oceananigans.Defaults`` module (reference: src/Oceananigans.jl:150-173).

The reference keeps a globally mutable set of defaults (FloatType, gravitational
acceleration, planet radius/rotation rate). We keep the same constructor-kwargs
philosophy: everything is overridable per-object; these are just the fallbacks.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp


@dataclasses.dataclass
class Defaults:
    # Default element type for grids/fields. float32 is the fast choice on
    # accelerators; set to jnp.float64 (with jax_enable_x64) for
    # reference-grade precision.
    FloatType: type = jnp.float32

    # Mean gravitational acceleration at Earth's surface [m/s²]
    # (reference: src/Oceananigans.jl:160, g_Earth).
    gravitational_acceleration: float = 9.80665

    # Earth radius [m] (reference: R_Earth).
    planet_radius: float = 6_371_000.0

    # Earth rotation rate [s⁻¹] (reference: Ω_Earth).
    rotation_rate: float = 7.292115e-5


defaults = Defaults()
