"""Global eddying ocean on the conformal cubed sphere — the flagship
configuration: WENO-VI momentum, WENO tracers, CATKE boundary-layer mixing +
GM/Redi triads, split-explicit free surface, wind stress + surface buoyancy
flux, and GridFittedBottom bathymetry, all on the 6-panel conformal cubed
sphere (reference analogue: the full HydrostaticFreeSurfaceModel on a
MultiRegion ConformalCubedSphereGrid, src/MultiRegion/multi_region_models.jl
— the same capability set, polar-singularity-free).

Run: python examples/global_cubed_sphere_ocean.py  [N] [hours]
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from oceananigans_tpu.platform import backend

ON_CPU = backend() == "cpu"
if ON_CPU:
    jax.config.update("jax_enable_x64", True)

from oceananigans_tpu.advection import WENO
from oceananigans_tpu.advection.vector_invariant import WENOVectorInvariant
from oceananigans_tpu.boundary_conditions import (BoundaryCondition,
                                                  FieldBoundaryConditions)
from oceananigans_tpu.boundary_conditions.boundary_condition import FLUX
from oceananigans_tpu.buoyancy import BuoyancyTracer
from oceananigans_tpu.closures import (CATKEVerticalDiffusivity,
                                       ClosureTuple,
                                       TriadIsopycnalSkewSymmetricDiffusivity)
from oceananigans_tpu.grids.cubed_sphere import ConformalCubedSphereGrid
from oceananigans_tpu.models import CubedSphereHydrostaticModel


def main(N=24, nz=12, hours=24.0, out=None):
    R, OMEGA, G, H0, U = 6.371e6, 7.292e-5, 9.81, 3000.0, 5.0

    grid = ConformalCubedSphereGrid((N, N, nz), z=(-H0, 0.0), radius=R,
                                    halo=4,
                                    dtype=jnp.float64 if ON_CPU
                                    else jnp.float32)

    # idealized continent + mid-ocean ridge bathymetry
    def bottom(lam, phi):
        continent = 2800.0 * np.exp(-((lam - 1.2) ** 2
                                      + (phi - 0.3) ** 2) / 0.18)
        ridge = 1200.0 * np.exp(-(lam + 1.8) ** 2 / 0.05)
        return -H0 + continent + ridge

    # zonal wind stress (easterlies/westerlies) + differential heating
    def wind_stress(lam, phi, t):
        return -1e-4 * np.cos(3.0 * phi)

    def buoyancy_flux(lam, phi, t):
        return 3e-9 * np.cos(phi)           # heating at the equator

    closure = ClosureTuple(
        CATKEVerticalDiffusivity(buoyancy=BuoyancyTracer()),
        TriadIsopycnalSkewSymmetricDiffusivity(
            kappa_skew=1000.0, kappa_symmetric=1000.0,
            buoyancy=BuoyancyTracer()))

    model = CubedSphereHydrostaticModel(
        grid, tracers=("b", "c"), rotation_rate=OMEGA, gravity=G,
        momentum_advection=WENOVectorInvariant(order=5),
        tracer_advection=WENO(5),
        closure=closure,
        bottom_height=bottom,
        free_surface="split_explicit", substeps=20,
        boundary_conditions={
            "u": FieldBoundaryConditions(top=BoundaryCondition(
                FLUX, wind_stress)),
            "b": FieldBoundaryConditions(top=BoundaryCondition(
                FLUX, buoyancy_flux))})

    # balanced barotropic jet + geostrophic surface displacement
    model.set_geographic(u_east=lambda lam, phi: U * np.cos(phi),
                         v_north=lambda lam, phi: 0.0 * lam)
    model.set(eta=lambda lam, phi: -(R * OMEGA * U + 0.5 * U * U)
              * np.sin(phi) ** 2 / G,
              # stratification + a mid-depth warm anomaly over a panel edge
              b=lambda lam, phi, z: 1e-5 * z + 2e-4
              * np.exp(-((lam - np.pi / 4) ** 2 + phi ** 2) / 0.1)
              * np.exp(-((z + H0 / 2) / (H0 / 4)) ** 2),
              # passive tracer blob for transport visualization
              c=lambda lam, phi, z: np.exp(-((lam + np.pi / 2) ** 2
                                             + phi ** 2) / 0.15))

    # advective/baroclinic time step (the barotropic mode is subcycled)
    dx_min = 2 * np.pi * R / (4 * N) * 0.6
    dt = min(0.02 * dx_min / U, 1200.0)
    steps = max(2, int(hours * 3600 / dt))
    c0 = model.total_tracer("c")
    print(f"global cubed-sphere ocean: 6x{N}x{N}x{nz} cells, "
          f"WENO-VI + CATKE + GM triads + split-explicit, dt = {dt:.0f} s, "
          f"{steps} steps")

    for k in range(steps):
        model.time_step(dt)
        if (k + 1) % max(1, steps // 10) == 0:
            u = np.asarray(model.field("u").interior)
            e = np.asarray(model.field("e").interior)
            print(f"t = {model.time / 3600:6.1f} h"
                  f"  |u|max = {np.abs(u).max():.3f}"
                  f"  TKEmax = {e.max():.2e}"
                  f"  tracer drift = "
                  f"{abs(model.total_tracer('c') - c0) / c0:.2e}")

    if out is None:
        out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "global_cubed_sphere_ocean_out")
    os.makedirs(out, exist_ok=True)
    np.save(os.path.join(out, "c_final.npy"),
            np.asarray(model.field("c").interior))
    np.save(os.path.join(out, "eta_final.npy"),
            np.asarray(model.field("eta").interior))
    print("saved final tracer/eta panel arrays to", out)


if __name__ == "__main__":
    main(N=int(sys.argv[1]) if len(sys.argv) > 1 else 24,
         hours=float(sys.argv[2]) if len(sys.argv) > 2 else 24.0)
