"""oceananigans_tpu — a JAX/XLA rebuild of the
capabilities of Oceananigans.jl.

Layer map (mirrors SURVEY.md §1; reference: src/Oceananigans.jl:226-271):

    grids/                 L1  topology, coordinates, metrics, halos
    operators/             L2  finite-volume stencil micro-ops
    boundary_conditions/   L3  BC types + halo filling
    fields/                L4  Field wrapper, set, reductions
    timesteppers/          L6  Clock, RK3 / quasi-AB2
    advection/             L6  Centered / UpwindBiased / WENO / VectorInvariant
    solvers/               L6  FFT/DCT Poisson, batched tridiagonal, CG
    closures/              L9  ScalarDiffusivity, Smagorinsky, AMD, CATKE, …
    parallel/              L7  device mesh, shard_map halo exchange, pencil FFT
    models/                L10 Nonhydrostatic / HydrostaticFreeSurface / ShallowWater
    simulation/            L8  run loop, callbacks, output, checkpointing

The top-level namespace is FLAT, mirroring the reference's export list
(src/Oceananigans.jl:7-118) so that ``using Oceananigans`` scripts port as
``from oceananigans_tpu import ...`` with the same names."""

from .defaults import defaults

# -- Architectures (reference: CPU, GPU — placement markers; JAX owns
# devices. Distributed/Partition are the mesh architecture) -------------------
from .parallel import (CPU, GPU, Distributed, Partition, Equal,
                       Fractional, Sizes, XPartition, YPartition,
                       CubedSpherePartition)

# -- Grids ---------------------------------------------------------------------
from .grids import (RectilinearGrid, LatitudeLongitudeGrid,
                    OrthogonalSphericalShellGrid,
                    RotatedLatitudeLongitudeGrid, TripolarGrid,
                    ConformalCubedSphereGrid, ConformalCubedSpherePanel,
                    ExponentialDiscretization, PowerLawStretching,
                    LinearStretching, ReferenceToStretchedDiscretization,
                    PERIODIC, BOUNDED, FLAT, CENTER, FACE)


def Center():
    """Location marker (reference: Center). Locations here are the strings
    "c"/"f"; ``Center()`` returns "c" so ``xnodes(grid, Center())`` ports."""
    return CENTER


def Face():
    return FACE


def Periodic():
    return PERIODIC


def Bounded():
    return BOUNDED


def Flat():
    return FLAT


# -- Immersed boundaries --------------------------------------------------------
from .immersed import (ImmersedBoundaryGrid, GridFittedBottom,
                       GridFittedBoundary, PartialCellBottom)

# -- Advection -------------------------------------------------------------------
from .advection import (Centered, UpwindBiased, WENO, VectorInvariant,
                        WENOVectorInvariant, FluxFormAdvection,
                        cell_advection_timescale)

# -- Boundary conditions ----------------------------------------------------------
from .boundary_conditions import (
    BoundaryCondition, FieldBoundaryConditions, FluxBoundaryCondition,
    ValueBoundaryCondition, GradientBoundaryCondition, OpenBoundaryCondition,
    FieldTimeSeriesBoundaryCondition, fill_halo_regions)
from .boundary_conditions.boundary_condition import (ImmersedBoundaryCondition,
                                                     PerturbationAdvection)

# -- Fields and field manipulation ------------------------------------------------
from .fields import (Field, CenterField, XFaceField, YFaceField, ZFaceField,
                     VelocityFields, TracerFields,
                     FunctionField, ConstantField, ZeroField, OneField,
                     GridMetricOperation, interpolate)
from .fields.regridding import regrid_field as regrid
from .background_fields import BackgroundField

# -- AbstractOperations -------------------------------------------------------------
from .abstract_operations import (Average, Integral, CumulativeIntegral,
                                  Reduction, Accumulation,
                                  KernelFunctionOperation,
                                  ConditionalOperation, conditional_length,
                                  at, partial_x, partial_y, partial_z,
                                  Derivative)

# -- Forcings -------------------------------------------------------------------------
from .forcings import (Forcing, Relaxation, LinearTarget, GaussianMask,
                       PiecewiseLinearMask, AdvectiveForcing, MultipleForcings)

# -- Coriolis ---------------------------------------------------------------------------
from .coriolis import (FPlane, ConstantCartesianCoriolis, BetaPlane,
                       NonTraditionalBetaPlane, HydrostaticSphericalCoriolis)

# -- Buoyancy / equations of state --------------------------------------------------------
from .buoyancy import (BuoyancyForce, BuoyancyTracer, SeawaterBuoyancy,
                       LinearEquationOfState, TEOS10EquationOfState,
                       RoquetSecondOrderEquationOfState,
                       seawater_density)

TEOS10 = TEOS10EquationOfState

# -- Stokes drift ---------------------------------------------------------------------------
from .stokes_drift import UniformStokesDrift, StokesDrift

# -- Turbulence closures -----------------------------------------------------------------------
from .closures import (
    ScalarDiffusivity, VerticalScalarDiffusivity, HorizontalScalarDiffusivity,
    ScalarBiharmonicDiffusivity, VerticalScalarBiharmonicDiffusivity,
    HorizontalScalarBiharmonicDiffusivity, Smagorinsky, SmagorinskyLilly,
    LillyCoefficient, DynamicCoefficient, AnisotropicMinimumDissipation,
    ConvectiveAdjustmentVerticalDiffusivity, CATKEVerticalDiffusivity,
    TKEDissipationVerticalDiffusivity, RiBasedVerticalDiffusivity,
    IsopycnalSkewSymmetricDiffusivity, TriadIsopycnalSkewSymmetricDiffusivity,
    TwoDimensionalLeith, VerticallyImplicitTimeDiscretization,
    ExplicitTimeDiscretization, viscosity, diffusivity)

# -- Lagrangian particles ---------------------------------------------------------------------
from .particles import LagrangianParticles, DroguedParticleDynamics

# -- Models -------------------------------------------------------------------------------------
from .models import (NonhydrostaticModel, HydrostaticFreeSurfaceModel,
                     ShallowWaterModel, CubedSphereShallowWaterModel,
                     CubedSphereHydrostaticModel, EnsembleModel,
                     ExplicitFreeSurface, ImplicitFreeSurface,
                     SplitExplicitFreeSurface,
                     ForcingOperation, ForcingField,
                     BoundaryConditionOperation, BoundaryConditionField,
                     BoundaryAdjacentMean)
from .models.diagnostic_operations import BuoyancyField, PressureField
from .models.hydrostatic import (PrescribedVelocityFields, ZCoordinate,
                                 ZStarCoordinate)
from .models.shallow_water import (ConservativeFormulation,
                                   VectorInvariantFormulation)

# -- Time stepping --------------------------------------------------------------------------------
from .timesteppers import (Clock, RungeKutta3TimeStepper,
                           QuasiAdamsBashforth2TimeStepper,
                           SplitRungeKutta3TimeStepper)

# -- Simulations / diagnostics / output -------------------------------------------------------------
from .logger import setup_logger as OceananigansLogger
from .simulation import Simulation, Callback, NaNChecker
from .simulation.callsites import (TimeStepCallsite, TendencyCallsite,
                                   UpdateStateCallsite)
from .simulation.diagnostics import (CFL, AdvectiveCFL, DiffusiveCFL,
                                     StateChecker, TimeStepWizard,
                                     conjure_time_step_wizard)
from .simulation.output_writers import (FieldWriter, AveragedTimeInterval,
                                        WindowedTimeAverage)
from .simulation.netcdf_writer import NetCDFWriter
from .simulation.netcdf4_writer import NetCDF4Writer
# the reference's user-facing name; the NetCDF4 (HDF5) writer is the
# full-featured one (attributes, units, append-on-pickup, windowed dims —
# ext/OceananigansNCDatasetsExt.jl); NetCDFWriter remains the NetCDF-3
# classic fallback
NetCDFOutputWriter = NetCDF4Writer
from .simulation.checkpointer import (Checkpointer, checkpoint_grid)
from .simulation.output_readers import (FieldTimeSeries, FieldDataset,
                                        InMemory, OnDisk, written_names)

# the reference's JLD2Writer == the native self-describing snapshot writer
JLD2Writer = FieldWriter

try:                                     # optional: needs h5py
    from .simulation.hdf5_writer import HDF5Writer
except Exception:                        # pragma: no cover
    HDF5Writer = None

# -- Schedules / utils ---------------------------------------------------------------------------------
from .utils.schedules import (TimeInterval, IterationInterval,
                              WallTimeInterval, SpecifiedTimes, FileSizeLimit,
                              AndSchedule, OrSchedule)
from .utils.pretty import (prettytime, second, seconds, minute, minutes, hour,
                           hours, day, days, year, meter, meters, kilometer,
                           kilometers,
                           KiB, MiB, GiB, TiB)

# -- Free-function API (nodes/spacings/interior/compute/time_step/run …) --------------------------------
from .api import (nodes, xnodes, ynodes, znodes, rnodes, lambda_nodes,
                  phi_nodes, xspacings, yspacings, zspacings, rspacings,
                  lambda_spacings, phi_spacings, lambda_spacing, phi_spacing,
                  minimum_xspacing, minimum_yspacing, minimum_zspacing,
                  xspacing, yspacing, zspacing, xarea, yarea, zarea, volume,
                  interior, compute, time_step, run, iteration,
                  set,
                  iteration_limit_exceeded, stop_time_exceeded,
                  wall_time_limit_exceeded)

# Unicode spellings of the reference's curvilinear-grid exports (λnodes,
# φnodes, λspacings, φspacings — src/Oceananigans.jl export list); λ and φ
# are valid Python identifiers, so reference scripts port verbatim.
λnodes = lambda_nodes
φnodes = phi_nodes
λspacings = lambda_spacings
φspacings = phi_spacings
λspacing = lambda_spacing
φspacing = phi_spacing

__version__ = "0.2.0"
