"""Distributed architecture: device meshes and domain decomposition.

Reference semantics: src/DistributedComputations/distributed_architectures.jl
— `Partition{Sx,Sy,Sz}` rank layouts (:14-18) and the `Distributed`
architecture (:166-302) that owns the communicator.

Design: there is no MPI. The "communicator" is a ``jax.sharding.Mesh`` over
the devices with axes ("x", "y") — spatial domain decomposition in the
horizontal (SURVEY.md §5). The model state (halo-padded global arrays) is
placed with ``NamedSharding(mesh, P("x", "y", None))`` and the jitted step
runs unchanged: XLA's GSPMD partitioner splits every stencil and inserts the
halo collectives itself, for every topology. This mirrors the reference's
Reactant/sharded-grids path
(ext/OceananigansReactantExt/Grids/sharded_grids.jl:20-56). The pencil
Poisson solvers (parallel/pencil_fft.py) are the one explicit ``shard_map``
path. The mesh shape follows the device count alone: the GPUs of one host
are joined all to all, so no axis order is preferred."""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


class CPU:
    """Single-device architecture marker (reference: src/Architectures.jl:35).

    Placement is JAX's job here — models accept ``architecture=CPU()`` for
    reference-script compatibility and treat it as the default single-device
    configuration (run under JAX_PLATFORMS=cpu to actually pin the host)."""

    mesh = None

    def __repr__(self):
        return "CPU()"


class GPU(CPU):
    """Single-accelerator architecture marker (reference:
    src/Architectures.jl:44). A no-op under JAX: the default backend is
    already the accelerator; kept so reference scripts port."""

    def __repr__(self):
        return "GPU()"


class Equal:
    """Equal split along a direction (reference: distributed_architectures.jl
    Equal) — ``Partition(x=Equal(), y=2)`` divides x over whatever device
    count remains. Under GSPMD every split is equal by construction, so
    this is the only split kind that shards."""

    def __repr__(self):
        return "Equal()"


class Fractional:
    """Uneven fractional split (reference: Fractional(ϵ₁, ϵ₂, …)). An MPI
    load-balancing concept: XLA's GSPMD partitioner shards arrays in equal
    tiles over identical devices — raises with that explanation rather than
    silently equalizing."""

    def __init__(self, *fractions):
        raise NotImplementedError(
            "Fractional partitions are an MPI load-balancing device; under "
            "GSPMD all shards are equal tiles on identical devices. "
            "Use Partition(x=<int>) or Partition(x=Equal()).")


class Sizes:
    """Explicit per-rank sizes (reference: Sizes(n₁, n₂, …)); see
    :class:`Fractional` for why this does not exist on device meshes."""

    def __init__(self, *sizes):
        raise NotImplementedError(
            "Sizes partitions are an MPI load-balancing device; under GSPMD "
            "all shards are equal tiles on identical devices. "
            "Use Partition(x=<int>) or Partition(x=Equal()).")


def XPartition(n):
    """Reference-API alias (MultiRegion XPartition(n) — splitting a grid
    into n x-slabs across devices): the GSPMD equivalent is a device-mesh
    Partition along x."""
    return Partition(x=int(n))


def YPartition(n):
    """MultiRegion YPartition(n) analogue — see :func:`XPartition`."""
    return Partition(y=int(n))


def CubedSpherePartition(*args, **kw):
    """The reference's MultiRegion cubed-sphere panel distribution. Under
    GSPMD the cubed-sphere models shard their (6, nx, ny, nz) panel-batched
    state over the mesh directly (pass ``architecture=Distributed(...)`` to
    the CubedSphere models), so there is no separate partition object."""
    raise NotImplementedError(
        "CubedSpherePartition is a MultiRegion (explicit per-device region)"
        " concept; the GSPMD path shards the panel-batched cubed-sphere "
        "state instead — construct the model with architecture="
        "Distributed(...) (see docs/design.md).")


class Partition:
    """Rank layout (reference: Partition{Sx,Sy,Sz}). ``x``/``y`` are the
    number of shards along each horizontal direction (an int, or ``Equal()``
    to divide the remaining devices); z is never sharded (vertical solves
    and integrals stay chip-local)."""

    def __init__(self, x=1, y=1):
        self._equal_axis = None
        if isinstance(x, Equal):
            self._equal_axis, x = 0, 0
        if isinstance(y, Equal):
            if self._equal_axis is not None:
                raise ValueError("only one direction may be Equal()")
            self._equal_axis, y = 1, 0
        self.x = int(x)
        self.y = int(y)

    def resolve(self, n_devices):
        """Fill an ``Equal()`` direction from the device count."""
        if self._equal_axis is None:
            return self
        other = self.y if self._equal_axis == 0 else self.x
        other = max(other, 1)
        if n_devices % other:
            raise ValueError(f"{n_devices} devices do not divide over "
                             f"Partition with fixed factor {other}")
        p = Partition(x=self.x or 1, y=self.y or 1)
        if self._equal_axis == 0:
            p.x = n_devices // other
        else:
            p.y = n_devices // other
        return p

    def __repr__(self):
        return f"Partition(x={self.x}, y={self.y})"


class Distributed:
    """Device-mesh architecture.

    Usage::

        arch = Distributed(Partition(x=2, y=4))          # 8 devices
        state = arch.shard(model.state)                  # place on the mesh
        model.state = state                              # step as usual
    """

    def __init__(self, partition=None, devices=None):
        if devices is None:
            devices = jax.devices()
        n = len(devices)
        if partition is None:
            px = int(np.floor(np.sqrt(n)))
            while n % px:
                px -= 1
            partition = Partition(px, n // px)
        partition = partition.resolve(n)
        need = partition.x * partition.y
        if need > n:
            raise ValueError(f"partition {partition} needs {need} devices, "
                             f"have {n}")
        self.partition = partition
        dev_array = np.asarray(devices[:need]).reshape(partition.x,
                                                       partition.y)
        self.mesh = Mesh(dev_array, ("x", "y"))

    def sharding(self, leaf):
        if hasattr(leaf, "ndim") and leaf.ndim == 3:
            return NamedSharding(self.mesh, P("x", "y", None))
        return NamedSharding(self.mesh, P())

    def shard(self, tree):
        """Place a state pytree on the mesh (3D padded arrays split over
        (x, y); scalars replicated)."""
        return jax.tree.map(
            lambda leaf: jax.device_put(leaf, self.sharding(leaf)), tree)

    def validate_grid(self, grid):
        """Padded extents must divide the mesh (GSPMD NamedSharding
        constraint). Reference analogue: the Ny%Rx divisibility constraints
        of the distributed FFT (distributed_fft_based_poisson_solver.jl:80-91)."""
        px, py = self.partition.x, self.partition.y
        sx, sy = grid.padded_shape[0], grid.padded_shape[1]
        if sx % px or sy % py:
            raise ValueError(
                f"padded shape ({sx}, {sy}) not divisible by partition "
                f"({px}, {py}); choose N so that N + 2·halo divides the mesh")
