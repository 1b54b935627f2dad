from .distributed import (CPU, GPU, Distributed, Partition,
                          Equal, Fractional, Sizes,
                          XPartition, YPartition, CubedSpherePartition)
from .pencil_fft import (DistributedFFTPoissonSolver,
                         DistributedFourierTridiagonalPoissonSolver)

__all__ = ["CPU", "GPU", "Distributed", "Partition",
           "Equal", "Fractional", "Sizes",
           "XPartition", "YPartition", "CubedSpherePartition",
           "DistributedFFTPoissonSolver",
           "DistributedFourierTridiagonalPoissonSolver"]
