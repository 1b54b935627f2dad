"""Every decision that depends on the machine JAX runs on.

The models are plain ``jax.numpy``/``lax`` programs and run unchanged on the
CPU and on the GPU; the few places where the backend changes what the code
does are answered here, and nowhere else:

* :func:`use_matmul_dft` — Fourier transforms as dense matmuls (CPU) or as
  XLA's FFT (GPU);
* :func:`cubed_sphere_exchange` — which of the bitwise-equal cubed-sphere
  halo exchanges a model builds;
* :func:`require_gpu` — the guard of every measurement script;
* :func:`configure_compilation_cache` — where compiled programs persist.
"""

from __future__ import annotations

import os

import jax

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def backend():
    """JAX's default backend: ``"cpu"`` or ``"gpu"``."""
    return jax.default_backend()


def require_gpu():
    """Return ``jax.devices()`` when they are GPUs; raise otherwise.

    Measurement scripts call this first: a time taken on the CPU is not a
    device number, so there is no fallback."""
    devices = jax.devices()
    platform = devices[0].platform
    if platform != "gpu":
        raise RuntimeError(
            f"a GPU is required; JAX found platform {platform!r} "
            f"({devices[0].device_kind}, {len(devices)} device(s))")
    return devices


def use_matmul_dft():
    """Fourier transforms as dense matmuls instead of ``jnp.fft``.

    Only on the CPU: XLA:CPU's FFT thunk rejects the non-major-to-minor
    layouts that SPMD partitioning produces, and a matmul partitions
    cleanly. The GPU uses cuFFT through ``jnp.fft``."""
    return backend() == "cpu"


def cubed_sphere_exchange():
    """The cubed-sphere halo exchange to build (all variants are bitwise
    equal; grids/cubed_sphere.py). On the CPU the single-gather maps keep
    the XLA graph, and so the compile time, small; elsewhere the
    concat-assembled strips avoid irregular row gathers. The GPU choice is
    not yet measured against the alternatives."""
    return "gather" if backend() == "cpu" else "concat"


def configure_compilation_cache():
    """Turn on JAX's persistent compilation cache; return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set JAX has already read it, and
    nothing is set here. Otherwise the cache goes to ``<repo>/.jax_cache``
    and every compiled program is kept, however small or quick. The path is
    part of the cache key, so it is fixed: never a temporary name, a
    process id or a time."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    path = os.path.join(REPO_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path
