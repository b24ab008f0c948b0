"""
bodge_tpu: block-sparse tight-binding framework for superconductors in JAX.

A from-scratch JAX/XLA implementation with the capability set of the
`bodge` package (real-space Bogoliubov-de Gennes Hamiltonians in
Lattice⊗Nambu⊗Spin space): coordinate-addressed assembly with automatic
particle-hole/Hermitian symmetry fill, dense diagonalization, free energy,
and local density of states — plus an accelerator tier the reference does
not have: stencil/ELL block-sparse SpMM, Chebyshev/KPM spectral expansion,
and multi-device row partitioning with halo-exchange collectives.  The
device path is plain complex XLA, run on a GPU or the CPU.

Public API parity: the 30 names of ``bodge/__init__.py:13-51`` plus the
accelerator extensions.
"""

import os as _os

# The persistent compile cache's default home: one fixed directory inside
# the checkout.  The path is part of the cache key, so a directory that
# moves between runs never hits.
DEFAULT_COMPILE_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".jax_cache"
)


def _enable_persistent_compile_cache():
    """Persist XLA executables across processes, on every platform: in
    ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads that variable
    itself), else in :data:`DEFAULT_COMPILE_CACHE_DIR`."""
    import jax

    if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_COMPILE_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)


_enable_persistent_compile_cache()

from .common import (
    Coord,
    Coords,
    Index,
    Indices,
    jsigma,
    jsigma0,
    jsigma1,
    jsigma2,
    jsigma3,
    jσ,
    jσ0,
    jσ1,
    jσ2,
    jσ3,
    pi,
    sigma,
    sigma0,
    sigma1,
    sigma2,
    sigma3,
    π,
    σ,
    σ0,
    σ1,
    σ2,
    σ3,
)
from .hamiltonian import Hamiltonian
from .lattice import CubicLattice, Lattice
from .models.order_parameters import dwave, pwave, ssd, swave

__version__ = "0.1.0"
__all__ = [
    # Core library (parity with bodge).
    "Lattice",
    "CubicLattice",
    "Hamiltonian",
    "Coord",
    "Coords",
    "Index",
    "Indices",
    # Helper functions.
    "ssd",
    "swave",
    "pwave",
    "dwave",
    # Constants.
    "π",
    "σ",
    "σ0",
    "σ1",
    "σ2",
    "σ3",
    "jσ",
    "jσ0",
    "jσ1",
    "jσ2",
    "jσ3",
    # ASCII alternatives.
    "pi",
    "sigma",
    "sigma0",
    "sigma1",
    "sigma2",
    "sigma3",
    "jsigma",
    "jsigma0",
    "jsigma1",
    "jsigma2",
    "jsigma3",
]
