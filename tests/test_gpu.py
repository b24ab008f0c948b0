"""Tests that need the card (marker ``gpu``; they skip on the CPU).

Run them on a machine with an NVIDIA GPU:

    JAX_PLATFORMS=cuda python -m pytest tests/test_gpu.py -m gpu -q
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bodge_tpu import CubicLattice, Hamiltonian, jσ2, σ0, σ1, σ3
from bodge_tpu.ops import chebyshev as kpm
from bodge_tpu.ops import dense as dense_ops
from bodge_tpu.ops.spmm import spmm_gather, spmm_stencil

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's default device is {device.platform}")
    return device


def random_system(shape, seed):
    """Random Hermitian complex64 BdG operator with complex hopping and
    on-site and bond singlet pairing, periodic along every axis."""
    lattice = CubicLattice(shape)
    system = Hamiltonian(lattice, dtype=np.complex64)
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(lattice.size, 1, 1))
    system.assemble(
        onsite=lambda ci: a * σ0 + 0.3 * a * σ3 + 0.2 * σ1,
        pairing_onsite=lambda ci: 0.4 * jσ2,
        hopping=lambda ci, cj: -np.exp(0.3j * (cj - ci)[:, 0])[:, None, None] * σ0,
        pairing=lambda ci, cj: 0.15 * jσ2,
    )
    return lattice, system


def random_probes(N, K, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(N, 4, K)) + 1j * rng.normal(size=(N, 4, K))).astype(np.complex64)


@pytest.mark.parametrize("impl", ["stencil", "gather"])
def test_complex64_spmm_keeps_float32_precision(gpu, impl):
    """complex64 block products on the card agree with a float64 SciPy
    product to float32 rounding; TF32 would leave ~1e-3 relative error."""
    lattice, system = random_system((32, 32, 2), seed=1)
    N = lattice.size
    v = random_probes(N, 4, seed=0)
    want = (system.matrix("csr").astype(np.complex128)
            @ v.astype(np.complex128).reshape(4 * N, 4)).reshape(N, 4, 4)
    fn = spmm_stencil if impl == "stencil" else spmm_gather
    got = np.asarray(fn(jnp.asarray(system.data), system.skeleton, jnp.asarray(v)))
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-6


def test_complex64_moments_track_float64_recursion(gpu):
    lattice, system = random_system((32, 32, 1), seed=2)
    N = lattice.size
    v0 = random_probes(N, 4, seed=1)
    csr = system.matrix("csr").astype(np.complex128)
    scale = 1.05 * kpm.spectral_bound(system.data, system.skeleton)
    V0 = v0.reshape(4 * N, 4).astype(np.complex128)
    t_prev, t_cur = V0, (csr @ V0) / scale
    want = [np.real(np.sum(np.conj(V0) * t_prev, axis=0)), np.real(np.sum(np.conj(V0) * t_cur, axis=0))]
    for _ in range(254):
        t_prev, t_cur = t_cur, 2 * (csr @ t_cur) / scale - t_prev
        want.append(np.real(np.sum(np.conj(V0) * t_cur, axis=0)))
    want = np.array(want)
    got = np.asarray(kpm.moments(jnp.asarray(system.data), system.skeleton, jnp.asarray(v0), 256, scale))
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-4


def test_device_eigh_matches_lapack(gpu):
    lattice, system = random_system((16, 16, 1), seed=3)
    E, _ = dense_ops.eigh_device(system.data, system.skeleton)
    E_ref = np.linalg.eigvalsh(system.matrix("dense").astype(np.complex128))
    assert np.abs(E - E_ref).max() < 1e-4 * np.abs(E_ref).max()


def test_sector_eigh_matches_lapack(gpu):
    """The decoupled-sector device eigh (two spin sectors of an s-wave +
    Zeeman operator) against float64 LAPACK on the whole matrix."""
    lattice = CubicLattice((40, 40, 1))
    system = Hamiltonian(lattice, dtype=np.complex64)
    with system as (H, Δ):
        for i in lattice.sites():
            H[i, i] = 3 * σ0 - 0.05 * σ3
            Δ[i, i] = -0.1 * jσ2
        for i, j in lattice.bonds():
            H[i, j] = -1 * σ0
    assert len(dense_ops.decoupled_sectors(system.data, system.skeleton)) == 2
    E, X = dense_ops.eigh_device(system.data, system.skeleton)
    H64 = system.matrix("dense").astype(np.complex128)
    E_ref = np.linalg.eigvalsh(H64)
    scale = np.abs(E_ref).max()
    assert np.abs(E - E_ref).max() < 1e-5 * scale
    X = np.asarray(X).astype(np.complex128)
    assert np.abs(H64 @ X - X * E[None, :]).max() < 1e-4 * scale
