"""Checkpoint / resume round-trips."""

import numpy as np
import pytest

from bodge_tpu import CubicLattice, Hamiltonian, jσ2, σ0, σ3
from bodge_tpu.ops import blocksparse as bs


def _system(shape=(6, 5, 1), dtype=np.complex128):
    lattice = CubicLattice(shape)
    system = Hamiltonian(lattice, dtype=dtype)
    L = shape[0]
    system.assemble(
        onsite=lambda ci: -0.5 * σ0 + 0.3 * σ3 * (ci[:, 0] < L // 2)[:, None, None],
        pairing_onsite=lambda ci: (0.4 + 0.1j) * jσ2,
        hopping=lambda ci, cj: np.where(
            (np.abs(ci - cj).max(axis=1) == 1)[:, None, None], -1.0 * σ0, 0
        ),
    )
    return system


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_roundtrip_cubic(tmp_path, dtype):
    system = _system(dtype=dtype)
    p = str(tmp_path / "ckpt.npz")
    system.save(p)
    loaded = Hamiltonian.load(p)

    assert loaded.dtype == system.dtype
    assert loaded.shape == system.shape
    np.testing.assert_array_equal(np.asarray(loaded.data), np.asarray(system.data))

    # Observables survive the round trip.
    np.testing.assert_allclose(loaded.eigenvalues(), system.eigenvalues(), atol=1e-10)
    np.testing.assert_allclose(
        loaded.free_energy(0.05), system.free_energy(0.05), atol=1e-8
    )


def test_roundtrip_resume_assembly(tmp_path):
    """A loaded system accepts further in-place updates (resume semantics)."""
    system = _system()
    p = str(tmp_path / "ckpt.npz")
    system.save(p)
    loaded = Hamiltonian.load(p)

    with loaded as (H, Δ):
        H[(0, 0, 0), (0, 0, 0)] = 0.9 * σ3
    with system as (H, Δ):
        H[(0, 0, 0), (0, 0, 0)] = 0.9 * σ3
    np.testing.assert_allclose(
        np.asarray(loaded.data), np.asarray(system.data), atol=1e-12
    )


def test_roundtrip_generic_skeleton(tmp_path):
    """Non-cubic skeletons restore verbatim behind a FrozenLattice."""
    from bodge_tpu.utils.serialization import FrozenLattice, load_hamiltonian

    # Small ring graph (not a cubic stencil): 0-1-2-...-n-0.
    n = 8
    rows = np.concatenate([np.arange(n), np.arange(n), np.arange(n)])
    cols = np.concatenate([np.arange(n), (np.arange(n) + 1) % n, (np.arange(n) - 1) % n])
    sk = bs.skeleton_from_pairs(n, rows, cols)

    system = Hamiltonian.__new__(Hamiltonian)
    system.lattice = FrozenLattice(n)
    system.dtype = np.dtype(np.complex128)
    system._sk = sk
    system.shape = (4 * n, 4 * n)
    system._eigh_cache = None
    system._version = 1
    data = np.zeros((n, sk.n_slots, 4, 4), dtype=np.complex128)
    rng = np.random.default_rng(3)
    blk = rng.normal(size=(4, 4)) + 1j * rng.normal(size=(4, 4))
    data[:, 0] = blk + np.conj(blk.T)
    system._data = data

    p = str(tmp_path / "generic.npz")
    system.save(p)
    loaded = load_hamiltonian(p)
    assert not loaded.skeleton.stencil
    np.testing.assert_array_equal(loaded.skeleton.cols, sk.cols)
    np.testing.assert_array_equal(np.asarray(loaded.data), data)
    with pytest.raises(ValueError, match="flat index"):
        loaded.lattice[(1, 0, 0)]
    assert loaded.lattice[3] == 3


def test_frozen_lattice_kpm_matches_exact(tmp_path):
    """A checkpoint-restored generic system runs its KPM observables through
    the gather SpMM; its Chebyshev moments equal a float64 recursion on the
    exported matrix."""
    from bodge_tpu.ops import chebyshev as kpm
    from tests.test_generic_lattice import build_ring

    lattice, system = build_ring(24)
    p = str(tmp_path / "ring.npz")
    system.save(p)
    loaded = Hamiltonian.load(p)
    assert not loaded.skeleton.stencil

    energies = np.linspace(-2.0, 2.0, 9)
    ρ_kpm = loaded.ldos(5, energies, method="kpm", impl="gather", eta=0.3)
    ρ_default = loaded.ldos(5, energies, method="kpm", eta=0.3)
    np.testing.assert_allclose(ρ_kpm, ρ_default, atol=1e-12)
    assert np.all(ρ_kpm > 0)

    scale = kpm.spectral_bound(loaded.data, loaded.skeleton)
    v0 = np.zeros((lattice.size, 4, 4), loaded.dtype)
    v0[5, np.arange(4), np.arange(4)] = 1.0
    mu = np.asarray(kpm.moments(loaded.data, loaded.skeleton, v0, 40, scale, impl="gather"))
    H = loaded.matrix("dense") / scale
    V0 = v0.reshape(4 * lattice.size, 4)
    t_prev, t_cur = V0, H @ V0
    want = [np.real(np.sum(V0.conj() * t_prev, axis=0)), np.real(np.sum(V0.conj() * t_cur, axis=0))]
    for _ in range(38):
        t_prev, t_cur = t_cur, 2 * H @ t_cur - t_prev
        want.append(np.real(np.sum(V0.conj() * t_cur, axis=0)))
    np.testing.assert_allclose(mu, np.array(want), atol=1e-10)
