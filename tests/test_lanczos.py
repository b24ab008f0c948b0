"""Tests for the filtered-subspace (``method="lanczos"``) eigensolver.

Oracle: full dense ``np.linalg.eigh`` on the exported matrix — the same
cross-check the reference applies to its LAPACK path
(``reference tests/test_hamiltonian.py:342-367``), restricted to the k
lowest-|ε| states the iterative solver targets.

The clean uniform s-wave square lattice has a *massively degenerate* gap
edge (a whole Fermi contour at E = Δ), so signed elementwise comparisons
are only meaningful once a weak incommensurate potential splits the shell;
the degenerate case is still covered through |E| and residual checks.
"""

import numpy as np
import pytest

from bodge_tpu import CubicLattice, Hamiltonian, jσ2, σ0, σ3
from bodge_tpu.ops import lanczos as lz


def _swave_system(shape, delta=0.2, mu=0.5, m=0.0, pot=0.0):
    """Uniform s-wave BdG system; ``pot`` adds a weak incommensurate
    on-site modulation that lifts the gap-edge shell degeneracy."""
    lat = CubicLattice(shape)
    sys = Hamiltonian(lat)

    def onsite(ci):
        v = (-mu + pot * np.cos(2.39996 * ci[:, 0] + 1.1 * ci[:, 1]))[:, None, None]
        return v * σ0 + m * σ3

    sys.assemble(
        onsite=onsite,
        hopping=lambda ci, cj: -1.0 * σ0,
        pairing_onsite=lambda ci: delta * jσ2,
    )
    return sys


def _lowest_ref(sys, nev):
    E_ref = np.linalg.eigh(sys.matrix("dense"))[0]
    idx = np.argsort(np.abs(E_ref), kind="stable")[:nev]
    return np.sort(E_ref[idx]), E_ref


def test_lowest_eigenstates_match_dense():
    """Non-degenerate system: signed eigenvalues match LAPACK to 1e-6."""
    sys = _swave_system((16, 16, 1), pot=0.08)
    want, E_ref = _lowest_ref(sys, 8)

    E, X, info = lz.lowest_eigenstates(
        sys.host_data(), sys.skeleton, 8, full_output=True, seed=3
    )
    assert info["method"] == "chebyshev-filtered subspace iteration"
    assert info["converged"], info
    np.testing.assert_allclose(E, want, atol=1e-6, rtol=0)

    # Eigenvector residuals against the exact operator: the f32 device
    # filter floors vector quality near 1e-4·scale (eigenvalues are
    # quadratically better — the 1e-6 assertion above).
    dense = sys.matrix("dense")
    R = dense @ X - X * E[None, :]
    assert np.linalg.norm(R, axis=0).max() < 1e-3 * np.abs(E_ref).max()

    # Orthonormal columns.
    G = X.conj().T @ X
    np.testing.assert_allclose(G, np.eye(8), atol=1e-10)


def test_degenerate_gap_edge_shell():
    """The clean lattice's gap edge is a degenerate ±Δ shell; the solver
    must return |E| = Δ states with true-eigenvector residuals (the
    augmented Rayleigh–Ritz resolves the particle–hole sign mixing)."""
    sys = _swave_system((16, 16, 1))
    _, E_ref = _lowest_ref(sys, 8)
    gap = np.abs(E_ref).min()

    E, X, info = lz.lowest_eigenstates(
        sys.host_data(), sys.skeleton, 8, full_output=True, seed=3
    )
    assert info["converged"], info
    np.testing.assert_allclose(np.abs(E), gap, atol=1e-6, rtol=0)
    dense = sys.matrix("dense")
    R = dense @ X - X * E[None, :]
    assert np.linalg.norm(R, axis=0).max() < 1e-3 * np.abs(E_ref).max()


def test_particle_hole_symmetric_pairs():
    sys = _swave_system((12, 14, 1), delta=0.15, pot=0.06)
    E, _ = lz.lowest_eigenstates(sys.host_data(), sys.skeleton, 8, seed=1)
    # ±ε pairs: sorted ascending, the spectrum mirrors around zero.
    np.testing.assert_allclose(E, -E[::-1], atol=2e-6)


def test_diagonalize_lanczos_api():
    sys = _swave_system((14, 12, 1), delta=0.25, mu=0.3, pot=0.07)
    k = 5
    E_it, X_it = sys.diagonalize(method="lanczos", k=k, seed=5)
    E_ref, _ = sys.diagonalize(method="dense")

    np.testing.assert_allclose(E_it, E_ref[:k], atol=1e-6, rtol=0)
    # Reshape contract: X[n, site, α].
    assert X_it.shape == (k, sys.lattice.size, 4)

    # Raw format returns column vectors of the right length.
    E_raw, X_raw = sys.diagonalize(method="lanczos", k=k, format="raw", seed=5)
    assert X_raw.shape == (4 * sys.lattice.size, k)
    np.testing.assert_allclose(E_raw, E_it, atol=0)


def test_eigenvalues_lanczos_api():
    sys = _swave_system((13, 13, 1), delta=0.2, pot=0.05)
    E_it = sys.eigenvalues(method="lanczos", k=4, seed=2)
    E_ref = sys.eigenvalues(method="dense")
    np.testing.assert_allclose(E_it, E_ref[:4], atol=1e-6, rtol=0)


def test_lanczos_requires_k():
    sys = _swave_system((8, 8, 1))
    with pytest.raises(ValueError, match="k"):
        sys.diagonalize(method="lanczos")
    with pytest.raises(ValueError, match="k"):
        sys.eigenvalues(method="lanczos")


def test_tiny_system_dense_fallback():
    sys = _swave_system((4, 4, 1))
    E, X, info = lz.lowest_eigenstates(
        sys.host_data(), sys.skeleton, 4, full_output=True
    )
    assert info["method"] == "dense-fallback"
    E_ref = np.linalg.eigh(sys.matrix("dense"))[0]
    idx = np.argsort(np.abs(E_ref), kind="stable")[:4]
    np.testing.assert_allclose(E, np.sort(E_ref[idx]), atol=1e-10)


def test_explicit_gather_impl():
    """The filter engine runs the gather SpMM when asked and reports it."""
    sys = _swave_system((12, 12, 1), delta=0.3, pot=0.09)
    want, _ = _lowest_ref(sys, 6)
    E, _, info = lz.lowest_eigenstates(
        sys.host_data(), sys.skeleton, 6, impl="gather", full_output=True, seed=4
    )
    assert info["impl"] == "gather"
    # nev=6 splits a 4-fold |E| level here: which signs are taken from the
    # tied level is arbitrary, so compare the sign-blind |E| ladder.
    np.testing.assert_allclose(np.sort(np.abs(E)), np.sort(np.abs(want)), atol=1e-6, rtol=0)


def test_magnetic_field_breaks_degeneracy():
    """Zeeman-split spectrum (no ± spin degeneracy) still converges."""
    sys = _swave_system((14, 10, 1), delta=0.2, m=0.12, pot=0.04)
    want, _ = _lowest_ref(sys, 6)
    E, _ = lz.lowest_eigenstates(sys.host_data(), sys.skeleton, 6, seed=6)
    np.testing.assert_allclose(E, want, atol=1e-6, rtol=0)


def test_shift_invert_matches_dense():
    """Host shift-invert ARPACK (σ=0, SuperLU, complex128) reproduces the
    dense lowest positive states exactly — the fast exact host tier that
    complements the device-side method='lanczos'."""
    sys = _swave_system((14, 14, 1), delta=0.25, pot=0.06)
    E_ref, _ = sys.diagonalize(method="dense")
    E_si = sys.eigenvalues(method="shift_invert", k=5)
    np.testing.assert_allclose(E_si, E_ref[:5], atol=1e-9, rtol=0)
    E2, X2 = sys.diagonalize(method="shift_invert", k=4)
    np.testing.assert_allclose(E2, E_ref[:4], atol=1e-9, rtol=0)
    assert X2.shape == (4, sys.lattice.size, 4)
    # Residuals of the reshaped eigenvectors against the dense matrix.
    dense = sys.matrix("dense")
    Xcols = X2.reshape(4, -1).T
    R = dense @ Xcols - Xcols * E2[None, :]
    assert np.linalg.norm(R, axis=0).max() < 1e-8
