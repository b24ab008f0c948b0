"""Physics laws driven end-to-end through the Chebyshev/KPM stack.

The reference validates physics only through its dense/sparse-LU solvers
(reference tests/test_physics.py); the scalable device path of this build —
block-sparse SpMM → KPM moments → Jackson-kernel reconstruction — was
previously validated only by unit-level convergence tests.  These tests
re-assert the same physical laws with ``method="kpm"`` so a regression
anywhere in the KPM stack (packing, kernels, moment recursion, kernel
weights, reconstruction) breaks a physics assertion, not just a unit
tolerance.  (Round-2 verdict item 7.)

Broadening note: KPM's Jackson kernel gives an energy resolution of
~π·scale/order, so each test picks its expansion order such that the
feature it asserts on (gap Δ0, peak width) is several resolution widths
wide — the same consideration the reference applies through its
grid-adaptive Γ (reference bodge/hamiltonian.py:352).
"""

import numpy as np
import pytest

from bodge_tpu import CubicLattice, Hamiltonian, jσ2, pwave, σ0, σ2


def test_superconducting_gap_existence_kpm():
    """Gap opens in the KPM LDOS when Δ ≠ 0 (reference
    tests/test_physics.py:16-67, LDOS branch, via KPM instead of spsolve)."""
    lattice = CubicLattice((16, 16, 1))
    system = Hamiltonian(lattice)
    with system as (H, Δ):
        for i in lattice.sites():
            H[i, i] = -1.5 * σ0
        for i, j in lattice.bonds():
            H[i, j] = -1.0 * σ0

    Δs = 0.5
    probe = (8, 8, 0)
    ω = np.array([-1.2 * Δs, -0.8 * Δs, +0.8 * Δs, 1.2 * Δs])
    order = 512  # resolution ~π·6/512 ≈ 0.04 ≪ Δs

    ρ_normal = system.ldos(probe, ω, method="kpm", order=order)

    with system as (H, Δ):
        for i in lattice.sites():
            Δ[i, i] = Δs * jσ2

    ρ_sc = system.ldos(probe, ω, method="kpm", order=order)

    assert (ρ_normal >= 0).all() and (ρ_sc >= 0).all()
    # Inside the gap the DOS drops; outside it piles up.
    assert ρ_sc[1] < ρ_normal[1] and ρ_sc[2] < ρ_normal[2]
    assert ρ_sc[0] > ρ_normal[0] and ρ_sc[3] > ρ_normal[3]


def test_gap_scales_with_order_parameter_kpm():
    """Zero-energy KPM spectral weight decreases monotonically as the
    order parameter grows (KPM form of the reference's gap-scaling sweep,
    reference tests/test_physics.py:70-112: there the gap is read from the
    minimum eigenvalue; here from the Jackson-broadened ρ(0), which decays
    monotonically as the first excitation moves up)."""
    lattice = CubicLattice((32, 1, 1))
    system = Hamiltonian(lattice)
    t, μ = 1.0, 1.5
    with system as (H, Δ):
        for i in lattice.sites():
            H[i, i] = -μ * σ0
        for i, j in lattice.bonds():
            H[i, j] = -t * σ0

    probe = (16, 0, 0)
    order = 512
    weights = []
    for Δ0 in [0.0, 0.1, 0.3, 0.6, 1.0]:
        with system as (H, Δ):
            for i in lattice.sites():
                Δ[i, i] = Δ0 * jσ2
        ρ0 = system.ldos(probe, [0.0], method="kpm", order=order)[0]
        weights.append(float(ρ0))

    assert all(w >= 0 for w in weights)
    assert all(a > b for a, b in zip(weights[:-1], weights[1:])), weights


def test_pwave_edge_states_kpm():
    """pₓ-wave zero-energy edge states through the KPM stack (reference
    tests/test_physics.py:300-339): the gap closes at x-normal edges, so
    the KPM LDOS is highest at the x edges and the corner."""
    lattice = CubicLattice((31, 31, 1))
    system = Hamiltonian(lattice)
    t = 1.0
    Δ0 = 0.1 * t
    σp = pwave("e_z * p_x")
    with system as (H, Δ):
        for i, j in lattice.bonds():
            H[i, j] = -t * σ0
            Δ[i, j] = -Δ0 * σp(i, j)

    energies = [0.0, Δ0 / 4]
    order = 1024  # resolution ~π·4.2/1024 ≈ 0.013 ≪ Δ0
    sites = [(15, 15, 0), (15, 0, 0), (0, 15, 0), (0, 0, 0)]
    ρ = system.ldos_map(sites, energies, method="kpm", order=order)
    ρ_center, ρ_yedge, ρ_xedge, ρ_corner = (float(ρ[k, 0]) for k in range(4))

    assert ρ_xedge > ρ_center and ρ_xedge > ρ_yedge
    assert ρ_corner > ρ_center and ρ_corner > ρ_yedge


def test_odd_frequency_zero_energy_peak_kpm():
    """The magnet-induced zero-energy peak survives the KPM broadening
    (reference tests/test_physics.py:231-269 via KPM)."""
    lattice = CubicLattice((128, 1, 1))
    system = Hamiltonian(lattice)
    t = 1.0
    Δ0, M0 = 0.3 * t, 0.15 * t
    probe, energies = (63, 0, 0), [0.0, 0.05 * Δ0]
    order = 1024  # resolution ~π·4/1024 ≈ 0.012 ≪ Δ0

    with system as (H, Δ):
        for i, j in lattice.bonds():
            H[i, j] = -t * σ0
        for i in lattice.sites():
            Δ[i, i] = -Δ0 * jσ2
    Z_clean = system.ldos(probe, energies, method="kpm", order=order)[0]

    with system as (H, Δ):
        for i in lattice.sites():
            H[i, i] = -M0 * σ2
    Z_magnet = system.ldos(probe, energies, method="kpm", order=order)[0]

    assert Z_clean >= 0
    assert Z_magnet > Z_clean


def test_free_energy_decreases_with_temperature_kpm():
    """F(T) decreasing through the stochastic-trace KPM free energy
    (reference tests/test_physics.py:272-297 via KPM; fixed probe key so
    the estimator noise is common across temperatures)."""
    import jax

    lattice = CubicLattice((10, 10, 1))
    system = Hamiltonian(lattice)
    with system as (H, Δ):
        for i in lattice.sites():
            H[i, i] = -2.0 * σ0
        for i, j in lattice.bonds():
            H[i, j] = -1.0 * σ0

    key = jax.random.PRNGKey(11)
    Fs = [
        system.free_energy(T, method="kpm", order=512, samples=32, key=key)
        for T in [0.01, 0.1, 0.5, 1.0]
    ]
    assert all(a > b for a, b in zip(Fs[:-1], Fs[1:])), Fs
