"""Self-consistency solver tests: AD-driven gap equation vs direct scans."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bodge_tpu import CubicLattice, Hamiltonian, σ0
from bodge_tpu.models import selfconsistency as sc


def normal_metal(shape, mu=0.0, t=1.0):
    lattice = CubicLattice(shape)
    system = Hamiltonian(lattice)
    system.assemble(
        onsite=lambda ci: -mu * σ0,
        hopping=lambda ci, cj: np.where(
            (np.abs(ci - cj).max(axis=1) == 1)[:, None, None], -t * σ0, 0
        ),
    )
    return lattice, system


def test_total_free_energy_scalar_scan_has_minimum():
    """F_total(Δ) must be minimized at Δ > 0 for strong attraction."""
    lattice, system = normal_metal((24, 1, 1))
    F = sc.make_total_free_energy(system, V=2.5, temperature=0.0)
    deltas = np.linspace(0.0, 1.2, 25)
    Fs = [float(F(jnp.full((lattice.size,), d, system.data.dtype))) for d in deltas]
    k = int(np.argmin(Fs))
    assert 0 < k < len(deltas) - 1  # interior minimum → superconducting


def test_gradient_matches_finite_difference():
    lattice, system = normal_metal((12, 1, 1))
    F = sc.make_total_free_energy(system, V=2.0, temperature=0.1)
    x = jnp.full((lattice.size,), 0.3, system.data.dtype)
    g = jax.grad(lambda d: F(d.astype(system.data.dtype)))(jnp.real(x))
    eps = 1e-6
    e0 = jnp.zeros(lattice.size).at[5].set(1.0)
    fd = (float(F(x + eps * e0)) - float(F(x - eps * e0))) / (2 * eps)
    assert np.isclose(float(g[5]), fd, rtol=1e-4, atol=1e-6)


def test_solve_gap_uniform_matches_scan_minimum():
    lattice, system = normal_metal((24, 1, 1))
    V, T = 2.5, 0.0
    Δ, F_opt = sc.solve_gap(system, V=V, temperature=T, uniform=True,
                            delta0=0.3, steps=200, learning_rate=0.02)
    Δ_opt = float(np.real(Δ[0]))

    # Reference: golden-section-ish fine scan of the same scalar objective.
    F = sc.make_total_free_energy(system, V=V, temperature=T)
    ds = np.linspace(max(0.0, Δ_opt - 0.3), Δ_opt + 0.3, 61)
    Fs = [float(F(jnp.full((lattice.size,), d, system.data.dtype))) for d in ds]
    Δ_scan = ds[int(np.argmin(Fs))]

    assert Δ_opt > 0.05  # superconducting solution found
    assert abs(Δ_opt - Δ_scan) < 0.02
    assert F_opt <= min(Fs) + 1e-6 + 0.01 * abs(min(Fs))


def test_solve_gap_vanishes_for_weak_coupling():
    lattice, system = normal_metal((16, 1, 1), mu=0.9)
    Δ, _ = sc.solve_gap(system, V=0.2, temperature=0.0, uniform=True,
                        delta0=0.2, steps=200, learning_rate=0.02)
    assert abs(np.real(Δ[0])) < 0.02  # normal state wins


def test_kpm_objective_tracks_dense():
    lattice, system = normal_metal((16, 1, 1))
    V, T = 2.0, 0.2
    F_dense = sc.make_total_free_energy(system, V=V, temperature=T, method="dense")
    F_kpm = sc.make_total_free_energy(
        system, V=V, temperature=T, method="kpm", order=512, samples=512
    )
    for d in (0.1, 0.4, 0.8):
        x = jnp.full((lattice.size,), d, system.data.dtype)
        assert np.isclose(float(F_kpm(x)), float(F_dense(x)), rtol=0.05)


def normal_metal_2d(shape=(16, 4, 1), mu=0.0, t=1.0):
    return normal_metal(shape, mu=mu, t=t)


def row_mesh(n):
    from bodge_tpu.parallel import make_row_mesh

    return make_row_mesh(n)


# The tests named *pallas_sharded* drive the row-sharded KPM objective
# (make_total_free_energy(method="kpm", mesh=...)): every SpMM of the trace
# is the XLA halo-exchange stencil over the device mesh.
def test_pallas_sharded_objective_tracks_dense():
    """The row-sharded KPM objective (the multi-device 'training step'
    forward pass) tracks the dense objective."""
    lattice, system = normal_metal_2d()
    V, T = 2.0, 0.2
    F_dense = sc.make_total_free_energy(system, V=V, temperature=T, method="dense")
    F_sh = sc.make_total_free_energy(
        system, V=V, temperature=T, method="kpm", mesh=row_mesh(8),
        order=256, samples=128,
    )
    for d in (0.1, 0.4, 0.8):
        xd = jnp.full((lattice.size,), d, system.dtype)
        assert np.isclose(float(F_sh(xd)), float(F_dense(xd)), rtol=0.08), d


def test_pallas_sharded_gradient_matches_finite_difference():
    lattice, system = normal_metal_2d((8, 4, 1))
    F = sc.make_total_free_energy(
        system, V=2.0, temperature=0.1, method="kpm", mesh=row_mesh(8),
        order=128, samples=32,
    )
    x = jnp.full((lattice.size,), 0.3, system.dtype)
    g = jax.grad(lambda d: F(d.astype(system.dtype)))(jnp.real(x))
    eps = 1e-2
    e0 = jnp.zeros(lattice.size).at[5].set(1.0)
    fd = (float(F(x + eps * e0)) - float(F(x - eps * e0))) / (2 * eps)
    assert np.isclose(float(g[5]), fd, rtol=5e-2, atol=2e-4), (float(g[5]), fd)


def test_solve_gap_pallas_sharded_descends_to_dense_optimum():
    """solve_gap driven end-to-end through the row-sharded objective on a
    2-device mesh: a short momentum run from a perturbed start must move
    the uniform gap toward the dense-objective optimum."""
    lattice, system = normal_metal_2d()
    V, T = 2.5, 0.0
    Δ_dense, _ = sc.solve_gap(system, V=V, temperature=T, uniform=True,
                              delta0=0.3, steps=150, learning_rate=0.02)
    d_dense = float(np.real(Δ_dense[0]))

    d0 = d_dense - 0.15
    Δ_sh, F_sh = sc.solve_gap(
        system, V=V, temperature=T, uniform=True, delta0=d0, steps=10,
        learning_rate=0.1, method="kpm", order=128, samples=32, mesh=row_mesh(2),
    )
    d_sh = float(np.real(Δ_sh[0]))
    assert np.isfinite(F_sh)
    assert abs(d_sh - d_dense) < abs(d0 - d_dense), (d_sh, d0, d_dense)
    assert abs(d_sh - d_dense) < 0.12, (d_sh, d_dense)


# ---------------------------------------------------------------------------
# Bond-singlet (d-wave) pairing fields
# ---------------------------------------------------------------------------
def test_bond_insert_matches_dwave_assembly():
    """data_with_bond_singlet with the d-wave structure reproduces the
    reference-style DSL assembly with the dwave() order parameter."""
    from bodge_tpu import dwave, jσ2

    lattice, normal = normal_metal((8, 6, 1), mu=0.3)
    Δd = 0.27

    σ_d = dwave()
    dsl = Hamiltonian(lattice)
    with dsl as (H, D):
        for i in lattice.sites():
            H[i, i] = -0.3 * σ0
        for i, j in lattice.bonds():
            H[i, j] = -1.0 * σ0
            D[i, j] = Δd * σ_d(i, j)

    struct = sc.bond_structure_dwave(normal.skeleton)
    data2 = sc.data_with_bond_singlet(
        jnp.asarray(normal.data), jnp.full((lattice.size,), Δd,
                                           normal.data.dtype),
        normal.skeleton, struct,
    )
    from bodge_tpu.ops import blocksparse as bs

    M1 = dsl.matrix("dense")
    M2 = bs.ell_to_dense(np.asarray(data2), normal.skeleton)
    np.testing.assert_allclose(M2, M1, atol=1e-12)
    # Hermitian by construction.
    assert np.abs(M2 - M2.conj().T).max() < 1e-12


def test_dwave_objective_kpm_tracks_dense():
    lattice, system = normal_metal((12, 4, 1), mu=0.0)
    V, T = 2.0, 0.1
    Fd = sc.make_total_free_energy(system, V=V, temperature=T,
                                   method="dense", pairing="dwave")
    Fk = sc.make_total_free_energy(system, V=V, temperature=T, method="kpm",
                                   order=512, samples=512, pairing="dwave")
    for d in (0.1, 0.3, 0.6):
        x = jnp.full((lattice.size,), d, system.data.dtype)
        assert np.isclose(float(Fk(x)), float(Fd(x)), rtol=0.05), d


def test_solve_gap_dwave_dense_interior_minimum():
    """The d-wave gap equation has a superconducting solution at strong
    coupling, and solve_gap(pairing='dwave') finds the scan minimum."""
    lattice, system = normal_metal((10, 4, 1), mu=0.0)
    V, T = 3.0, 0.0
    Δ, F_opt = sc.solve_gap(system, V=V, temperature=T, uniform=True,
                            delta0=0.3, steps=200, learning_rate=0.02,
                            pairing="dwave")
    Δ_opt = float(np.real(Δ[0]))
    F = sc.make_total_free_energy(system, V=V, temperature=T, pairing="dwave")
    ds = np.linspace(max(0.0, Δ_opt - 0.3), Δ_opt + 0.3, 61)
    Fs = [float(F(jnp.full((lattice.size,), d, system.data.dtype))) for d in ds]
    Δ_scan = ds[int(np.argmin(Fs))]
    assert Δ_opt > 0.05
    assert abs(Δ_opt - Δ_scan) < 0.02
    assert F_opt <= min(Fs) + 1e-6 + 0.01 * abs(min(Fs))


def test_pallas_sharded_dwave_objective_tracks_dense():
    """The bond insert feeds the row-sharded KPM objective: parity with the
    dense d-wave objective through the whole sharded stack."""
    lattice, system = normal_metal_2d((16, 4, 1), mu=0.0)
    V, T = 2.0, 0.2
    Fd = sc.make_total_free_energy(system, V=V, temperature=T,
                                   method="dense", pairing="dwave")
    Fs = sc.make_total_free_energy(
        system, V=V, temperature=T, method="kpm", mesh=row_mesh(8),
        order=256, samples=128, pairing="dwave",
    )
    for d in (0.1, 0.4):
        xd = jnp.full((lattice.size,), d, system.dtype)
        assert np.isclose(float(Fs(xd)), float(Fd(xd)), rtol=0.08), d


def test_pallas_sharded_dwave_gradient_matches_finite_difference():
    lattice, system = normal_metal_2d((8, 4, 1), mu=0.0)
    F = sc.make_total_free_energy(
        system, V=2.0, temperature=0.1, method="kpm", mesh=row_mesh(8),
        order=128, samples=32, pairing="dwave",
    )
    x = jnp.full((lattice.size,), 0.3, system.dtype)
    g = jax.grad(lambda d: F(d.astype(system.dtype)))(jnp.real(x))
    eps = 1e-2
    e0 = jnp.zeros(lattice.size).at[7].set(1.0)
    fd = (float(F(x + eps * e0)) - float(F(x - eps * e0))) / (2 * eps)
    assert np.isclose(float(g[7]), fd, rtol=5e-2, atol=2e-4), (float(g[7]), fd)


# ---------------------------------------------------------------------------
# Bond-triplet (p-wave) pairing fields
# ---------------------------------------------------------------------------
def test_bond_insert_matches_pwave_assembly():
    """data_with_bond_singlet with the odd-parity p-wave structure
    reproduces the reference-style DSL assembly with pwave(dvector)
    (reference ``bodge/hamiltonian.py:409-459``)."""
    from bodge_tpu import pwave

    for dvec in ("e_z * p_x", "e_x * p_y + je_y * p_x"):
        lattice, normal = normal_metal((8, 6, 1), mu=0.3)
        Δp = 0.21

        σ_p = pwave(dvec)
        dsl = Hamiltonian(lattice)
        with dsl as (H, D):
            for i in lattice.sites():
                H[i, i] = -0.3 * σ0
            for i, j in lattice.bonds():
                H[i, j] = -1.0 * σ0
                D[i, j] = Δp * σ_p(i, j)

        struct = sc.bond_structure_pwave(normal.skeleton, dvec)
        # Antisymmetry carried by the structure: struct(+δ) = −struct(−δ).
        for s, (axis, d) in enumerate(normal.skeleton.slots):
            if axis >= 0:
                t = normal.skeleton.trans_slot[s]
                np.testing.assert_allclose(struct[t], -struct[s], atol=1e-14)
        data2 = sc.data_with_bond_singlet(
            jnp.asarray(normal.data),
            jnp.full((lattice.size,), Δp, normal.data.dtype),
            normal.skeleton, struct,
        )
        from bodge_tpu.ops import blocksparse as bs

        M1 = dsl.matrix("dense")
        M2 = bs.ell_to_dense(np.asarray(data2), normal.skeleton)
        np.testing.assert_allclose(M2, M1, atol=1e-12)
        assert np.abs(M2 - M2.conj().T).max() < 1e-12


def test_resolve_pairing_pwave_needs_dvector():
    lattice, system = normal_metal((6, 4, 1))
    with pytest.raises(ValueError, match="d-vector"):
        sc.make_total_free_energy(system, V=2.0, pairing="pwave")


def test_pwave_objective_kpm_tracks_dense():
    lattice, system = normal_metal((12, 4, 1), mu=0.0)
    V, T = 2.0, 0.1
    pairing = ("pwave", "e_z * p_x")
    Fd = sc.make_total_free_energy(system, V=V, temperature=T,
                                   method="dense", pairing=pairing)
    Fk = sc.make_total_free_energy(system, V=V, temperature=T, method="kpm",
                                   order=512, samples=512, pairing=pairing)
    for d in (0.1, 0.3, 0.6):
        x = jnp.full((lattice.size,), d, system.data.dtype)
        assert np.isclose(float(Fk(x)), float(Fd(x)), rtol=0.05), d


def test_solve_gap_pwave_dense_interior_minimum():
    """The p-wave gap equation has a superconducting solution at strong
    coupling, and solve_gap(pairing=('pwave', …)) finds the scan minimum."""
    lattice, system = normal_metal((10, 4, 1), mu=0.0)
    V, T = 3.0, 0.0
    pairing = ("pwave", "e_z * p_x")
    Δ, F_opt = sc.solve_gap(system, V=V, temperature=T, uniform=True,
                            delta0=0.3, steps=200, learning_rate=0.02,
                            pairing=pairing)
    Δ_opt = float(np.real(Δ[0]))
    F = sc.make_total_free_energy(system, V=V, temperature=T, pairing=pairing)
    ds = np.linspace(max(0.0, Δ_opt - 0.3), Δ_opt + 0.3, 61)
    Fs = [float(F(jnp.full((lattice.size,), d, system.data.dtype))) for d in ds]
    Δ_scan = ds[int(np.argmin(Fs))]
    assert Δ_opt > 0.05
    assert abs(Δ_opt - Δ_scan) < 0.02
    assert F_opt <= min(Fs) + 1e-6 + 0.01 * abs(min(Fs))


def test_pallas_sharded_pwave_objective_tracks_dense():
    """The bond insert also carries the odd-parity triplet structure:
    sharded-KPM vs dense parity for a chiral d-vector."""
    lattice, system = normal_metal_2d((16, 4, 1), mu=0.0)
    V, T = 2.0, 0.2
    pairing = ("pwave", "e_x * p_y + je_y * p_x")
    Fd = sc.make_total_free_energy(system, V=V, temperature=T,
                                   method="dense", pairing=pairing)
    Fs = sc.make_total_free_energy(
        system, V=V, temperature=T, method="kpm", mesh=row_mesh(8),
        order=256, samples=128, pairing=pairing,
    )
    for d in (0.1, 0.4):
        xd = jnp.full((lattice.size,), d, system.dtype)
        assert np.isclose(float(Fs(xd)), float(Fd(xd)), rtol=0.08), d
