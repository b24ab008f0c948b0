"""Multi-device tests on the 8-virtual-CPU-device mesh: the halo-exchange
sharded SpMM / Chebyshev paths must agree with their single-device
counterparts, for open and periodic boundaries."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bodge_tpu import CubicLattice, Hamiltonian, jσ2, σ0, σ3
from bodge_tpu.ops import chebyshev as kpm
from bodge_tpu.ops.spmm import spmm_stencil
from bodge_tpu.parallel import (
    RowSharding,
    free_energy_kpm_sharded,
    make_row_mesh,
    moments_sharded,
    spmm_sharded,
)


def build_system(shape, pbc=False, seed=3):
    lattice = CubicLattice(shape)
    system = Hamiltonian(lattice)
    rng = np.random.default_rng(seed)
    phase = rng.normal(size=(lattice.size, 1, 1))

    def hopping(ci, cj):
        bond = (np.abs(ci - cj).max(axis=1) == 1)[:, None, None]
        if pbc:
            bond = np.ones_like(bond)
        return np.where(bond, -1.0 * σ0, 0)

    system.assemble(
        onsite=lambda ci: -0.7 * σ0 - 0.2 * σ3,
        pairing_onsite=lambda ci: (0.3 + 0.1 * phase) * jσ2,
        hopping=hopping,
    )
    return lattice, system


def eight_device_mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return make_row_mesh(8)


@pytest.mark.parametrize("pbc", [False, True])
def test_sharded_spmm_matches_single_device(pbc):
    mesh = eight_device_mesh()
    lattice, system = build_system((16, 6, 1), pbc=pbc)
    rs = RowSharding(system.skeleton, mesh)

    rng = np.random.default_rng(0)
    v = jnp.asarray(rng.normal(size=(lattice.size, 4, 3)) + 1j * rng.normal(size=(lattice.size, 4, 3)))

    want = np.asarray(spmm_stencil(system.data, system.skeleton, v))
    got = np.asarray(spmm_sharded(rs, rs.shard_data(system.data), rs.shard_vector(v)))
    assert np.allclose(got, want, atol=1e-10)


def test_sharded_moments_match_single_device():
    mesh = eight_device_mesh()
    lattice, system = build_system((16, 6, 1), pbc=True)
    rs = RowSharding(system.skeleton, mesh)
    sk = system.skeleton

    a = kpm.spectral_bound(system.data, sk)
    N = lattice.size
    site = lattice[(8, 3, 0)]
    v0 = jnp.zeros((N, 4, 4), dtype=system.data.dtype)
    v0 = v0.at[site, jnp.arange(4), jnp.arange(4)].set(1.0)

    order = 64
    mu_single = np.asarray(kpm.moments(system.data, sk, v0, order, a))
    mu_sharded = np.asarray(
        moments_sharded(rs, rs.shard_data(system.data), rs.shard_vector(v0), order, a)
    )
    assert np.allclose(mu_sharded, mu_single, atol=1e-10)


def test_sharded_free_energy_matches_single_device():
    mesh = eight_device_mesh()
    lattice, system = build_system((16, 4, 1))
    rs = RowSharding(system.skeleton, mesh)
    sk = system.skeleton
    a = kpm.spectral_bound(system.data, sk)

    T, order, samples = 0.3, 256, 16
    key = jax.random.PRNGKey(7)
    F_single = kpm.free_energy_kpm(
        system.data, sk, T, order=order, samples=samples, key=key, scale=a
    )
    F_sharded = free_energy_kpm_sharded(
        rs, rs.shard_data(system.data), T, a, order=order, samples=samples, key=key
    )
    assert np.isclose(F_sharded, F_single, rtol=1e-10)


def test_row_sharding_validation():
    mesh = eight_device_mesh()
    lattice, system = build_system((6, 4, 1))  # 6 not divisible by 8
    with pytest.raises(ValueError):
        RowSharding(system.skeleton, mesh)


DEVICE_COUNTS = [1, 2, 4, 8]


def row_mesh(n):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} virtual devices")
    return make_row_mesh(n)


def random_probes(N, K, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(N, 4, K)) + 1j * rng.normal(size=(N, 4, K))).astype(dtype)


@pytest.mark.parametrize("pbc", [False, True], ids=["open", "periodic"])
@pytest.mark.parametrize("n", DEVICE_COUNTS)
def test_sharded_spmm_over_device_counts(n, pbc):
    """The halo-exchange SpMM equals the single-device stencil on every
    mesh size, including the 1-device mesh (identity ppermute ring)."""
    lattice, system = build_system((16, 7, 1), pbc=pbc, seed=n)
    rs = RowSharding(system.skeleton, row_mesh(n))
    v = jnp.asarray(random_probes(lattice.size, 4, system.dtype, seed=n))
    want = np.asarray(spmm_stencil(jnp.asarray(system.data), system.skeleton, v))
    got = np.asarray(spmm_sharded(rs, rs.shard_data(system.data), rs.shard_vector(v)))
    np.testing.assert_allclose(got, want, atol=1e-12)


@pytest.mark.parametrize("n", DEVICE_COUNTS)
def test_sharded_moments_over_device_counts(n):
    """Moments, including odd orders (the trailing-moment truncation)."""
    lattice, system = build_system((16, 6, 1), pbc=True, seed=11)
    rs = RowSharding(system.skeleton, row_mesh(n))
    sk = system.skeleton
    a = kpm.spectral_bound(system.data, sk)
    v0 = random_probes(lattice.size, 3, system.dtype, seed=2)
    data_sh, v_sh = rs.shard_data(system.data), rs.shard_vector(v0)
    for order in (2, 3, 7, 48):
        want = np.asarray(kpm.moments(system.data, sk, v0, order, a))
        got = np.asarray(moments_sharded(rs, data_sh, v_sh, order, a))
        np.testing.assert_allclose(got, want, atol=1e-10)


@pytest.mark.parametrize("pbc", [False, True], ids=["open", "periodic"])
def test_sharded_moments_thick_slabs(pbc):
    """16 x-planes per device on an 8-device ring: interior planes, the
    first/last plane halos and the wrap link in one sweep."""
    lattice, system = build_system((128, 5, 1), pbc=pbc, seed=13)
    rs = RowSharding(system.skeleton, row_mesh(8))
    sk = system.skeleton
    a = kpm.spectral_bound(system.data, sk)
    v0 = np.zeros((lattice.size, 4, 4), dtype=system.dtype)
    v0[lattice[(64, 2, 0)], np.arange(4), np.arange(4)] = 1.0
    want = np.asarray(kpm.moments(system.data, sk, v0, 32, a))
    got = np.asarray(
        moments_sharded(rs, rs.shard_data(system.data), rs.shard_vector(v0), 32, a)
    )
    np.testing.assert_allclose(got, want, atol=1e-10)


@pytest.mark.parametrize("n", DEVICE_COUNTS)
def test_sharded_trace_and_gradient_match_single_device(n):
    """The sharded trace Σ c_m μ_m and its gradient w.r.t. the operator
    blocks (the self-consistency backward pass through the transposed
    ppermute ring) equal the single-device ones."""
    from bodge_tpu.parallel.sharded import _trace_sharded_jit

    lattice, system = build_system((16, 4, 1), pbc=True, seed=21)
    rs = RowSharding(system.skeleton, row_mesh(n))
    sk = system.skeleton
    order = 24
    coeffs = jnp.asarray(np.linspace(1.0, 0.1, order))
    inv = jnp.asarray(1.0 / 6.0)
    z = random_probes(lattice.size, 2, system.dtype, seed=4)
    data = jnp.asarray(system.data)

    single = jax.value_and_grad(
        lambda d: kpm._trace_fn_scan(d, sk, jnp.asarray(z), coeffs, inv, order, "stencil")
    )
    z_sh = rs.shard_vector(z)
    sharded = jax.jit(jax.value_and_grad(
        lambda d: _trace_sharded_jit(rs, d, z_sh, coeffs, inv, order)
    ))
    F1, g1 = single(data)
    Fn, gn = sharded(rs.shard_data(data))
    np.testing.assert_allclose(float(Fn), float(F1), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(gn), np.asarray(g1), atol=1e-10)


@pytest.mark.parametrize("what", ["moments", "free_energy"])
def test_rows_probes_mesh_matches_single_device(what):
    """Rows×probes mesh: probe columns ride the second mesh axis while each
    column group runs the identical row-sharded halo-exchange sweep."""
    lattice, system = build_system((8, 4, 1), seed=5)
    sk = system.skeleton
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    rs = RowSharding(sk, make_row_mesh(8, probe_shards=2))
    assert rs.has_probe_axis
    a = kpm.spectral_bound(system.data, sk)
    if what == "moments":
        v0 = random_probes(lattice.size, 8, system.dtype, seed=5)
        want = np.asarray(kpm.moments(system.data, sk, v0, 12, a))
        got = np.asarray(
            moments_sharded(rs, rs.shard_data(system.data), rs.shard_vector(v0), 12, a)
        )
        np.testing.assert_allclose(got, want, atol=1e-10)
    else:
        key = jax.random.PRNGKey(3)
        want = kpm.free_energy_kpm(system.data, sk, 0.2, order=64, samples=8, key=key, scale=a)
        got = free_energy_kpm_sharded(
            rs, rs.shard_data(system.data), 0.2, a, order=64, samples=8, key=key
        )
        assert np.isclose(got, want, rtol=1e-10)


def test_sharded_ldos_matches_single_device():
    """LDOS reconstructed from row-sharded moments of one-hot site probes."""
    lattice, system = build_system((16, 6, 1), pbc=False, seed=41)
    rs = RowSharding(system.skeleton, row_mesh(8))
    sk = system.skeleton
    a = kpm.spectral_bound(system.data, sk)
    sites = [lattice[(8, 3, 0)], lattice[(0, 0, 0)]]
    energies = np.linspace(-1.0, 1.0, 9)
    want = kpm.ldos_kpm_sites(system.data, sk, sites, energies, order=64, scale=a)
    v0 = kpm.ldos_site_probes(sk.n_sites, sites, system.dtype)
    mu = moments_sharded(rs, rs.shard_data(system.data), rs.shard_vector(v0), 64, a)
    got = kpm.ldos_from_moments(mu, energies, a, "jackson", len(sites))
    assert got.shape == want.shape == (2, 9)
    np.testing.assert_allclose(got, want, atol=1e-10)


def test_sharded_dos_matches_single_device():
    """Stochastic DOS from row-sharded moments of shared Rademacher probes."""
    lattice, system = build_system((16, 6, 1), pbc=True, seed=51)
    rs = RowSharding(system.skeleton, row_mesh(8))
    sk = system.skeleton
    a = kpm.spectral_bound(system.data, sk)
    energies = np.linspace(-1.2, 1.2, 11)
    key = jax.random.PRNGKey(5)
    want = kpm.dos_kpm(system.data, sk, energies, order=64, scale=a, samples=8, key=key)
    z = kpm.rademacher_probes(sk.n_sites, 8, key, system.dtype, default_seed=1)
    mu = moments_sharded(rs, rs.shard_data(system.data), rs.shard_vector(z), 64, a)
    mu_tr = jnp.sum(mu, axis=1) / 8
    x = np.clip(energies / a, -0.999999, 0.999999)
    got = np.asarray(kpm.reconstruct_density(mu_tr[:, None], jnp.asarray(x), a))[:, 0]
    np.testing.assert_allclose(got, want, atol=1e-10)
