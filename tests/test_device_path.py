"""The complex XLA device path: SpMM parity against SciPy, moments against a
NumPy float64 recursion, autodiff of the moment scan against finite
differences, implementation-name validation, device-eigh failure
reporting, the peak table and the compile-cache placement."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import bodge_tpu
from bodge_tpu import CubicLattice, Hamiltonian, jσ2, σ0, σ1, σ3
from bodge_tpu.models import selfconsistency as sc
from bodge_tpu.ops import chebyshev as kpm
from bodge_tpu.ops import dense as dense_ops
from bodge_tpu.ops import lanczos as lz
from bodge_tpu.ops.spmm import spmm, spmm_gather, spmm_stencil
from bodge_tpu.utils import profiling

SHAPES = {"1d": (12, 1, 1), "2d": (6, 5, 1), "3d": (4, 3, 3)}


def random_system(shape, dtype, pbc, seed=0):
    """Random Hermitian BdG operator: site-dependent on-site terms, hopping
    and singlet pairing on every bond, and on the wrap links when ``pbc``."""
    lattice = CubicLattice(shape)
    system = Hamiltonian(lattice, dtype=dtype)
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(lattice.size, 1, 1))
    b = rng.normal(size=(lattice.size, 1, 1))

    def link(ci, cj):
        bond = (np.abs(ci - cj).max(axis=1) == 1)[:, None, None]
        return np.ones_like(bond) if pbc else bond

    system.assemble(
        onsite=lambda ci: a * σ0 + 0.3 * b * σ3 + 0.2 * σ1,
        pairing_onsite=lambda ci: (0.4 + 0.1j * b) * jσ2,
        # A Peierls phase makes the hopping complex: h(j→i) = h(i→j)*.
        hopping=lambda ci, cj: np.where(
            link(ci, cj), -np.exp(0.3j * (cj - ci)[:, 0])[:, None, None] * σ0, 0
        ),
        pairing=lambda ci, cj: np.where(link(ci, cj), 0.15 * jσ2, 0),
    )
    return lattice, system


def _tol(dtype):
    return 2e-5 if np.dtype(dtype) == np.complex64 else 1e-12


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("K", [1, 4, 8])
@pytest.mark.parametrize("pbc", [False, True], ids=["open", "periodic"])
@pytest.mark.parametrize("shape", list(SHAPES), ids=list(SHAPES))
def test_spmm_parity_with_csr(shape, pbc, K, dtype):
    """stencil ≡ gather ≡ SciPy ``matrix("csr") @ v`` over 1D/2D/3D lattices,
    open and periodic axes, probe widths and both complex dtypes."""
    lattice, system = random_system(SHAPES[shape], dtype, pbc, seed=K)
    N = lattice.size
    rng = np.random.default_rng(K + 11)
    v = (rng.normal(size=(N, 4, K)) + 1j * rng.normal(size=(N, 4, K))).astype(dtype)

    csr = system.matrix("csr").astype(np.complex128)
    want = (csr @ v.astype(np.complex128).reshape(4 * N, K)).reshape(N, 4, K)
    scale = np.abs(want).max()

    data, sk = jnp.asarray(system.data), system.skeleton
    for got in (
        spmm_stencil(data, sk, jnp.asarray(v)),
        spmm_gather(data, sk, jnp.asarray(v)),
        system.apply(jnp.asarray(v)),
    ):
        assert got.dtype == dtype
        np.testing.assert_allclose(np.asarray(got), want, atol=_tol(dtype) * scale)


def numpy_moments(csr, v0, order, scale):
    """Plain float64 three-term Chebyshev recursion: μ_m = Re⟨v0|T_m(H/a)|v0⟩."""
    H = csr.astype(np.complex128) / scale
    V0 = v0.reshape(csr.shape[0], -1).astype(np.complex128)
    mus = [np.real(np.sum(np.conj(V0) * V0, axis=0))]
    t_prev, t_cur = V0, H @ V0
    mus.append(np.real(np.sum(np.conj(V0) * t_cur, axis=0)))
    for _ in range(order - 2):
        t_prev, t_cur = t_cur, 2 * (H @ t_cur) - t_prev
        mus.append(np.real(np.sum(np.conj(V0) * t_cur, axis=0)))
    return np.array(mus[:order])


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("order", [1, 2, 3, 16, 33])
def test_moments_match_numpy_recursion(order, dtype):
    lattice, system = random_system((6, 4, 1), dtype, pbc=True, seed=order)
    sk = system.skeleton
    rng = np.random.default_rng(order)
    v0 = (rng.normal(size=(lattice.size, 4, 3))
          + 1j * rng.normal(size=(lattice.size, 4, 3))).astype(dtype)
    csr = system.matrix("csr")
    scale = 1.05 * np.abs(np.linalg.eigvalsh(csr.toarray())).max()

    want = numpy_moments(csr, v0, order, scale)
    got = np.asarray(kpm.moments(jnp.asarray(system.data), sk, jnp.asarray(v0), order, scale))
    assert got.shape == (order, 3)
    np.testing.assert_allclose(got, want, atol=_tol(dtype) * 50 * np.abs(want).max())


@pytest.mark.parametrize("impl", ["stencil", "gather"])
@pytest.mark.parametrize("pbc", [False, True], ids=["open", "periodic"])
def test_moment_scan_gradient_matches_finite_difference(pbc, impl):
    """Reverse mode through the XLA moment scan (the self-consistency
    backward pass) against a central difference along a random Hermitian
    direction of the operator."""
    lattice, system = random_system((6, 4, 1), np.complex128, pbc, seed=5)
    sk = system.skeleton
    data = jnp.asarray(system.data)
    rng = np.random.default_rng(3)
    v0 = jnp.asarray((rng.normal(size=(lattice.size, 4, 2))
                      + 1j * rng.normal(size=(lattice.size, 4, 2))))
    order, inv = 24, jnp.asarray(1.0 / 8.0)
    w = jnp.asarray(np.linspace(1.0, 0.1, order))

    def loss(d):
        mu = kpm._moments_scan(d, sk, v0, inv, order, impl)
        return jnp.sum(w[:, None] * mu)

    g = jax.grad(loss)(data)
    assert g.shape == data.shape

    # A perturbation that keeps every structural zero at zero.
    u = (rng.normal(size=data.shape) + 1j * rng.normal(size=data.shape))
    u = jnp.asarray(u * (np.abs(system.host_data()) > 0))
    h = 1e-6
    fd = (float(loss(data + h * u)) - float(loss(data - h * u))) / (2 * h)
    # JAX's gradient of a real loss w.r.t. complex input z is ∂L/∂x − i∂L/∂y,
    # so the directional derivative along u is Re Σ g·u.
    an = float(jnp.sum(jnp.real(g * u)))
    assert np.isclose(an, fd, rtol=1e-6, atol=1e-8), (an, fd)


REMOVED_IMPLS = ["pallas", "pallas_gather", "pallas_unfused", "planar", "pallas_sharded"]


def _swave(shape=(8, 4, 1)):
    lattice = CubicLattice(shape)
    system = Hamiltonian(lattice)
    system.assemble(
        onsite=lambda ci: -0.5 * σ0,
        pairing_onsite=lambda ci: 0.3 * jσ2,
        hopping=lambda ci, cj: -1.0 * σ0,
    )
    return lattice, system


_ENTRY_POINTS = {
    "spmm": lambda s, impl: spmm(s.data, s.skeleton, np.ones((s.lattice.size, 4, 1)), impl=impl),
    "apply": lambda s, impl: s.apply(np.ones((s.lattice.size, 4, 1)), impl=impl),
    "free_energy": lambda s, impl: s.free_energy(0.1, method="kpm", order=16, samples=2, impl=impl),
    "ldos": lambda s, impl: s.ldos((1, 1, 0), [0.0, 0.5], method="kpm", order=16, impl=impl),
    "lowest_eigenstates": lambda s, impl: lz.lowest_eigenstates(s.host_data(), s.skeleton, 4, impl=impl),
    "self_consistency": lambda s, impl: sc.make_total_free_energy(s, V=1.0, method="kpm", impl=impl),
}


@pytest.mark.parametrize("entry", list(_ENTRY_POINTS))
@pytest.mark.parametrize("impl", REMOVED_IMPLS)
def test_removed_impl_raises(impl, entry):
    """A removed implementation name fails loudly, with no fallback."""
    _, system = _swave((24, 12, 1))
    with pytest.raises(ValueError, match="Unknown SpMM implementation"):
        _ENTRY_POINTS[entry](system, impl)


def test_device_eigh_failure_raises(monkeypatch):
    """XLA's eigh reports a solver failure as NaN outputs; the facade turns
    that into an error instead of a host fallback or a NaN spectrum."""
    _, system = _swave((4, 4, 1))

    def failed(data, sk, sectors, vectors):
        n = 4 * sk.n_sites
        return jnp.full((n,), jnp.nan), jnp.full((n, n), jnp.nan, data.dtype)

    monkeypatch.setattr(dense_ops, "_eigh_sectors", failed)
    with pytest.raises(RuntimeError, match="device eigh failed"):
        system.diagonalize()
    with pytest.raises(RuntimeError, match="device eigh failed"):
        system.free_energy(0.1)


def _zeeman_swave(shape, transverse=0.0):
    """The README quickstart's s-wave + Zeeman system; a transverse (σ1)
    field couples the two spin sectors."""
    lattice = CubicLattice(shape)
    system = Hamiltonian(lattice)
    with system as (H, Δ):
        for i in lattice.sites():
            H[i, i] = 3 * σ0 - 0.05 * σ3 - transverse * σ1
            Δ[i, i] = -0.1 * jσ2
        for i, j in lattice.bonds():
            H[i, j] = -1 * σ0
    return lattice, system


@pytest.mark.parametrize("transverse, n_sectors", [(0.0, 2), (0.02, 1)])
def test_decoupled_sectors(transverse, n_sectors):
    lattice, system = _zeeman_swave((5, 3, 1), transverse)
    sectors = dense_ops.decoupled_sectors(system.data, system.skeleton)
    assert len(sectors) == n_sectors
    assert np.array_equal(np.sort(np.concatenate(sectors)), np.arange(4 * lattice.size))
    if n_sectors == 2:
        # (e↑, h↓) and (e↓, h↑) on every site: orbitals 0, 3 and 1, 2 mod 4.
        assert set(np.unique(sectors[0] % 4)) == {0, 3}
        assert set(np.unique(sectors[1] % 4)) == {1, 2}


@pytest.mark.parametrize("transverse", [0.0, 0.02])
def test_sector_eigh_matches_lapack(transverse):
    """Solving each decoupled sector and merging gives the full spectrum
    and a complete orthonormal eigenbasis of the whole operator."""
    _, system = _zeeman_swave((6, 4, 1), transverse)
    H = system.matrix("dense")
    E, X = dense_ops.eigh_device(system.data, system.skeleton)
    X = np.asarray(X)
    np.testing.assert_allclose(E, np.linalg.eigvalsh(H), atol=1e-10)
    np.testing.assert_allclose(H @ X, X * E[None, :], atol=1e-10)
    np.testing.assert_allclose(X.conj().T @ X, np.eye(H.shape[0]), atol=1e-10)
    np.testing.assert_allclose(
        dense_ops.eigvalsh_device(system.data, system.skeleton), E, atol=1e-12
    )


def test_gpu_eigh_refuses_sectors_beyond_cusolver(monkeypatch):
    """On the GPU a sector larger than cuSOLVER takes is a clear error that
    names the alternatives, not a solver crash or a host fallback."""
    monkeypatch.setattr(dense_ops, "_on_gpu", lambda: True)
    monkeypatch.setattr(dense_ops, "GPU_EIGH_MAX_DIM", 40)
    _, split = _zeeman_swave((5, 4, 1))  # two sectors of 40
    assert dense_ops.eigvalsh_device(split.data, split.skeleton).size == 80
    _, joined = _zeeman_swave((5, 4, 1), transverse=0.02)  # one sector of 80
    with pytest.raises(ValueError, match="largest sector is 80.*banded"):
        joined.diagonalize()


def test_device_eigh_matches_lapack():
    _, system = _swave((5, 4, 1))
    E, X = dense_ops.eigh_device(system.data, system.skeleton)
    E_ref = np.linalg.eigvalsh(system.matrix("dense"))
    np.testing.assert_allclose(E, E_ref, atol=1e-10)
    np.testing.assert_allclose(
        dense_ops.eigvalsh_device(system.data, system.skeleton), E_ref, atol=1e-10
    )
    H = system.matrix("dense")
    X = np.asarray(X)
    np.testing.assert_allclose(H @ X, X * E[None, :], atol=1e-10)


class _FakeDevice:
    def __init__(self, kind):
        self.device_kind = kind


def test_peak_table_known_kind():
    peaks = profiling.peaks_for_device(_FakeDevice("NVIDIA H100 80GB HBM3"))
    assert peaks.hbm_bytes_per_s == 3.35e12
    assert peaks.hbm_bytes == 80e9
    assert (peaks.fp32_flops, peaks.tf32_flops, peaks.bf16_flops, peaks.fp64_flops) == (
        67e12, 495e12, 989e12, 34e12
    )
    assert "data sheet" in peaks.source


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", "NVIDIA H200"])
def test_peak_table_unknown_kind_raises(kind):
    with pytest.raises(KeyError, match="no published peaks"):
        profiling.peaks_for_device(_FakeDevice(kind))


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_fixed_in_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = __file__.rsplit("/tests/", 1)[0]
    bodge_tpu._enable_persistent_compile_cache()
    assert jax.config.jax_compilation_cache_dir == f"{root}/.jax_cache"
    with open(f"{root}/.gitignore") as f:
        assert ".jax_cache/" in f.read().split()


def test_compile_cache_honours_env(monkeypatch, tmp_path, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", str(tmp_path))
    bodge_tpu._enable_persistent_compile_cache()
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)
