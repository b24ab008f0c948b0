"""Chebyshev / kernel-polynomial (KPM) spectral expansion.

[NEW SCOPE] — the reference computes LDOS with a per-energy sparse-LU
resolvent solve (``bodge/hamiltonian.py:323-387``), which has no
accelerator analog in JAX.  This module computes the same observables through Chebyshev
polynomial expansion driven by repeated block-sparse SpMM — the classic
KPM (Weiße et al., Rev. Mod. Phys. 78, 275 (2006)) reformulated for XLA:
static-order `lax.scan` recursions over stencil SpMMs, Jackson/Lorentz
kernel damping, and batched probe vectors.

Pieces:

- :func:`spectral_bound` — power-iteration estimate of ‖H‖₂ used to map
  the spectrum into [−1, 1].
- :func:`moments` — μ_m = ⟨v₀|T_m(H̃)|v₀⟩ for a batch of probe vectors via
  the three-term recursion (one SpMM per order).
- :func:`ldos_kpm` — local density of states from one site's four orbital
  probes.
- :func:`free_energy_kpm` — Landau free energy as ½ Tr G(H) with
  G(E) = −|E|/2 − T·log(1+e^(−|E|/T)), via Chebyshev fitting of G and
  (exact or stochastic Hutchinson) trace estimation.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from .blocksparse import BLOCK, Skeleton
from .spmm import check_impl, spmm

DEFAULT_ORDER = 512


def _rescaled_op(data, sk: Skeleton, inv_scale, impl: str):
    def H_tilde(v):
        return spmm(data, sk, v, impl=impl) * inv_scale

    return H_tilde


def spectral_bound(data, sk: Skeleton, iters: int = 60, key=None, impl: str = "stencil"):
    """Estimate ‖H‖₂ by power iteration on the Hermitian operator.

    The Rayleigh-quotient estimate never overshoots λ_max but can sit
    slightly below it when the top of the spectrum clusters; the returned
    bound is inflated by 5% (standard KPM practice) so spec(H/a) ⊂ (−1, 1)
    robustly — Chebyshev recursions diverge exponentially if any
    eigenvalue escapes the interval.
    """
    check_impl(impl)
    if key is None:
        key = jax.random.PRNGKey(0)
    N = sk.n_sites
    v = jax.random.normal(key, (N, BLOCK, 1), dtype=data.dtype)
    return float(_power_iteration(data, sk, v, iters, impl)) * 1.05


def _host_dtype(data) -> np.dtype:
    return np.dtype(data.dtype)


def rademacher_probes(N, samples, key, dtype, default_seed=42) -> np.ndarray:
    """Deterministic host-side Rademacher probes ``[N, 4, samples]``.

    Built in NumPy (device backends need not support complex RNG) and
    shared by the single-device and sharded trace estimators so identical
    keys give identical estimates.  Accepts raw uint32 and typed JAX PRNG
    keys alike; the seed folds in every key word (advisor finding: a
    last-word-only seed collapsed distinct keys onto identical probes).
    """
    if key is None:
        seed = default_seed
    else:
        try:  # typed PRNG keys cannot be np.asarray'd directly
            raw = np.asarray(jax.random.key_data(key))
        except Exception:
            raw = np.asarray(key)
        seed = int(np.sum(raw.astype(np.uint64))) & 0x7FFFFFFF
    rng = np.random.default_rng(seed)
    z = 2.0 * rng.integers(0, 2, size=(N, BLOCK, samples)) - 1.0
    return z.astype(dtype)


@partial(jax.jit, static_argnames=("sk", "iters", "impl"))
def _power_iteration(data, sk: Skeleton, v, iters: int, impl: str):
    def step(v, _):
        w = spmm(data, sk, v, impl=impl)
        norm = jnp.linalg.norm(w)
        return w / norm, norm

    _, norms = lax.scan(step, v / jnp.linalg.norm(v), None, length=iters)
    return norms[-1].real


def _doubled_moment_scan(H, inner, v0, order: int):
    """Shared moment recursion with the product doubling trick.

    One SpMM yields TWO moments via the Chebyshev product identities
    T_{2m} = 2·T_m² − 1 and T_{2m+1} = 2·T_{m+1}·T_m − T_1:

        μ_{2m}   = 2⟨t_m, t_m⟩     − μ_0
        μ_{2m+1} = 2⟨t_{m+1}, t_m⟩ − μ_1

    halving the SpMM count versus the plain three-term recursion (Weiße et
    al. RMP 78, 275, Sec. II-D).  ``inner`` must be the *real* inner
    product (psum-reduced in sharded callers).
    """
    t0 = v0
    t1 = H(v0)
    mu0 = inner(v0, t0)
    mu1 = inner(v0, t1)

    steps = max(0, (order - 2 + 1) // 2)  # ceil((order-2)/2)

    def step(carry, _):
        t_prev, t_cur = carry
        t_next = 2.0 * H(t_cur) - t_prev
        alpha = 2.0 * inner(t_cur, t_cur) - mu0  # μ_{2m}
        beta = 2.0 * inner(t_next, t_cur) - mu1  # μ_{2m+1}
        return (t_cur, t_next), (alpha, beta)

    if steps == 0:
        return jnp.stack([mu0, mu1])[:order]
    (_, _), (alphas, betas) = lax.scan(step, (t0, t1), None, length=steps)
    # Interleave (μ_2, μ_3), (μ_4, μ_5), ...
    rest = jnp.stack([alphas, betas], axis=1).reshape(2 * steps, *mu0.shape)
    return jnp.concatenate([mu0[None], mu1[None], rest], axis=0)[:order]


@partial(jax.jit, static_argnames=("sk", "order", "impl"))
def _moments_scan(data, sk: Skeleton, v0, inv_scale, order: int, impl: str):
    """μ_m[k] = Re ⟨v0_k | T_m(H̃) | v0_k⟩ for all K probe columns at once."""
    H = _rescaled_op(data, sk, inv_scale, impl)

    def inner(a, b):
        return jnp.real(jnp.sum(jnp.conj(a) * b, axis=(0, 1)))

    return _doubled_moment_scan(H, inner, v0, order)  # [order, K]


# Identity trace probes materialize a (4N)² dense array; past this many
# orbitals that silently becomes a multi-GB host allocation (round-1 review
# finding), so demand an explicit stochastic estimator instead.
MAX_EXACT_TRACE_ORBITALS = 8192


def _identity_probes(N: int, dtype, what: str) -> np.ndarray:
    if N * BLOCK > MAX_EXACT_TRACE_ORBITALS:
        raise ValueError(
            f"samples=None requests exact-trace probes: a {4 * N}×{4 * N} "
            f"identity (> {MAX_EXACT_TRACE_ORBITALS} orbitals). Pass "
            f"samples=<int> for a stochastic {what} on systems this large."
        )
    return np.eye(N * BLOCK, dtype=dtype).reshape(N, BLOCK, N * BLOCK)


def moments(data, sk: Skeleton, v0, order: int, scale: float, impl: str = "stencil"):
    """Chebyshev moments of H/scale against probe vectors ``v0: [N, 4, K]``:
    ``μ_m[k] = Re ⟨v0_k | T_m(H/scale) | v0_k⟩``, shape ``[order, K]``."""
    check_impl(impl)
    inv = jnp.asarray(1.0 / scale, dtype=jnp.real(jnp.zeros((), data.dtype)).dtype)
    return _moments_scan(data, sk, v0, inv, order, impl)


def jackson_kernel(order: int) -> np.ndarray:
    """Jackson damping coefficients g_m (positivity-preserving)."""
    m = np.arange(order)
    M = order + 1
    return (
        (M - m) * np.cos(np.pi * m / M) + np.sin(np.pi * m / M) / np.tan(np.pi / M)
    ) / M


def lorentz_kernel(order: int, lam: float = 4.0) -> np.ndarray:
    """Lorentz damping coefficients (resolvent-like broadening)."""
    m = np.arange(order)
    return np.sinh(lam * (1 - m / order)) / np.sinh(lam)


_KERNELS = {"jackson": jackson_kernel, "lorentz": lorentz_kernel, "none": lambda M: np.ones(M)}


def reconstruct_density(mu, energies_scaled, scale: float, kernel: str = "jackson"):
    """KPM density reconstruction ρ(ε) from damped moments.

    Args:
        mu: ``[order, K]`` moments.
        energies_scaled: x = ε/scale in (−1, 1), shape ``[M]``.
        scale: the Chebyshev scale `a` (restores 1/a measure factor).
        kernel: damping kernel name.

    Returns:
        ``[M, K]`` densities.
    """
    order = mu.shape[0]
    g = jnp.asarray(_KERNELS[kernel](order))
    x = jnp.asarray(energies_scaled)
    m = jnp.arange(order)
    # T_m(x) = cos(m·arccos x), evaluated for all orders at once.
    Tmx = jnp.cos(m[None, :] * jnp.arccos(x)[:, None])  # [M, order]
    weights = jnp.where(m == 0, 1.0, 2.0) * g
    series = jnp.matmul(Tmx, weights[:, None] * mu, precision=lax.Precision.HIGHEST)  # [M, K]
    return series / (np.pi * scale * jnp.sqrt(1.0 - x[:, None] ** 2))


LORENTZ_LAMBDA = 4.0


def ldos_site_probes(N: int, site_indices, dtype) -> np.ndarray:
    """One-hot orbital probes for LDOS: ``[N, 4, 4·n_sites]`` with a unit
    column per (site, orbital).  Shared by the single-device and sharded
    LDOS paths so the probe convention cannot diverge."""
    site_indices = np.asarray(site_indices, dtype=np.int64)
    n_sites = len(site_indices)
    K = BLOCK * n_sites
    v0 = np.zeros((N, BLOCK, K), dtype=dtype)
    cols = np.arange(K)
    v0[np.repeat(site_indices, BLOCK), np.tile(np.arange(BLOCK), n_sites), cols] = 1.0
    return v0


def ldos_from_moments(mu, energies, scale: float, kernel: str, n_sites: int) -> np.ndarray:
    """Electron-component LDOS ``[n_sites, n_energies]`` from the moments of
    :func:`ldos_site_probes` probes (shared reconstruction tail)."""
    energies = np.array(energies, dtype=float)
    x = np.clip(energies / scale, -0.999999, 0.999999)
    dens = np.asarray(reconstruct_density(mu, jnp.asarray(x), scale, kernel=kernel))
    dens = dens.reshape(len(energies), n_sites, BLOCK)
    return (dens[:, :, 0] + dens[:, :, 1]).T


def ldos_kpm(
    data,
    sk: Skeleton,
    site_index: int,
    energies,
    order: Optional[int] = None,
    kernel: str = "jackson",
    scale: Optional[float] = None,
    eta: Optional[float] = None,
    impl: str = "stencil",
) -> np.ndarray:
    """Local density of states at one site via KPM.

    Probes the four orbitals {e↑, e↓, h↑, h↓} of ``site_index`` with unit
    vectors and sums the electron components; by particle-hole symmetry
    this matches the reference's ± convention (``bodge/hamiltonian.py:
    377-382``) for any signed probe energy.

    Passing ``eta`` requests a target Lorentzian broadening: the Lorentz
    kernel is selected and the expansion order is chosen as λ·a/η, which
    reproduces the resolvent at ε+iη — the direct analog of the
    reference's broadened sparse solve.
    """
    if scale is None:
        scale = spectral_bound(data, sk, impl=impl)
    if eta is not None:
        kernel = "lorentz"
        if order is None:
            order = max(8, int(np.ceil(LORENTZ_LAMBDA * scale / eta)))
    order = order or DEFAULT_ORDER

    N = sk.n_sites
    # Probes built host-side: a one-hot build is free on the host.
    dtype = _host_dtype(data)
    v0 = np.zeros((N, BLOCK, BLOCK), dtype=dtype)
    v0[site_index, np.arange(BLOCK), np.arange(BLOCK)] = 1.0

    mu = moments(data, sk, v0, order, scale, impl=impl)  # [order, 4]
    energies = np.array(energies, dtype=float)
    x = np.clip(energies / scale, -0.999999, 0.999999)
    dens = reconstruct_density(mu, jnp.asarray(x), scale, kernel=kernel)  # [M, 4]
    ρ_e = np.asarray(dens[:, 0] + dens[:, 1])
    return ρ_e


def ldos_kpm_sites(
    data,
    sk: Skeleton,
    site_indices,
    energies,
    order: Optional[int] = None,
    kernel: str = "jackson",
    scale: Optional[float] = None,
    eta: Optional[float] = None,
    impl: str = "stencil",
) -> np.ndarray:
    """Batched KPM LDOS for many sites in one moment sweep.

    All 4·n_sites orbital probes ride a single Chebyshev scan as extra SpMM
    columns, so an LDOS *map* costs barely more than one site.
    Returns ``[n_sites, n_energies]`` (electron component, as in
    :func:`ldos_kpm`).
    """
    if scale is None:
        scale = spectral_bound(data, sk, impl=impl)
    if eta is not None:
        kernel = "lorentz"
        if order is None:
            order = max(8, int(np.ceil(LORENTZ_LAMBDA * scale / eta)))
    order = order or DEFAULT_ORDER

    site_indices = np.asarray(site_indices, dtype=np.int64)
    n_sites = len(site_indices)
    dtype = _host_dtype(data)
    v0 = ldos_site_probes(sk.n_sites, site_indices, dtype)

    mu = moments(data, sk, v0, order, scale, impl=impl)  # [order, 4·n_sites]
    energies = np.array(energies, dtype=float)
    x = np.clip(energies / scale, -0.999999, 0.999999)
    dens = np.asarray(reconstruct_density(mu, jnp.asarray(x), scale, kernel=kernel))
    dens = dens.reshape(len(energies), n_sites, BLOCK)
    return (dens[..., 0] + dens[..., 1]).T  # electron ↑+↓ per site


def dos_kpm(
    data,
    sk: Skeleton,
    energies,
    order: Optional[int] = None,
    kernel: str = "jackson",
    scale: Optional[float] = None,
    eta: Optional[float] = None,
    samples: Optional[int] = 16,
    key=None,
    impl: str = "stencil",
) -> np.ndarray:
    """Total density of states Tr δ(ε−H) via KPM.

    [NEW SCOPE] — no reference counterpart; the global analog of
    :func:`ldos_kpm`.  With ``samples=None`` the trace probes are the full
    identity (exact, small systems only); otherwise ``samples`` Rademacher
    vectors give an unbiased stochastic estimate.  Counts all 4N Nambu⊗Spin
    orbitals (particle-hole symmetric around ε = 0).
    """
    if scale is None:
        scale = spectral_bound(data, sk, impl=impl)
    if eta is not None:
        kernel = "lorentz"
        if order is None:
            order = max(8, int(np.ceil(LORENTZ_LAMBDA * scale / eta)))
    order = order or DEFAULT_ORDER

    N = sk.n_sites
    dtype = _host_dtype(data)
    if samples is None:
        v0 = _identity_probes(N, dtype, "DOS")
        norm = 1.0
    else:
        v0 = rademacher_probes(N, samples, key, dtype, default_seed=1)
        norm = 1.0 / samples

    mu = moments(data, sk, v0, order, scale, impl=impl)  # [order, K]
    mu_tr = jnp.sum(mu, axis=1) * norm  # trace estimate per order

    energies = np.array(energies, dtype=float)
    x = np.clip(energies / scale, -0.999999, 0.999999)
    dens = reconstruct_density(mu_tr[:, None], jnp.asarray(x), scale, kernel=kernel)
    return np.asarray(dens[:, 0])


def chebyshev_coefficients(fn, order: int, quad_points: Optional[int] = None) -> np.ndarray:
    """Chebyshev-series coefficients of ``fn`` on [−1, 1] via Gauss quadrature."""
    Q = quad_points or max(2 * order, 256)
    theta = np.pi * (np.arange(Q) + 0.5) / Q
    fx = fn(np.cos(theta))
    m = np.arange(order)
    c = 2.0 / Q * np.cos(np.outer(m, theta)) @ fx
    c[0] /= 2.0
    return c


@partial(jax.jit, static_argnames=("sk", "order", "impl"))
def _trace_fn_scan(data, sk: Skeleton, probes, coeffs, inv_scale, order: int, impl: str):
    """Σ_m c_m ⟨z_k|T_m(H̃)|z_k⟩ summed over k (doubled-moment scan)."""
    H = _rescaled_op(data, sk, inv_scale, impl)

    def inner(a, b):
        return jnp.real(jnp.sum(jnp.conj(a) * b))

    mu = _doubled_moment_scan(H, inner, probes, order)  # [order]
    return jnp.dot(coeffs[: mu.shape[0]], mu, precision=lax.Precision.HIGHEST)


def trace_function(
    data,
    sk: Skeleton,
    fn,
    order: int,
    scale: float,
    samples: Optional[int] = None,
    key=None,
    kernel: str = "jackson",
    impl: str = "stencil",
) -> float:
    """Tr fn(H) by Chebyshev expansion.

    With ``samples=None`` the trace is exact: probes are the full identity,
    batched as K = 4N columns (refused above
    :data:`MAX_EXACT_TRACE_ORBITALS` orbitals — O((4N)²) memory).
    Otherwise a Hutchinson estimator with ``samples`` Rademacher vectors is
    used — unbiased, with O(1/√samples) stochastic error.
    """
    check_impl(impl)
    coeffs = chebyshev_coefficients(lambda x: fn(scale * x), order)
    coeffs = coeffs * _KERNELS[kernel](order)
    N = sk.n_sites

    dtype = _host_dtype(data)
    if samples is None:
        probes = _identity_probes(N, dtype, "trace")
        norm = 1.0
    else:
        probes = rademacher_probes(N, samples, key, dtype)
        norm = 1.0 / samples

    coeffs = jnp.asarray(coeffs)
    rdtype = jnp.real(jnp.zeros((), data.dtype)).dtype
    inv = jnp.asarray(1.0 / scale, dtype=rdtype)
    est = _trace_fn_scan(data, sk, jnp.asarray(probes), coeffs, inv, order, impl)
    return float(est) * norm


def free_energy_kpm(
    data,
    sk: Skeleton,
    temperature: float = 0.0,
    order: int = DEFAULT_ORDER,
    samples: Optional[int] = None,
    key=None,
    scale: Optional[float] = None,
    impl: str = "stencil",
) -> float:
    """Landau free energy F = U − T·S without diagonalization.

    Uses F = ½ Tr G(H) with G(E) = −|E|/2 − T·log(1+e^(−|E|/T)): summing
    G over the positive spectrum (the reference formula,
    ``bodge/hamiltonian.py:305-319``) equals half the trace over the full
    particle-hole-symmetric spectrum.  Scales as O(order · nnz) — the
    large-lattice path where dense eigh is infeasible.
    """
    T = float(temperature)
    if T < 0:
        raise ValueError("Expected non-negative temperature!")
    if scale is None:
        scale = spectral_bound(data, sk, impl=impl)

    if T == 0:
        g = lambda E: -np.abs(E) / 2
    else:
        g = lambda E: -np.abs(E) / 2 - T * np.log1p(np.exp(-np.abs(E) / T))

    tr = trace_function(
        data, sk, g, order, scale, samples=samples, key=key, impl=impl,
    )
    return 0.5 * tr
