"""Dense spectral solvers: diagonalization, free energy, exact-resolvent LDOS.

These are the XLA equivalents of the reference's dense solver layer:

- ``eigh_positive``: `jnp.linalg.eigh` + positive-spectrum extraction.  JAX
  has no ``subset_by_value`` (reference: ``bodge/hamiltonian.py:228-230``),
  so we compute the full spectrum and keep the upper half — by particle-hole
  symmetry the BdG spectrum comes in ±ε pairs, so the ascending upper half
  *is* the positive subset, with static shapes that jit cleanly.
- ``free_energy_from_spectrum``: F = U − T·S with U = −½Σε and
  S = Σ log(1+e^(−ε/T)) over positive ε (``bodge/hamiltonian.py:305-319``,
  Appendix C of Ouassou et al. PRB 109, 174506).
- ``ldos_exact``: the reference computes LDOS by solving
  [(ε+iΓ)I − H] X = B with a sparse LU per energy
  (``bodge/hamiltonian.py:323-387``).  JAX has no sparse LU; for the
  same *exact* observable we evaluate the resolvent spectrally:
  G_αα(ε+iΓ) = Σ_n |X_{iα,n}|² / (ε+iΓ−E_n), which is identical to the
  solve because both compute the exact diagonal resolvent elements.
  ρ(+ε) comes from the electron components and ρ(−ε) from the hole
  components at the same positive ε (particle-hole trick, reference
  ``hamiltonian.py:349, 377-382``).
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

import scipy.sparse.csgraph as csgraph

from .blocksparse import BLOCK, Skeleton, ell_to_bsr, ell_to_dense_jnp

# JAX's GPU eigh (cuSOLVER's syevBatched) refuses dim 32 768 and above, and
# so do cuSOLVER's own divide-and-conquer drivers behind it (syevd and
# syevdx reject dim 40 000 at their workspace query).
GPU_EIGH_MAX_DIM = 32767


def _on_gpu() -> bool:
    return jax.default_backend() == "gpu"


def _eigh_hermitian(H):
    """``(E, X)`` of Hermitian ``H``: ``E`` ascending, eigenvectors as
    columns.  The input is Hermitian by construction (assembly checks it),
    so it is not symmetrized first, which would hold a second dim² copy."""
    X, E = lax.linalg.eigh(H, symmetrize_input=False)
    return E, X


_eigh = jax.jit(_eigh_hermitian)


def decoupled_sectors(data, sk: Skeleton) -> tuple:
    """Orbital index sets of the blocks the operator decouples into: the
    connected components of its nonzero pattern, each ascending.

    An s-wave operator with a spin-diagonal normal part splits into the
    (e↑, h↓) and (e↓, h↑) sectors, each half the dimension; spin-orbit
    coupling or a transverse field joins them into one.
    """
    A = abs(ell_to_bsr(np.asarray(data), sk).tocsr())  # real weights for csgraph
    A.eliminate_zeros()
    n_sectors, labels = csgraph.connected_components(A, directed=False)
    counts = np.bincount(labels, minlength=n_sectors)
    return tuple(np.split(np.argsort(labels, kind="stable"), np.cumsum(counts)[:-1]))


# Densify and solve in one program, so XLA can hand the dense matrix to the
# solver in place instead of holding a second dim² copy — at dim 40 000
# that copy is 12.8 GB in complex64.  Each decoupled sector is solved on
# its own and the eigenpairs are merged in ascending order.
@partial(jax.jit, static_argnames=("sk", "vectors"))
def _eigh_sectors(data, sk: Skeleton, sectors, vectors: bool):
    H = ell_to_dense_jnp(data, sk)
    if len(sectors) == 1:
        E, X = _eigh_hermitian(H)
        return E, X if vectors else None
    parts = [
        _eigh_hermitian(jnp.take(jnp.take(H, idx, axis=0), idx, axis=1)) for idx in sectors
    ]
    E = jnp.concatenate([E_s for E_s, _ in parts])
    order = jnp.argsort(E)
    if not vectors:
        return E[order], None
    X, start = jnp.zeros_like(H), 0
    for idx, (_, X_s) in zip(sectors, parts):
        X = X.at[idx, start : start + idx.size].set(X_s)
        start += idx.size
    return E[order], X[:, order]


def _solve(data, sk: Skeleton, vectors: bool):
    sectors = decoupled_sectors(data, sk)
    largest = max(s.size for s in sectors)
    if _on_gpu() and largest > GPU_EIGH_MAX_DIM:
        raise ValueError(
            f"dense eigh on the GPU takes dim ≤ {GPU_EIGH_MAX_DIM} per decoupled "
            f"sector; this operator's largest sector is {largest}. Use "
            "method='banded', 'lanczos' or 'shift_invert', or the KPM observables."
        )
    E, X = _eigh_sectors(jnp.asarray(data), sk, tuple(jnp.asarray(s) for s in sectors), vectors)
    E = np.asarray(E)
    # XLA's eigh reports a failed solve as NaN outputs instead of raising.
    if not np.isfinite(E).all():
        raise RuntimeError(f"device eigh failed: non-finite eigenvalues at dim {E.size}")
    return E, X


def eigh_device(data, sk: Skeleton):
    """Full eigendecomposition ``(E, X)`` of the ELL operator on the
    device (ascending ``E``, eigenvectors as columns of ``X``), solved
    sector by sector (:func:`decoupled_sectors`).  Raises ``RuntimeError``
    if the device solver failed."""
    return _solve(data, sk, vectors=True)


def eigvalsh_device(data, sk: Skeleton) -> np.ndarray:
    """All eigenvalues of the ELL operator on the device, ascending.
    Raises ``RuntimeError`` if the device solver failed."""
    return _solve(data, sk, vectors=False)[0]


def eigh_positive(H):
    """Eigenvalues/vectors of Hermitian ``H``, restricted to the upper half.

    Returns ``(E, X)`` with E ascending, ``X[:, n]`` the eigenvector of
    ``E[n]``; exactly ``dim/2`` pairs are returned (Nambu doubling).
    """
    E, X = _eigh(H)
    half = H.shape[-1] // 2
    return E[half:], X[:, half:]


def free_energy_from_spectrum(E_pos, temperature: float):
    """Landau free energy from the positive BdG spectrum."""
    T = float(temperature)
    if T < 0:
        raise ValueError("Expected non-negative temperature!")
    U = -0.5 * jnp.sum(E_pos)
    if T == 0:
        return U
    S = jnp.sum(jnp.log1p(jnp.exp(-E_pos / T)))
    return U - T * S


@jax.jit
def _resolvent_ldos(E, w_e, w_h, energies, gammas):
    """ρ(±ε_n) from spectral weights at one site.

    Args:
        E: full spectrum ``[4N]``.
        w_e / w_h: electron / hole weights ``[4N]`` at the probed site
            (|X|² summed over spin).
        energies: positive probe energies ``[M]``.
        gammas: Lorentzian broadenings ``[M]``.

    Returns:
        ``(ρ_plus, ρ_minus)`` each ``[M]``.
    """
    z = energies[:, None] + 1j * gammas[:, None]  # [M, 1]
    denom = z - E[None, :]  # [M, 4N]
    G_e = jnp.sum(w_e[None, :] / denom, axis=1)
    G_h = jnp.sum(w_h[None, :] / denom, axis=1)
    ρ_plus = -jnp.imag(G_e) / jnp.pi
    ρ_minus = -jnp.imag(G_h) / jnp.pi
    return ρ_plus, ρ_minus


def ldos_from_spectrum(E, X, site_index: int, energies) -> np.ndarray:
    """LDOS at one site from a precomputed full eigendecomposition.

    Mirrors the reference's observable and broadening convention: probe
    energies are deduplicated by |ε| and the broadening is the grid spacing
    Γ = gradient(ε) (``bodge/hamiltonian.py:349-352``).
    """
    energies = np.array(energies, dtype=float)
    ε = np.unique(np.abs(energies))
    Γ = np.gradient(ε)

    i0 = BLOCK * site_index
    amp2 = jnp.abs(X[i0 : i0 + 4, :]) ** 2  # [4, 4N]
    w_e = amp2[0] + amp2[1]
    w_h = amp2[2] + amp2[3]

    ρ_plus, ρ_minus = _resolvent_ldos(E, w_e, w_h, jnp.asarray(ε), jnp.asarray(Γ))
    ρ_plus = np.asarray(ρ_plus)
    ρ_minus = np.asarray(ρ_minus)

    table = {}
    for k, ε_k in enumerate(ε):
        table[+ε_k] = ρ_plus[k]
        table[-ε_k] = ρ_minus[k]
    return np.array([table[ε_k] for ε_k in energies])


def ldos_exact(H_dense, site_index: int, energies) -> np.ndarray:
    """Local density of states at one site, exact to numerical precision."""
    E, X = _eigh(H_dense)
    return ldos_from_spectrum(E, X, site_index, energies)
