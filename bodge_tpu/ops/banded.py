"""Banded Hermitian eigensolver for lattice BdG Hamiltonians.

Why this exists
---------------
A real-space tight-binding Hamiltonian on an open cubic lattice is not just
sparse — it is *banded*: with the reference's row-major site index
``z + y·Lz + x·Ly·Lz`` (``bodge/lattice.py:108``), every hopping couples
scalar indices at most ``4·Ly·Lz + 3`` apart.  Dense diagonalization
(the reference's ``scipy.linalg.eigh``, ``bodge/hamiltonian.py:228-230``)
costs O((4N)³) and is hopeless at the 100×100 headline size (a 40 000²
matrix, ~20 h on a workstation CPU); LAPACK's banded drivers (``?hbevd``)
reduce band→tridiagonal in O((4N)²·b) instead, a ~100× win at that size
while remaining *exact* — the same spectrum, not an approximation.

The eigen-problem is invariant under symmetric permutations, so before
packing the band we relabel sites with reverse Cuthill–McKee to minimize the
bandwidth; this makes the path effective for any site ordering and for
generic (non-cubic) skeletons, and it handles e.g. transposed extents
((4, 256, 1) vs (256, 4, 1)) identically.

Periodic wrap links raise the bandwidth to O(N); the solver still works but
degrades toward dense cost, so callers can check :func:`scalar_bandwidth`
(or use ``method="auto"``) to decide.  Only *structurally nonzero* blocks
count toward the bandwidth: open-boundary skeletons store wrap slots as
zero blocks (see ``blocksparse.skeleton``), and those must not inflate it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import scipy.linalg as sla
import scipy.sparse as sp
from scipy.sparse.csgraph import reverse_cuthill_mckee

from .blocksparse import BLOCK, Skeleton

__all__ = [
    "nonzero_block_mask",
    "block_permutation",
    "scalar_bandwidth",
    "pack_band_lower",
    "eigvalsh_banded",
    "eigh_banded",
]


def nonzero_block_mask(data: np.ndarray, sk: Skeleton) -> np.ndarray:
    """``[N, S]`` bool — slots that are valid AND numerically nonzero.

    The diagonal slot is always kept so every row stays represented even in
    an all-zero Hamiltonian.
    """
    data = np.asarray(data)
    mask = sk.valid & np.any(data != 0, axis=(2, 3))
    mask[:, 0] = sk.valid[:, 0]
    return mask


def block_permutation(
    sk: Skeleton, mask: Optional[np.ndarray] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Bandwidth-minimizing site relabeling via reverse Cuthill–McKee.

    Returns ``(rank, bwb)``: ``rank[i]`` is the new block index of site
    ``i``, and ``bwb`` the resulting block bandwidth.  Whichever of RCM and
    the natural order gives the smaller bandwidth wins (RCM is a heuristic;
    for a well-ordered cubic lattice the natural order is already optimal).
    """
    N = sk.n_sites
    if mask is None:
        mask = sk.valid
    rows = np.repeat(np.arange(N, dtype=np.int64), mask.sum(axis=1))
    cols = sk.cols[mask].astype(np.int64)
    adj = sp.csr_matrix((np.ones(rows.size, np.int8), (rows, cols)), shape=(N, N))
    natural_bw = int(np.abs(rows - cols).max()) if rows.size else 0

    perm = np.asarray(reverse_cuthill_mckee(adj, symmetric_mode=True), dtype=np.int64)
    rank = np.empty(N, dtype=np.int64)
    rank[perm] = np.arange(N, dtype=np.int64)
    rcm_bw = int(np.abs(rank[rows] - rank[cols]).max()) if rows.size else 0

    if rcm_bw < natural_bw:
        return rank, rcm_bw
    return np.arange(N, dtype=np.int64), natural_bw


def scalar_bandwidth(data: np.ndarray, sk: Skeleton, reorder: bool = True) -> int:
    """Scalar half-bandwidth of the (optionally RCM-relabeled) matrix."""
    mask = nonzero_block_mask(data, sk)
    if reorder:
        _, bwb = block_permutation(sk, mask)
    else:
        N = sk.n_sites
        rows = np.repeat(np.arange(N, dtype=np.int64), mask.sum(axis=1))
        cols = sk.cols[mask].astype(np.int64)
        bwb = int(np.abs(rows - cols).max()) if rows.size else 0
    return BLOCK * bwb + (BLOCK - 1)


def pack_band_lower(
    data: np.ndarray, sk: Skeleton, rank: np.ndarray, bw: int
) -> np.ndarray:
    """Pack the lower band into LAPACK banded storage ``ab[k, m] = H[m+k, m]``.

    ``rank`` is the block relabeling from :func:`block_permutation`; ``bw``
    the scalar half-bandwidth.  One vectorized scatter per (slot, a, b)
    entry — ≤ 7·16 passes of length N, no Python-per-site loops.
    """
    data = np.asarray(data)
    N, S = sk.cols.shape
    dim = BLOCK * N
    ab = np.zeros((bw + 1, dim), dtype=data.dtype)
    mask = nonzero_block_mask(data, sk)
    ri = rank  # new block row index per site
    for s in range(S):
        m = mask[:, s]
        if not m.any():
            continue
        i = ri[m]
        j = rank[sk.cols[m, s].astype(np.int64)]
        blk = data[m, s]
        for a in range(BLOCK):
            for b in range(BLOCK):
                r = BLOCK * i + a
                c = BLOCK * j + b
                keep = r >= c
                ab[r[keep] - c[keep], c[keep]] = blk[keep, a, b]
    return ab


def _solve_banded(
    data: np.ndarray,
    sk: Skeleton,
    vectors: bool,
    reorder: bool,
):
    data = np.asarray(data)
    if data.dtype != np.complex128:
        # ALWAYS solve in double precision: with complex64 block data the
        # band inherited the dtype and LAPACK silently ran single-precision
        # chbevd — measured 3.1e-6 eigenvalue error at dim 40 000 on the
        # 100×100 headline (caught when the device iterative solver and an
        # f64 shift-invert cross-check agreed against it).  The upcast is
        # O(nnz) and the z-driver ~2× the c-driver — correctness first.
        data = data.astype(np.complex128)
    mask = nonzero_block_mask(data, sk)
    if reorder:
        rank, bwb = block_permutation(sk, mask)
    else:
        rank = np.arange(sk.n_sites, dtype=np.int64)
        N = sk.n_sites
        rows = np.repeat(np.arange(N, dtype=np.int64), mask.sum(axis=1))
        cols = sk.cols[mask].astype(np.int64)
        bwb = int(np.abs(rows - cols).max()) if rows.size else 0
    bw = BLOCK * bwb + (BLOCK - 1)
    ab = pack_band_lower(data, sk, rank, bw)
    out = sla.eig_banded(
        ab,
        lower=True,
        eigvals_only=not vectors,
        overwrite_a_band=True,
        check_finite=False,
    )
    return out, rank


def eigvalsh_banded(data: np.ndarray, sk: Skeleton, *, reorder: bool = True) -> np.ndarray:
    """All eigenvalues (ascending) via LAPACK's banded driver.

    Exact — identical spectrum to ``np.linalg.eigvalsh`` of the densified
    matrix up to LAPACK roundoff, at O(dim²·bandwidth) instead of O(dim³).
    """
    E, _ = _solve_banded(data, sk, vectors=False, reorder=reorder)
    return np.asarray(E)


def eigh_banded(
    data: np.ndarray, sk: Skeleton, *, reorder: bool = True
) -> Tuple[np.ndarray, np.ndarray]:
    """Full eigendecomposition ``(E, X)`` via the banded driver.

    Eigenvectors are returned in the *original* site ordering (the RCM
    relabeling is undone), columns-as-vectors — interchangeable with the
    dense path's output.
    """
    (E, Xp), rank = _solve_banded(data, sk, vectors=True, reorder=reorder)
    # Row r of the original matrix lives at permuted row 4·rank[i] + a.
    N = sk.n_sites
    scalar_perm = (BLOCK * rank[:, None] + np.arange(BLOCK)[None, :]).ravel()
    X = np.asarray(Xp)[scalar_perm]
    return np.asarray(E), X
