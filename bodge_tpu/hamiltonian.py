"""The `Hamiltonian` operator/solver facade.

Parity target: ``bodge/hamiltonian.py:5-387``.  Semantics preserved:

- Coordinate-addressed assembly through a ``with system as (H, Δ)`` context
  manager; unspecified symmetry partners are autofilled — hopping blocks get
  particle-hole partners (+v / −v*) and pairing blocks get their Hermitian
  conjugates (``bodge/hamiltonian.py:102-118``).
- Hermiticity is verified after every assembly block with the reference's
  1e-6 gate (``bodge/hamiltonian.py:120-122``).
- The sparsity skeleton is fixed at construction; re-entering the ``with``
  block updates terms in place without clearing others.
- ``matrix(format=…)`` exports dense / BSR / CSR / CSC (sparse formats have
  explicit zeros trimmed, while the *stored* matrix never does, so new
  terms can still be added later — ``bodge/hamiltonian.py:140-141``).
- ``diagonalize``/``free_energy``/``ldos`` compute the same observables.

Differences from the reference (SURVEY §7): storage is a padded block-ELL
JAX array ``[N, S, 4, 4]`` instead of SciPy BSR; assembly writes are batched
scatters instead of per-key Python writes; solvers run on `jnp.linalg` (XLA,
cuSOLVER on the GPU) instead of host LAPACK; LDOS uses the exact spectral
resolvent (or Chebyshev/KPM for large systems) instead of a SuperLU sparse
solve, which has no accelerator analog.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import numpy as np

import jax
import jax.numpy as jnp

from .common import Coord, Coords, Index, Indices, Matrix, default_cdtype, typecheck
from .lattice import CubicLattice, Lattice
from .ops import blocksparse as bs
from .ops import dense as dense_ops
from .ops.blocksparse import BLOCK, Skeleton
from .ops.spmm import spmm as _spmm

HERMITICITY_TOL = 1e-6


@functools.lru_cache(maxsize=64)
def _assemble_kernel(sk, has_onsite, has_pair_onsite, has_hop, has_pair, reset):
    """One jitted device kernel applying all assembly writes for a given
    term-combination signature (mask-based dense slot writes, no scatters)."""
    valid_masks = [
        (sk.cols[:, s] >= 0)[:, None, None] for s in range(sk.n_slots)
    ]

    def fn(data, onsite_v, pair_onsite_v, hop_v, pair_v, pair_rev_v):
        if reset:
            data = jnp.zeros_like(data)
        if has_onsite:
            data = data.at[:, 0, 0:2, 0:2].set(onsite_v)
            data = data.at[:, 0, 2:4, 2:4].set(-jnp.conj(onsite_v))
        if has_pair_onsite:
            vH = jnp.conj(jnp.swapaxes(pair_onsite_v, -1, -2))
            data = data.at[:, 0, 0:2, 2:4].set(pair_onsite_v)
            data = data.at[:, 0, 2:4, 0:2].set(vH)
        for s in range(1, sk.n_slots):
            mask = valid_masks[s]
            if not mask.any():
                continue
            k = s - 1
            if has_hop:
                v = jnp.where(mask, hop_v[k], data[:, s, 0:2, 0:2])
                data = data.at[:, s, 0:2, 0:2].set(v)
                data = data.at[:, s, 2:4, 2:4].set(
                    jnp.where(mask, -jnp.conj(v), data[:, s, 2:4, 2:4])
                )
            if has_pair:
                v = jnp.where(mask, pair_v[k], data[:, s, 0:2, 2:4])
                vH = jnp.conj(jnp.swapaxes(pair_rev_v[k], -1, -2))
                vH = jnp.where(mask, vH, data[:, s, 2:4, 0:2])
                data = data.at[:, s, 0:2, 2:4].set(v)
                data = data.at[:, s, 2:4, 0:2].set(vH)
        return data

    return jax.jit(fn)


class Hamiltonian:
    """Block-sparse 4N×4N Bogoliubov-de Gennes Hamiltonian on a lattice.

    The matrix acts on Lattice⊗Nambu⊗Spin space; each lattice site carries a
    4×4 block over the basis {e↑, e↓, h↑, h↓}.  Assembly can go through the
    reference-compatible ``with`` DSL::

        with system as (H, Δ):
            H[i, i] = -μ * σ0
            Δ[i, i] = Δ0 * jσ2

    or through the vectorized :meth:`assemble` fast path, where per-term
    callables are evaluated over whole coordinate arrays at once.
    """

    @typecheck
    def __init__(self, lattice: Lattice, dtype=None):
        self.lattice = lattice
        self.shape: Indices = (BLOCK * lattice.size, BLOCK * lattice.size)
        self.dtype = np.dtype(dtype or default_cdtype())

        if isinstance(lattice, CubicLattice):
            self._sk: Skeleton = bs.skeleton(tuple(lattice.shape))
        else:
            self._sk = bs.skeleton_from_lattice(lattice)

        N, S = self._sk.cols.shape
        # Born host-resident; uploaded lazily by the first device consumer
        # (keeps construction free of device compiles/allocations).
        self._data = np.zeros((N, S, BLOCK, BLOCK), dtype=self.dtype)

        # Monotonic version for spectral-artifact caching: bumped on every
        # write path so solvers can reuse one eigendecomposition across
        # repeated observable queries on an unchanged Hamiltonian.
        self._version = 0
        self._eigh_cache = None

    # ------------------------------------------------------------------
    # Introspection
    # ------------------------------------------------------------------
    @property
    def data(self):
        """ELL block data ``[N, S, 4, 4]`` (complex; host or device array)."""
        return self._data

    @property
    def skeleton(self) -> Skeleton:
        return self._sk

    def host_data(self) -> np.ndarray:
        """The complex block data as a host NumPy array."""
        if isinstance(self._data, np.ndarray):
            return self._data
        return np.asarray(self._data)

    @typecheck
    def index(self, row: Coord, col: Coord) -> Index:
        """Flat block index k of block (row, col): ``data.reshape(-1,4,4)[k]``.

        Analog of the reference's BSR scan (``bodge/hamiltonian.py:157-170``).
        """
        i = self.lattice[row]
        j = self.lattice[col]
        s = bs.slot_lookup(self._sk, np.array([i]), np.array([j]))[0]
        return Index(i * self._sk.n_slots + int(s))

    # ------------------------------------------------------------------
    # Assembly: reference-compatible context-manager DSL
    # ------------------------------------------------------------------
    def __enter__(self):
        self._hopp: dict = {}
        self._pair: dict = {}
        return self._hopp, self._pair

    def __exit__(self, exc_type, exc_val, exc_tb):
        if exc_type is not None:
            del self._hopp, self._pair
            return False

        if isinstance(self._data, np.ndarray):
            # Host scatter: for host-resident data a device round-trip buys
            # nothing.
            data = np.array(self._data, copy=True)
        else:
            data = jnp.asarray(self._data)
        data = self._scatter_terms(data, self._hopp, self._pair)
        self._data = data
        self._version += 1
        del self._hopp, self._pair

        err = float(self._hermiticity_error())
        if err > HERMITICITY_TOL:
            raise RuntimeError("The constructed Hamiltonian is not Hermitian!")
        return False

    def _site_indices(self, coords: np.ndarray) -> np.ndarray:
        """Vectorized coord→site-index, falling back to the scalar API."""
        if isinstance(self.lattice, CubicLattice):
            return self.lattice.index_array(coords)
        return np.array([self.lattice.index(tuple(int(v) for v in c)) for c in coords])

    def _scatter_terms(self, data, hopp: dict, pair: dict):
        """Batched symmetry-respecting block writes for both term dicts.

        Works on host NumPy data (in-place fancy writes) and on device JAX
        arrays (functional ``.at`` scatters) alike.
        """
        sk = self._sk
        on_host = isinstance(data, np.ndarray)

        if hopp:
            ci = np.array([k[0] for k in hopp.keys()], dtype=np.int64)
            cj = np.array([k[1] for k in hopp.keys()], dtype=np.int64)
            vals = np.array(list(hopp.values()), dtype=self.dtype)
            rows = self._site_indices(ci)
            cols = self._site_indices(cj)
            slots = bs.slot_lookup(sk, rows, cols)
            if on_host:
                data[rows, slots, 0:2, 0:2] = vals
                data[rows, slots, 2:4, 2:4] = -np.conj(vals)
            else:
                v = jnp.asarray(vals)
                data = data.at[rows, slots, 0:2, 0:2].set(v)
                data = data.at[rows, slots, 2:4, 2:4].set(-jnp.conj(v))

        if pair:
            ci = np.array([k[0] for k in pair.keys()], dtype=np.int64)
            cj = np.array([k[1] for k in pair.keys()], dtype=np.int64)
            vals = np.array(list(pair.values()), dtype=self.dtype)
            rows = self._site_indices(ci)
            cols = self._site_indices(cj)
            s_fwd = bs.slot_lookup(sk, rows, cols)
            s_rev = bs.slot_lookup(sk, cols, rows)
            if on_host:
                data[rows, s_fwd, 0:2, 2:4] = vals
                data[cols, s_rev, 2:4, 0:2] = np.conj(np.swapaxes(vals, -1, -2))
            else:
                v = jnp.asarray(vals)
                vH = jnp.conj(jnp.swapaxes(v, -1, -2))
                data = data.at[rows, s_fwd, 0:2, 2:4].set(v)
                data = data.at[cols, s_rev, 2:4, 0:2].set(vH)

        return data

    # ------------------------------------------------------------------
    # Assembly: vectorized fast path
    # ------------------------------------------------------------------
    def assemble(
        self,
        *,
        onsite: Optional[Callable] = None,
        hopping: Optional[Callable] = None,
        pairing_onsite: Optional[Callable] = None,
        pairing: Optional[Callable] = None,
        reset: bool = False,
        check: bool = True,
        device: bool = True,
    ) -> "Hamiltonian":
        """Populate the Hamiltonian from batched per-term callables.

        Each callable receives coordinate arrays and returns 2×2 spin
        blocks, broadcastable to the batch:

        - ``onsite(ci)`` with ``ci: [N, 3]`` → ``[N, 2, 2]`` (or ``[2, 2]``)
        - ``hopping(ci, cj)`` over all directed structural neighbor pairs
          (bonds *and* periodic edges) → ``[B, 2, 2]``
        - ``pairing_onsite(ci)`` / ``pairing(ci, cj)`` likewise for Δ.

        Returning ``None`` from a callable (or passing ``None``) leaves the
        corresponding terms untouched.  With ``reset=True`` all stored terms
        are zeroed first.  Symmetry autofill matches the ``with`` DSL.

        ``device=False`` performs the symmetry writes in host NumPy (the
        native C++ scatter when it is built) and uploads the result lazily
        in one transfer — useful for pure-host assembly benchmarking.
        """
        sk = self._sk
        if isinstance(self.lattice, CubicLattice):
            coords_all = self.lattice.site_coords.astype(np.int64)
        else:
            coords_all = np.array([c for c in self.lattice.sites()], dtype=np.int64)
        N = len(coords_all)

        if not sk.stencil:
            return self._assemble_generic(
                coords_all,
                onsite=onsite,
                hopping=hopping,
                pairing_onsite=pairing_onsite,
                pairing=pairing,
                reset=reset,
                check=check,
            )

        def as_blocks(v):
            v = np.asarray(v, dtype=self.dtype)
            if v.ndim == 2:
                v = np.broadcast_to(v, (N, 2, 2))
            # Materialize broadcast views: the native scatter and the
            # device upload both want dense buffers.
            return np.ascontiguousarray(v)

        # Evaluate all user callables host-side (NumPy), then apply every
        # symmetry-respecting write in ONE jitted kernel: eager per-op
        # dispatch costs one compile and one launch per op.
        dummy = np.zeros((0,), dtype=self.dtype)
        onsite_v = pair_onsite_v = hop_v = pair_v = pair_rev_v = dummy

        if onsite is not None:
            v = onsite(coords_all)
            onsite_v = as_blocks(v) if v is not None else dummy
        if pairing_onsite is not None:
            v = pairing_onsite(coords_all)
            pair_onsite_v = as_blocks(v) if v is not None else dummy

        if hopping is not None or pairing is not None:
            hop_s, pair_s, pair_rev_s = [], [], []
            for s in range(1, sk.n_slots):
                valid = sk.cols[:, s] >= 0
                safe_cols = np.where(valid, sk.cols[:, s], 0)
                ci, cj = coords_all, coords_all[safe_cols]
                if hopping is not None:
                    v = hopping(ci, cj)
                    hop_s.append(as_blocks(v) if v is not None else np.zeros((N, 2, 2), self.dtype))
                if pairing is not None:
                    v = pairing(ci, cj)
                    vr = pairing(cj, ci)
                    pair_s.append(as_blocks(v) if v is not None else np.zeros((N, 2, 2), self.dtype))
                    pair_rev_s.append(
                        as_blocks(vr) if vr is not None else np.zeros((N, 2, 2), self.dtype)
                    )
            if hop_s:
                hop_v = np.stack(hop_s)
            if pair_s:
                pair_v = np.stack(pair_s)
                pair_rev_v = np.stack(pair_rev_s)

        if device:
            kernel = _assemble_kernel(
                sk,
                onsite_v.size > 0,
                pair_onsite_v.size > 0,
                hop_v.size > 0,
                pair_v.size > 0,
                reset,
            )
            self._data = kernel(
                self._data,
                jnp.asarray(onsite_v),
                jnp.asarray(pair_onsite_v),
                jnp.asarray(hop_v),
                jnp.asarray(pair_v),
                jnp.asarray(pair_rev_v),
            )
        else:
            d = (
                np.zeros_like(np.asarray(self._data))
                if reset
                else np.array(self._data, copy=True)
            )
            from . import native

            if native.available():
                # Fused single-pass C++ scatter (OpenMP) over the whole ELL
                # array — the native-runtime fast path.
                native.assemble_scatter(
                    d,
                    sk.cols,
                    onsite=np.ascontiguousarray(onsite_v) if onsite_v.size else None,
                    pair_onsite=(
                        np.ascontiguousarray(pair_onsite_v) if pair_onsite_v.size else None
                    ),
                    hop=np.ascontiguousarray(hop_v) if hop_v.size else None,
                    pair=np.ascontiguousarray(pair_v) if pair_v.size else None,
                    pair_rev=np.ascontiguousarray(pair_rev_v) if pair_v.size else None,
                    reset=False,  # `d` already holds the reset/previous state
                )
                self._data = d
                self._version += 1
                if check:
                    err = native.herm_error(d, sk.cols, sk.trans_slot)
                    if err > HERMITICITY_TOL:
                        raise RuntimeError(
                            "The constructed Hamiltonian is not Hermitian!"
                        )
                return self
            if onsite_v.size:
                d[:, 0, 0:2, 0:2] = onsite_v
                d[:, 0, 2:4, 2:4] = -np.conj(onsite_v)
            if pair_onsite_v.size:
                d[:, 0, 0:2, 2:4] = pair_onsite_v
                d[:, 0, 2:4, 0:2] = np.conj(np.swapaxes(pair_onsite_v, -1, -2))
            for s in range(1, sk.n_slots):
                mask = (sk.cols[:, s] >= 0)[:, None, None]
                k = s - 1
                if hop_v.size:
                    d[:, s, 0:2, 0:2] = np.where(mask, hop_v[k], d[:, s, 0:2, 0:2])
                    d[:, s, 2:4, 2:4] = np.where(
                        mask, -np.conj(hop_v[k]), d[:, s, 2:4, 2:4]
                    )
                if pair_v.size:
                    d[:, s, 0:2, 2:4] = np.where(mask, pair_v[k], d[:, s, 0:2, 2:4])
                    vH = np.conj(np.swapaxes(pair_rev_v[k], -1, -2))
                    d[:, s, 2:4, 0:2] = np.where(mask, vH, d[:, s, 2:4, 0:2])
            # Stays host-resident until the next device-side consumer; every
            # read path accepts NumPy arrays transparently.
            self._data = d
        self._version += 1

        if check:
            err = float(self._hermiticity_error())
            if err > HERMITICITY_TOL:
                raise RuntimeError("The constructed Hamiltonian is not Hermitian!")
        return self

    def _assemble_generic(
        self,
        coords_all,
        *,
        onsite=None,
        hopping=None,
        pairing_onsite=None,
        pairing=None,
        reset=False,
        check=True,
    ) -> "Hamiltonian":
        """Vectorized assembly on a generic (non-stencil) skeleton.

        Unlike the cubic fast path, the diagonal block of row ``i`` may sit
        at any slot, so writes are mask-driven per slot.  Host NumPy only —
        generic skeletons have no stencil structure for a device kernel to
        exploit, and the result uploads lazily like every host assembly.
        """
        sk = self._sk
        N, S = sk.cols.shape
        row_ids = np.arange(N)
        d = (
            np.zeros_like(np.asarray(self._data))
            if reset
            else np.array(self._data, copy=True)
        )

        def as_blocks(v, B):
            v = np.asarray(v, dtype=self.dtype)
            if v.ndim == 2:
                v = np.broadcast_to(v, (B, 2, 2))
            return v

        if onsite is not None or pairing_onsite is not None:
            diag_hits = sk.cols == row_ids[:, None]
            if not diag_hits.any(axis=1).all():
                raise ValueError(
                    "On-site terms require every row to have a diagonal block"
                )
            diag_slot = np.argmax(diag_hits, axis=1)
            if onsite is not None:
                v = onsite(coords_all)
                if v is not None:
                    v = as_blocks(v, N)
                    d[row_ids, diag_slot, 0:2, 0:2] = v
                    d[row_ids, diag_slot, 2:4, 2:4] = -np.conj(v)
            if pairing_onsite is not None:
                v = pairing_onsite(coords_all)
                if v is not None:
                    v = as_blocks(v, N)
                    d[row_ids, diag_slot, 0:2, 2:4] = v
                    d[row_ids, diag_slot, 2:4, 0:2] = np.conj(
                        np.swapaxes(v, -1, -2)
                    )

        if hopping is not None or pairing is not None:
            for s in range(S):
                valid = sk.cols[:, s] >= 0
                offdiag = valid & (sk.cols[:, s] != row_ids)
                if not offdiag.any():
                    continue
                mask = offdiag[:, None, None]
                safe_cols = np.where(valid, sk.cols[:, s], 0)
                ci, cj = coords_all, coords_all[safe_cols]
                if hopping is not None:
                    v = hopping(ci, cj)
                    if v is not None:
                        v = as_blocks(v, N)
                        d[:, s, 0:2, 0:2] = np.where(mask, v, d[:, s, 0:2, 0:2])
                        d[:, s, 2:4, 2:4] = np.where(
                            mask, -np.conj(v), d[:, s, 2:4, 2:4]
                        )
                if pairing is not None:
                    v = pairing(ci, cj)
                    vr = pairing(cj, ci)
                    if v is not None:
                        v = as_blocks(v, N)
                        vH = np.conj(np.swapaxes(as_blocks(vr, N), -1, -2))
                        d[:, s, 0:2, 2:4] = np.where(mask, v, d[:, s, 0:2, 2:4])
                        d[:, s, 2:4, 0:2] = np.where(mask, vH, d[:, s, 2:4, 0:2])

        self._data = d
        self._version += 1
        if check:
            err = float(self._hermiticity_error())
            if err > HERMITICITY_TOL:
                raise RuntimeError("The constructed Hamiltonian is not Hermitian!")
        return self

    def _hermiticity_error(self) -> float:
        """Max |H − H†|, host-native when the data is host-resident."""
        if isinstance(self._data, np.ndarray):
            from . import native

            if native.available():
                return native.herm_error(self._data, self._sk.cols, self._sk.trans_slot)
        return float(bs.hermiticity_error(self._data, self._sk))

    # ------------------------------------------------------------------
    # Export
    # ------------------------------------------------------------------
    @typecheck
    def matrix(self, format: str = "dense"):
        """Export the Hamiltonian in a requested matrix format.

        ``"dense"`` → NumPy array; ``"bsr"``/``"csr"``/``"csc"`` → SciPy
        sparse with explicit zeros eliminated (parity with
        ``bodge/hamiltonian.py:128-155``); ``"dense_jnp"`` → device-resident
        dense JAX array (an extension of the reference's formats).
        """
        if format == "dense_jnp":
            return bs.ell_to_dense_jnp(self._data, self._sk)

        if format == "dense":
            return bs.ell_to_dense(np.asarray(self._data), self._sk)

        if format in ("bsr", "csr", "csc", "coo"):
            H = bs.ell_to_bsr(np.asarray(self._data), self._sk)
            if format == "csr":
                H = H.tocsr()
            elif format == "csc":
                H = H.tocsc()
            elif format == "coo":
                H = H.tocoo()
            H.eliminate_zeros()
            return H

        raise RuntimeError("Requested matrix format is not yet supported")

    # ------------------------------------------------------------------
    # Operator application
    # ------------------------------------------------------------------
    def apply(self, v, *, impl: str = "stencil"):
        """Block-sparse product ``H @ v`` for ``v: [N, 4, K]``
        (``impl``: ``"stencil"`` or ``"gather"``)."""
        return _spmm(self._data, self._sk, v, impl=impl)

    # ------------------------------------------------------------------
    # Solvers
    # ------------------------------------------------------------------
    def _shift_invert(self, nev: int, sigma: float = 0.0, tol: float = 0.0):
        """The ``nev`` eigenpairs nearest ``sigma`` via host shift-invert
        ARPACK (SuperLU factorization of A − σI in complex128).

        σ=0 targets the lowest-|ε| BdG states directly — exact and
        extremely fast for open systems whose band fits a sparse LU
        (~3 s at the 40 000² 100×100 case).  Factorization fill grows
        with bandwidth (∝ L in 2D, ∝ L² in 3D), so beyond medium sizes
        use the device-side ``method="lanczos"`` path, which needs no
        factorization at all.  JAX has no sparse LU (SURVEY §3.5), so
        this is deliberately a host tier.
        """
        import scipy.sparse.linalg as spla

        A = self.matrix("csr").astype(np.complex128)
        E, X = spla.eigsh(A, k=min(nev, A.shape[0] - 1), sigma=float(sigma),
                          which="LM", tol=tol)
        order = np.argsort(E, kind="stable")
        return E[order], X[:, order]

    def _full_spectrum(self):
        """Full (E, X) device eigendecomposition, cached per Hamiltonian
        version.  A failed device solve raises (see
        :func:`bodge_tpu.ops.dense.eigh_device`)."""
        if (
            self._eigh_cache is not None
            and self._eigh_cache[0] == self._version
            and self._eigh_cache[2] is not None
        ):
            return self._eigh_cache[1], self._eigh_cache[2]
        E, X = dense_ops.eigh_device(self._data, self._sk)
        X = np.asarray(X)
        self._eigh_cache = (self._version, E, X)
        return E, X

    @typecheck
    def diagonalize(
        self,
        cuda: bool = False,
        format: str = "reshape",
        method: str = "dense",
        k: Optional[int] = None,
        **solver_kwargs,
    ):
        """Positive eigenvalues and eigenvectors of the dense Hamiltonian.

        ``format="raw"``: ``(E, X)`` with eigenvectors as columns, exactly
        as a direct LAPACK/XLA call would return them.  The default
        ``"reshape"`` returns ``X[n, i, α]`` with α ∈ {e↑, e↓, h↑, h↓}
        (reference layout contract, ``bodge/hamiltonian.py:239-248``).

        ``method="banded"`` solves the same eigenproblem through LAPACK's
        banded Hermitian driver after a bandwidth-minimizing RCM site
        relabeling — exact, and O(dim²·bandwidth) instead of O(dim³) for
        open-boundary lattices (see :mod:`bodge_tpu.ops.banded`).

        ``method="lanczos"`` computes only the ``k`` smallest *positive*
        eigenpairs (the states physics queries use: minigaps, gap edges,
        bound states) by Chebyshev-filtered subspace iteration on the
        block-sparse SpMM — O(order·nnz·k) on-device instead of an
        O(dim³) host factorization; see
        :func:`bodge_tpu.ops.lanczos.lowest_eigenstates` for the knobs
        (``tol``, ``max_iter``, ``impl``…).  The
        reference's ``subset_by_value=(0, ∞)`` semantics
        (``bodge/hamiltonian.py:229``) restricted to the bottom of the
        positive spectrum.

        ``method="shift_invert"`` computes the same k states by host
        ARPACK with a SuperLU factorization of A − σI (``sigma=0``
        default) — exact and seconds-fast while the sparse LU fits
        (bandwidth ∝ L in 2D); the device ``"lanczos"`` path takes over
        beyond that.
        """
        if cuda:
            raise RuntimeError(
                "The `cuda` flag is not applicable: this build reaches the GPU "
                "through JAX, which runs on its default device."
            )
        if method in ("lanczos", "shift_invert"):
            if k is None:
                raise ValueError(
                    f"diagonalize(method='{method}') needs k = number of "
                    "positive eigenpairs to compute"
                )
            if method == "lanczos":
                from .ops import lanczos as lanczos_ops

                # 2k+2: |ε| ties can split the ± signs unevenly, so a
                # strict 2k request occasionally yields only k−1 positive
                # states.
                E_all, X_all = lanczos_ops.lowest_eigenstates(
                    self.host_data(), self._sk, 2 * k + 2, **solver_kwargs
                )
            else:
                E_all, X_all = self._shift_invert(2 * k + 2, **solver_kwargs)
            pos = E_all > 0
            eigval = np.asarray(E_all[pos])[:k]
            eigvec = np.asarray(X_all[:, pos])[:, :k]
            if format == "raw":
                return eigval, eigvec
            if format == "reshape":
                return eigval, eigvec.T.reshape(eigval.size, -1, BLOCK)
            raise RuntimeError(f"Eigenstate format '{format}' is not yet supported.")
        if solver_kwargs:
            raise TypeError(
                f"diagonalize(method='{method}') got unexpected keywords: "
                f"{sorted(solver_kwargs)}"
            )
        if method == "banded":
            from .ops import banded as banded_ops

            if (
                self._eigh_cache is not None
                and self._eigh_cache[0] == self._version
                and self._eigh_cache[2] is not None
            ):
                E, X = self._eigh_cache[1], self._eigh_cache[2]
            else:
                E, X = banded_ops.eigh_banded(np.asarray(self._data), self._sk)
                self._eigh_cache = (self._version, E, X)
        elif method == "dense":
            E, X = self._full_spectrum()
        else:
            raise RuntimeError(f"diagonalize method '{method}' is not supported")
        half = E.shape[0] // 2
        eigval = np.asarray(E[half:])
        eigvec = np.asarray(X[:, half:])
        if format == "raw":
            return eigval, eigvec
        if format == "reshape":
            return eigval, eigvec.T.reshape(eigval.size, -1, BLOCK)
        raise RuntimeError(f"Eigenstate format '{format}' is not yet supported.")

    def eigenvalues(self, method: str = "dense", k: Optional[int] = None, **solver_kwargs):
        """Positive eigenvalues only (no eigenvectors).

        ``method="banded"`` computes the identical spectrum via LAPACK's
        banded driver (O(dim²·bandwidth)); for large open-boundary lattices
        this is the only tractable exact path — e.g. the 100×100 s-wave
        case (a 40 000² matrix) solves in ~40 min on a 2-core host where
        dense LAPACK would need ~20 h.

        ``method="lanczos"`` returns only the ``k`` smallest positive
        eigenvalues via the device-side filtered subspace iteration
        (:mod:`bodge_tpu.ops.lanczos`); ``method="shift_invert"`` the
        same via host ARPACK + SuperLU (exact, fastest while the sparse
        LU fits).
        """
        if method in ("lanczos", "shift_invert"):
            if k is None:
                raise ValueError(
                    f"eigenvalues(method='{method}') needs k = number of "
                    "positive eigenvalues to compute"
                )
            if method == "lanczos":
                from .ops import lanczos as lanczos_ops

                E_all, _ = lanczos_ops.lowest_eigenstates(
                    self.host_data(), self._sk, 2 * k + 2, **solver_kwargs
                )
            else:
                E_all, _ = self._shift_invert(2 * k + 2, **solver_kwargs)
            return np.asarray(E_all[E_all > 0])[:k]
        if solver_kwargs or k is not None:
            raise TypeError(
                f"eigenvalues(method='{method}') got unexpected keywords"
            )
        if method not in ("dense", "banded"):
            raise RuntimeError(f"eigenvalues method '{method}' is not supported")
        if self._eigh_cache is not None and self._eigh_cache[0] == self._version:
            E = np.asarray(self._eigh_cache[1])
        elif method == "banded":
            from .ops import banded as banded_ops

            E = banded_ops.eigvalsh_banded(np.asarray(self._data), self._sk)
            self._eigh_cache = (self._version, E, None)
        else:
            E = dense_ops.eigvalsh_device(self._data, self._sk)
            # Cache eigenvalues so repeated free_energy() calls on an
            # unchanged Hamiltonian skip the O(N³) solve; eigenvectors stay
            # None until diagonalize() needs them (round-1 review finding).
            self._eigh_cache = (self._version, E, None)
        return E[E.shape[0] // 2 :]

    def free_energy(
        self,
        temperature: float = 0.0,
        cuda: bool = False,
        method: str = "dense",
        **kpm_kwargs,
    ) -> float:
        """Landau free energy F = U − T·S from the positive spectrum.

        Same formulas as ``bodge/hamiltonian.py:305-319`` (Appendix C of
        Ouassou et al. PRB 109, 174506); the mean-field condensation
        constant is *not* included and must be added by the caller for
        self-consistent calculations.

        ``method="kpm"`` computes the same quantity by Chebyshev expansion
        of the free-energy integrand plus (stochastic) trace estimation —
        O(order·nnz) instead of O(N³); see
        :func:`bodge_tpu.ops.chebyshev.free_energy_kpm` for the knobs.
        """
        if cuda:
            raise RuntimeError(
                "The `cuda` flag is not applicable: this build reaches the GPU "
                "through JAX, which runs on its default device."
            )
        if temperature < 0:
            raise ValueError("Expected non-negative temperature!")
        if method == "kpm":
            from .ops import chebyshev

            return chebyshev.free_energy_kpm(
                self._data, self._sk, temperature, **kpm_kwargs
            )
        if method not in ("dense", "banded"):
            raise RuntimeError(f"free_energy method '{method}' is not supported")
        E = jnp.asarray(self.eigenvalues(method=method))
        return float(dense_ops.free_energy_from_spectrum(E, temperature))

    def dos(self, energies, method: str = "kpm", **kpm_kwargs) -> np.ndarray:
        """Total density of states over all 4N orbitals (KPM-based)."""
        from .ops import chebyshev

        return chebyshev.dos_kpm(self._data, self._sk, energies, **kpm_kwargs)

    def ldos(
        self,
        site: Coord,
        energies,
        method: str = "exact",
        order: Optional[int] = None,
        kernel: str = "jackson",
        **kpm_kwargs,
    ) -> np.ndarray:
        """Local density of states at ``site`` for the given energies.

        ``method="exact"`` evaluates the exact diagonal resolvent elements
        spectrally — numerically the same observable as the reference's
        sparse-LU solve (``bodge/hamiltonian.py:323-387``), including the
        grid-adaptive broadening Γ = gradient(unique(|ε|)).

        ``method="kpm"`` uses the Chebyshev/KPM expansion driven by the
        block-sparse SpMM — the scalable device path for large lattices.
        Extra keywords (``eta=`` for a target Lorentzian broadening,
        ``scale=``, ``impl=``) are forwarded to
        :func:`bodge_tpu.ops.chebyshev.ldos_kpm`, matching the forwarding
        that ``free_energy`` and ``ldos_map`` already do.
        """
        i = self.lattice[site]
        if method == "exact":
            if kpm_kwargs:
                raise TypeError(
                    f"ldos(method='exact') got unexpected KPM keywords: "
                    f"{sorted(kpm_kwargs)}"
                )
            return dense_ops.ldos_from_spectrum(*self._full_spectrum(), i, energies)
        if method == "kpm":
            from .ops import chebyshev

            return chebyshev.ldos_kpm(
                self._data, self._sk, i, energies, order=order, kernel=kernel,
                **kpm_kwargs,
            )
        raise RuntimeError(f"LDOS method '{method}' is not supported")

    # ------------------------------------------------------------------
    # Checkpoint / resume
    # ------------------------------------------------------------------
    def save(self, path: str) -> None:
        """Checkpoint the assembled operator (skeleton + blocks) to ``path``."""
        from .utils.serialization import save_hamiltonian

        save_hamiltonian(self, path)

    @classmethod
    def load(cls, path: str) -> "Hamiltonian":
        """Restore a Hamiltonian checkpointed with :meth:`save`."""
        from .utils.serialization import load_hamiltonian

        return load_hamiltonian(path)

    def ldos_map(self, sites, energies, method: str = "exact", **kwargs) -> np.ndarray:
        """LDOS at many sites at once → ``[n_sites, n_energies]``.

        The dense path reuses one cached eigendecomposition for all sites;
        the KPM path batches all probe orbitals into a single moment scan
        (4·n_sites probe columns per SpMM).
        """
        site_idx = [self.lattice[tuple(s)] if not np.isscalar(s) else int(s) for s in sites]
        if method == "exact":
            E, X = self._full_spectrum()
            return np.stack(
                [dense_ops.ldos_from_spectrum(E, X, i, energies) for i in site_idx]
            )
        if method == "kpm":
            from .ops import chebyshev

            return chebyshev.ldos_kpm_sites(self._data, self._sk, site_idx, energies, **kwargs)
        raise RuntimeError(f"LDOS method '{method}' is not supported")
