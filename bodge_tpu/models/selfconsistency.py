"""Self-consistent order-parameter solvers via automatic differentiation.

[NEW SCOPE] — the reference documents that self-consistent calculations
must add the condensation energy Σ|Δ_i|²/V to ``free_energy()`` by hand
and iterate externally (``bodge/hamiltonian.py:264-269``); it provides no
solver.  Because this framework's free energy is a differentiable JAX
program (dense eigvalsh or a Chebyshev/KPM trace of SpMM scans), the BCS
gap equation — the stationarity condition ∂F_total/∂Δ* = 0 — can be solved
directly by gradient descent on

    F_total(Δ) = F_BdG(H[Δ]) + Σ_i |Δ_i|² / V,

which is the domain analog of a training loop: forward = free energy,
backward = AD through the spectral solver, update = optax.

The KPM path is preferred for AD at scale: gradients flow through the
SpMM scan without the eigenvector-degeneracy pathologies of eigh JVPs
(spin-degenerate BdG spectra are the common case).
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import Callable, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from ..common import jσ2
from ..ops import blocksparse as bs
from ..ops.blocksparse import BLOCK, Skeleton
from ..ops.chebyshev import _KERNELS, chebyshev_coefficients, spectral_bound
from ..ops.spmm import check_impl, spmm


def data_with_onsite_swave(base_data, delta):
    """Insert an on-site singlet pairing field Δ_i·jσ2 into ELL block data.

    ``delta: [N]`` complex.  Differentiable in ``delta`` — the building
    block for self-consistency loops.
    """
    blk = delta[:, None, None] * jnp.asarray(jσ2, dtype=base_data.dtype)
    blkH = jnp.conj(jnp.swapaxes(blk, -1, -2))
    data = base_data.at[:, 0, 0:2, 2:4].set(blk)
    data = data.at[:, 0, 2:4, 0:2].set(blkH)
    return data


# ---------------------------------------------------------------------------
# Bond-singlet pairing fields (d-wave / extended-s gap equations)
# ---------------------------------------------------------------------------
def bond_structure_dwave(sk: Skeleton) -> np.ndarray:
    """Per-slot singlet structure ``[S, 2, 2]`` of the d_{x²−y²} order
    parameter on the cubic stencil: +jσ2 on x-bonds, −jσ2 on y-bonds,
    zero elsewhere — the slot-table form of the reference's ``dwave()``
    form factor ((δx²−δy²)/|δ|²)·jσ2 on unit bonds
    (``bodge/hamiltonian.py:461-484``)."""
    if not sk.stencil:
        raise ValueError("bond_structure_dwave needs a cubic stencil skeleton")
    j2 = np.asarray(jσ2, np.complex128)
    struct = np.zeros((sk.n_slots, 2, 2), np.complex128)
    for s, (axis, _d) in enumerate(sk.slots):
        if axis == 0:
            struct[s] = j2
        elif axis == 1:
            struct[s] = -j2
    return struct


def bond_structure_pwave(sk: Skeleton, dvector: str = "e_z * p_x") -> np.ndarray:
    """Per-slot triplet structure ``[S, 2, 2]`` of a p-wave order
    parameter on the cubic stencil, from the same d-vector grammar as
    :func:`bodge_tpu.models.pwave` (reference ``bodge/hamiltonian.py:409-459``).

    The slot structure is odd under bond reversal — struct(+δ) = −struct(−δ)
    — which carries the triplet antisymmetry Δ(i→j) = −Δ(j→i); the bond
    amplitude from :func:`bond_field` stays symmetric, m(i→j) = (δ_i+δ_j)/2,
    so the product has exactly the reference's pwave placement for a uniform
    field (parity-tested against vectorized assembly with
    ``pairing=pwave(dvector)``)."""
    from .order_parameters import pwave as _pwave

    if not sk.stencil:
        raise ValueError("bond_structure_pwave needs a cubic stencil skeleton")
    σ_p = _pwave(dvector)
    origin = np.zeros((3,))
    struct = np.zeros((sk.n_slots, 2, 2), np.complex128)
    for s, (axis, d) in enumerate(sk.slots):
        if axis < 0:
            continue
        δ = np.zeros((3,))
        δ[axis] = d
        struct[s] = σ_p(origin, δ)
    return struct


@lru_cache(maxsize=32)
def _bond_mask(sk: Skeleton) -> np.ndarray:
    """``[N, S]`` float mask of genuine nearest-neighbor bonds.

    The stencil skeleton's column table wraps at every boundary (periodic
    links are *data* zeros, not structural holes), so a bond field must
    not leak pairing onto wrap links of an open-boundary system — the
    same ``|ci − cj| == 1`` mask users apply in vectorized assembly."""
    Lx, Ly, Lz = sk.shape
    x, y, z = np.meshgrid(
        np.arange(Lx), np.arange(Ly), np.arange(Lz), indexing="ij"
    )
    coords = np.stack([x.ravel(), y.ravel(), z.ravel()], axis=1)
    mask = np.zeros(sk.cols.shape, np.float64)
    for s, (axis, d) in enumerate(sk.slots):
        if axis < 0:
            continue
        inside = (coords[:, axis] + d >= 0) & (coords[:, axis] + d < sk.shape[axis])
        mask[:, s] = inside & (sk.cols[:, s] >= 0)
    return mask


def bond_field(delta_site, sk: Skeleton, struct=None):
    """Directed bond amplitudes ``m: [N, S]`` from a per-site field.

    ``m(i→j) = (δ_i + δ_j)/2`` on genuine bonds, zero on wrap links,
    padding, and slots whose ``struct`` entry vanishes.  Symmetric in
    (i, j), so the inserted operator is Hermitian.  Differentiable."""
    mask = _bond_mask(sk)
    if struct is not None:
        active = (np.abs(np.asarray(struct)).sum(axis=(1, 2)) > 0).astype(float)
        mask = mask * active[None, :]
    safe = np.where(sk.valid, sk.cols, 0)
    d = jnp.asarray(delta_site)
    m = 0.5 * (d[:, None] + d[safe])
    return m * jnp.asarray(mask, m.dtype)


def data_with_bond_singlet(base_data, delta_site, sk: Skeleton, struct):
    """Insert a bond-singlet pairing field into ELL block data.

    ``delta_site: [N]`` is a per-site amplitude; the pairing block on bond
    (i, j) at slot s is ``((δ_i+δ_j)/2)·struct[s]`` with the Hermitian
    partner ``struct[trans_slot[s]]†`` filled automatically.  ALL pairing
    sub-blocks are overwritten (on-site pairing included — pass a struct
    with a slot-0 entry to combine).  Differentiable in ``delta_site``.
    """
    struct_j = jnp.asarray(np.asarray(struct), base_data.dtype)
    structH = jnp.conj(
        jnp.swapaxes(struct_j[np.asarray(sk.trans_slot)], -1, -2)
    )
    m = bond_field(delta_site, sk, struct).astype(base_data.dtype)
    data = base_data.at[:, :, 0:2, 2:4].set(m[:, :, None, None] * struct_j[None])
    data = data.at[:, :, 2:4, 0:2].set(m[:, :, None, None] * structH[None])
    return data


def _bond_weights(struct) -> np.ndarray:
    """Per-slot condensation weight w_s = ‖struct_s‖²_F / 2 (=1 for jσ2)."""
    s = np.asarray(struct)
    return (np.abs(s) ** 2).sum(axis=(1, 2)) / 2.0


def _bond_penalty(m, struct, V: float):
    """Condensation energy Σ_bonds |Δ_b|²/V from directed amplitudes
    (each undirected bond counted twice in ``m`` → the ½ below)."""
    w = jnp.asarray(_bond_weights(struct), jnp.real(m).dtype)
    return jnp.sum(w[None, :] * jnp.abs(m) ** 2) / (2.0 * V)


def _resolve_pairing(pairing, sk: Skeleton):
    """None/'swave' → on-site path; 'dwave', ('pwave', dvector), or an
    [S,2,2] array → bond path."""
    if pairing in (None, "swave", "onsite_swave"):
        return None
    if isinstance(pairing, str):
        if pairing == "dwave":
            return bond_structure_dwave(sk)
        if pairing == "pwave":
            raise ValueError(
                "pairing='pwave' needs a d-vector: pass "
                "pairing=('pwave', 'e_z * p_x')"
            )
        raise ValueError(f"Unknown pairing '{pairing}' (use 'swave', 'dwave', "
                         "('pwave', dvector), or an [S, 2, 2] structure array)")
    if (
        isinstance(pairing, tuple)
        and len(pairing) == 2
        and pairing[0] == "pwave"
    ):
        return bond_structure_pwave(sk, pairing[1])
    struct = np.asarray(pairing)
    if struct.shape != (sk.n_slots, 2, 2):
        raise ValueError(
            f"pairing structure must have shape {(sk.n_slots, 2, 2)}, "
            f"got {struct.shape}"
        )
    return struct


def _free_energy_dense(data, sk: Skeleton, T: float):
    H = bs.ell_to_dense_jnp(data, sk)
    E = jnp.linalg.eigvalsh(H)
    Ep = E[E.shape[0] // 2 :]
    U = -0.5 * jnp.sum(Ep)
    if T == 0:
        return U
    return U - T * jnp.sum(jnp.log1p(jnp.exp(-Ep / T)))


def _free_energy_kpm(data, sk: Skeleton, T: float, probes, coeffs, inv_scale, impl):
    def H(v):
        return spmm(data, sk, v, impl=impl) * inv_scale

    def inner(a, b):
        return jnp.real(jnp.sum(jnp.conj(a) * b))

    t0 = probes
    t1 = H(probes)
    acc = coeffs[0] * inner(probes, t0) + coeffs[1] * inner(probes, t1)

    def step(carry, c_m):
        t_prev, t_cur, acc = carry
        t_next = 2.0 * H(t_cur) - t_prev
        return (t_cur, t_next, acc + c_m * inner(probes, t_next)), None

    (_, _, acc), _ = jax.lax.scan(step, (t0, t1, acc), coeffs[2:])
    return 0.5 * acc / probes.shape[-1] * (sk.n_sites * BLOCK)


def _bind(fn, *arrays):
    """``F_total(Δ) = fn(*arrays, Δ)``, jitted, with the operator and probe
    arrays bound as pytree leaves of a :class:`jax.tree_util.Partial`.
    Passed into a jitted caller as an argument, they stay arguments there
    too; closed over, XLA would embed them as constants and constant-fold
    the probe inner products at every compile."""
    return jax.tree_util.Partial(jax.jit(fn), *arrays)


def make_total_free_energy(
    system,
    V: float,
    temperature: float = 0.0,
    method: str = "dense",
    order: int = 256,
    samples: int = 32,
    key=None,
    impl: str = "stencil",
    mesh=None,
    delta_max: float = 2.0,
    pairing=None,
) -> Callable:
    """Return a differentiable ``F_total(Δ)`` over a pairing field Δ.

    ``system`` supplies the normal-state Hamiltonian (its pairing blocks
    are overwritten by the field).  ``V > 0`` is the attractive
    interaction strength in F_total = F_BdG + (condensation term).

    ``pairing`` selects the order-parameter channel:

    - ``None``/"swave" (default): on-site singlet Δ_i·jσ2, condensation
      term Σ_i |Δ_i|²/V.
    - ``"dwave"``: bond singlet with the d_{x²−y²} form factor — the bond
      amplitude is (δ_i+δ_j)/2 with ±jσ2 on x/y bonds
      (:func:`bond_structure_dwave`); condensation term Σ_bonds |Δ_b|²/V.
    - ``("pwave", dvector)``: bond triplet with the d-vector grammar of
      :func:`bodge_tpu.models.pwave` (:func:`bond_structure_pwave`), e.g.
      ``("pwave", "e_z * p_x")``.
    - an ``[S, 2, 2]`` array: custom per-slot bond structure.

    ``delta_max`` is the KPM paths' validity envelope: the Chebyshev scale
    is estimated once with |Δ| = delta_max headroom, and the recursion
    diverges silently if the optimizer ever drives max|Δ| beyond it.  For
    strong coupling (BCS estimate Δ ≈ 2·bandwidth·exp(−1/(V·DOS)) above
    ~2, or V ≳ 4t), raise ``delta_max`` accordingly.

    ``mesh`` (``method="kpm"`` only): a device mesh with a ``rows`` axis
    (:func:`bodge_tpu.parallel.make_row_mesh`).  The operator is then
    row-partitioned over it and every SpMM of the trace runs as the
    halo-exchange stencil of :mod:`bodge_tpu.parallel.sharded`; the
    objective and its gradient equal the single-device ones to rounding.
    """
    sk = system.skeleton
    T = float(temperature)
    struct = _resolve_pairing(pairing, sk)
    check_impl(impl)
    if mesh is not None and method != "kpm":
        raise ValueError("mesh= applies only to method='kpm'")

    base = jnp.asarray(system.data)

    if struct is None:
        insert = data_with_onsite_swave
        penalty = lambda delta: jnp.sum(jnp.abs(delta) ** 2) / V
    else:
        insert = lambda b, delta: data_with_bond_singlet(b, delta, sk, struct)
        penalty = lambda delta: _bond_penalty(
            bond_field(delta, sk, struct), struct, V
        )

    if method == "dense":

        def F_total(base, delta):
            data = insert(base, delta)
            return _free_energy_dense(data, sk, T) + penalty(delta)

        return _bind(F_total, base)

    if method == "kpm":
        # Spectral bound from a generous Δ headroom so the scale stays valid
        # across the optimization trajectory (a one-time power iteration).
        probe_delta = jnp.full((sk.n_sites,), float(delta_max), dtype=base.dtype)
        scale = spectral_bound(insert(base, probe_delta), sk, impl=impl)

        if T == 0:
            g = lambda E: -np.abs(E) / 2
        else:
            g = lambda E: -np.abs(E) / 2 - T * np.log1p(np.exp(-np.abs(E) / T))
        coeffs = chebyshev_coefficients(lambda x: g(scale * x), order)
        coeffs = jnp.asarray(coeffs * _KERNELS["jackson"](order))
        rdtype = jnp.real(jnp.zeros((), base.dtype)).dtype
        inv = jnp.asarray(1.0 / scale, dtype=rdtype)

        if key is None:
            key = jax.random.PRNGKey(11)
        # Normalized Hutchinson probes: E[z z†] = I with ⟨z,z⟩ = 4N per column.
        z = jax.random.rademacher(key, (sk.n_sites, BLOCK, samples), dtype=rdtype)
        z = z.astype(base.dtype) / jnp.sqrt(jnp.asarray(sk.n_sites * BLOCK, rdtype))

        if mesh is not None:
            from ..parallel.sharded import RowSharding, _trace_sharded_jit

            rs = RowSharding(sk, mesh)
            base_sh, z_sh = rs.shard_data(base), rs.shard_vector(z)
            order_ = coeffs.shape[0]

            def F_total(base, z, delta):
                data = insert(base, delta)
                tr = _trace_sharded_jit(rs, data, z, coeffs, inv, order_)
                F = 0.5 * tr / samples * (sk.n_sites * BLOCK)
                return F + penalty(delta)

            return _bind(F_total, base_sh, z_sh)

        def F_total(base, z, delta):
            data = insert(base, delta)
            F = _free_energy_kpm(data, sk, T, z, coeffs, inv, impl)
            return F + penalty(delta)

        return _bind(F_total, base, z)

    raise ValueError(f"Unknown method '{method}'")


def solve_gap(
    system,
    V: float,
    temperature: float = 0.0,
    delta0: float | np.ndarray = 0.2,
    steps: int = 300,
    learning_rate: float = 0.05,
    method: str = "dense",
    uniform: bool = False,
    **kwargs,
) -> Tuple[np.ndarray, float]:
    """Minimize F_total over the on-site s-wave field Δ_i by gradient descent.

    Returns ``(Δ, F_total(Δ))``.  With ``uniform=True`` a single scalar gap
    is optimized (broadcast over sites) — the homogeneous BCS problem.

    ``learning_rate`` acts on the EXTENSIVE objective: the uniform-gap
    gradient scales like N · (per-site gradient), so on large lattices
    scale the rate like 1/N (e.g. ``learning_rate=15/N``) or the momentum
    loop diverges.
    """
    F_total = make_total_free_energy(system, V, temperature, method=method, **kwargs)
    N = system.skeleton.n_sites
    cdtype = system.dtype
    rdtype = np.real(np.zeros((), cdtype)).dtype
    cast = lambda x: x.astype(cdtype)

    # Optimize a REAL gap field (the global U(1) phase is a gauge choice;
    # complex / phase-textured problems should drive F_total directly).
    if uniform:
        x0 = jnp.asarray(np.real(np.atleast_1d(delta0))[:1], dtype=rdtype)
        expand = lambda x: cast(jnp.broadcast_to(x, (N,)))
    else:
        x0 = jnp.asarray(np.broadcast_to(np.real(delta0), (N,)), dtype=rdtype)
        expand = lambda x: cast(x)

    loss = lambda x, F: F(expand(x))
    grad = jax.jit(jax.grad(loss))

    # Plain momentum descent keeps dependencies light; for custom loops
    # (optax, complex fields) use make_total_free_energy directly.
    x = x0
    m = jnp.zeros_like(x0)
    for _ in range(steps):
        m = 0.9 * m + grad(x, F_total)
        x = x - learning_rate * m

    return np.asarray(expand(x)), float(loss(x, F_total))
