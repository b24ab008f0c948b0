"""Block-sparse matrix–vector / matrix–matrix products (SpMM).

Two interchangeable implementations of ``y = H @ v`` for the ELL/stencil
layout of :mod:`bodge_tpu.ops.blocksparse`:

- :func:`spmm_stencil` — the cubic-lattice path.  Because every off-diagonal
  slot corresponds to a ±1 coordinate shift on the cubic lattice, the
  product is a 7-point (2·dim+1) stencil: circular rolls of the operand
  along each lattice axis followed by batched 4×4 block products.  Circular
  rolls implement periodic wrap-around *exactly* — for open boundaries the
  wrap blocks are structural zeros, so the rolled-in values are annihilated.
  XLA fuses the rolls and the small einsums into a bandwidth-bound loop.

- :func:`spmm_gather` — a layout-agnostic gather + batched-matmul reference
  used for validation and for irregular future lattices.

Both treat ``v`` as ``[N, 4, K]`` (K right-hand sides).  The operation is
linear, so JAX autodiff applies transparently.

Every block product asks for ``Precision.HIGHEST``: on the GPU a float32 or
complex64 product may otherwise run in TF32 (about three decimal digits),
and over thousands of Chebyshev steps that error compounds.

Reference analog: SciPy's BSR matvec inside ``spsolve``/export paths; the
reference has no explicit SpMM entry point (SURVEY §2.2 — this is the
[NEW SCOPE] native-performance tier).
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp
from jax import lax

from .blocksparse import BLOCK, Skeleton

IMPLS = ("stencil", "gather")
_HIGHEST = lax.Precision.HIGHEST


def block_einsum(spec: str, a, b):
    """``jnp.einsum`` of the 4×4 block products at full float32 precision."""
    return jnp.einsum(spec, a, b, precision=_HIGHEST)


def spmm_gather(data, sk: Skeleton, v):
    """Gather-based reference SpMM: ``y[i] = Σ_s data[i, s] @ v[cols[i, s]]``."""
    safe_cols = np.where(sk.valid, sk.cols, 0)
    gathered = v[safe_cols]  # [N, S, 4, K]
    return block_einsum("nsab,nsbk->nak", data, gathered)


def spmm_stencil(data, sk: Skeleton, v):
    """Stencil SpMM via axis rolls.

    Args:
        data: ``[N, S, 4, 4]`` complex block data.
        sk: the lattice skeleton (slot ↔ axis/direction table).
        v: ``[N, 4, K]`` operand.

    Returns:
        ``[N, 4, K]`` result of the block-sparse product.
    """
    Lx, Ly, Lz = sk.shape
    K = v.shape[-1]
    v3 = v.reshape(Lx, Ly, Lz, BLOCK, K)
    d3 = data.reshape(Lx, Ly, Lz, sk.n_slots, BLOCK, BLOCK)

    # Diagonal slot.
    y = block_einsum("xyzab,xyzbk->xyzak", d3[..., 0, :, :], v3)

    # Off-diagonal slots: the slot (axis, +1) holds the block coupling site
    # r to site r+ê, so its contribution needs v shifted by −1 along `axis`
    # (bringing v[r+ê] to position r); wrap-around is the periodic link.
    for s, (axis, d) in enumerate(sk.slots):
        if axis < 0:
            continue
        shifted = jnp.roll(v3, shift=-d, axis=axis)
        y = y + block_einsum("xyzab,xyzbk->xyzak", d3[..., s, :, :], shifted)

    return y.reshape(-1, BLOCK, K)


def check_impl(impl: str) -> None:
    """Raise ``ValueError`` unless ``impl`` names an SpMM implementation."""
    if impl not in IMPLS:
        raise ValueError(f"Unknown SpMM implementation {impl!r}; expected one of {IMPLS}")


def spmm(data, sk: Skeleton, v, *, impl: str = "stencil"):
    """Dispatch SpMM by implementation name (one of :data:`IMPLS`).

    ``"stencil"`` falls back to the gather form on generic (non-cubic)
    skeletons, which have no stencil structure.
    """
    check_impl(impl)
    if impl == "stencil" and sk.stencil:
        return spmm_stencil(data, sk, v)
    return spmm_gather(data, sk, v)


def spmm_bytes(sk: Skeleton, K: int, itemsize: int) -> int:
    """Minimum HBM traffic of one SpMM pass (for roofline accounting).

    Counts one read of the block data, one read of the operand, and one
    write of the result; padding slots still occupy memory and are counted,
    since the hardware must stream them.
    """
    N, S = sk.cols.shape
    data_bytes = N * S * BLOCK * BLOCK * itemsize
    vec_bytes = 2 * N * BLOCK * K * itemsize
    return data_bytes + vec_bytes


def chebyshev_step_bytes(sk: Skeleton, K: int, itemsize: int) -> int:
    """Minimum HBM traffic of one fused Chebyshev step.

    The recursion ``t_next = 2·H̃ t_cur − t_prev`` unavoidably reads the
    block data and *two* vectors and writes one — one vector read more
    than a plain SpMM.  ``itemsize`` is the complex element size.
    """
    N, S = sk.cols.shape
    data_bytes = N * S * BLOCK * BLOCK * itemsize
    vec_bytes = 3 * N * BLOCK * K * itemsize
    return data_bytes + vec_bytes


def spmm_flops(sk: Skeleton, K: int, complex_data: bool = True) -> int:
    """FLOP count of one SpMM pass over the structural nonzeros."""
    per_mac = 8 if complex_data else 2  # complex multiply-add = 8 real flops
    return sk.nnz_blocks * BLOCK * BLOCK * K * per_mac
