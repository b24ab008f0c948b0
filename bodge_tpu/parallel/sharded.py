"""Row-partitioned block-sparse operators over a JAX device mesh.

[NEW SCOPE] — the reference is strictly single-process ("no support for
e.g. MPI", reference README), so this layer is designed for a JAX mesh
rather than ported: the lattice's leading (x) axis is block-partitioned
over a 1-D device mesh, giving each device a contiguous slab of x-planes.
Because the flat site index is x-major, slabs are contiguous row blocks of
the ELL data — exactly the layout :mod:`bodge_tpu.ops.spmm` already uses.

The stencil SpMM then needs one x-plane of the operand from each neighbor
device per application.  We exchange those halos with ``jax.lax.ppermute``
over the mesh ring inside a ``shard_map``; XLA hands the exchange to NCCL,
which carries it over NVLink between the GPUs of one host (every card
reaches every other at the same rate, so the ring is shaped by the
algorithm alone).  The ring wrap-around delivers device P−1's last plane to
device 0, which is precisely the periodic-boundary partner plane — so
periodic and open boundaries work unmodified (open boundaries have zero
wrap blocks, annihilating the halo contribution), the same trick that
makes the single-device circular roll exact.

Reductions (Chebyshev inner products, trace estimates, free-energy sums)
are ``psum`` over the same axis.  Everything composes under one jit so XLA
can overlap the halo exchange with interior compute.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import AxisType, Mesh, NamedSharding, PartitionSpec as P

from ..ops.blocksparse import BLOCK, Skeleton
from ..ops.chebyshev import (
    _KERNELS,
    _doubled_moment_scan,
    chebyshev_coefficients,
    rademacher_probes,
)
from ..ops.spmm import block_einsum

AXIS = "rows"
PROBE_AXIS = "probes"


def make_row_mesh(
    n_devices: Optional[int] = None, devices=None, probe_shards: int = 1
) -> Mesh:
    """A device mesh over which lattice rows (x-slabs) are partitioned.

    With ``probe_shards > 1`` a second mesh axis additionally partitions
    the probe-vector batch (the data-parallel analog): mesh shape becomes
    ``(n/probe_shards, probe_shards)`` with axes ``(rows, probes)``.

    The axes are ``Auto``: arrays that enter a jitted program replicated
    (a gap field Δ) are reconciled with the row-sharded operator by XLA's
    sharding propagation, also inside ``jax.jit(jax.grad(...))``.
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if probe_shards > 1:
        if n % probe_shards != 0:
            raise ValueError(f"{n} devices do not split into {probe_shards} probe shards")
        return jax.make_mesh(
            (n // probe_shards, probe_shards), (AXIS, PROBE_AXIS), devices=devices,
            axis_types=(AxisType.Auto, AxisType.Auto),
        )
    return jax.make_mesh((n,), (AXIS,), devices=devices, axis_types=(AxisType.Auto,))


@dataclass(frozen=True, eq=False)
class RowSharding:
    """Static description of an x-axis row partition of a cubic lattice."""

    sk: Skeleton
    mesh: Mesh

    def __post_init__(self):
        Lx = self.sk.shape[0]
        if not self.sk.stencil:
            raise ValueError("Row sharding requires a cubic (stencil) skeleton")
        if AXIS not in self.mesh.axis_names:
            raise ValueError(f"Mesh must have a '{AXIS}' axis")
        n = self.n_shards
        if Lx % n != 0:
            raise ValueError(
                f"Lattice x-extent {Lx} must divide evenly over {n} devices"
            )
        if Lx // n < 1:
            raise ValueError("Each device needs at least one x-plane")

    @property
    def n_shards(self) -> int:
        return int(dict(zip(self.mesh.axis_names, self.mesh.devices.shape))[AXIS])

    @property
    def has_probe_axis(self) -> bool:
        return PROBE_AXIS in self.mesh.axis_names

    @property
    def reduce_axes(self):
        return (AXIS, PROBE_AXIS) if self.has_probe_axis else (AXIS,)

    @property
    def data_spec(self):
        return P(AXIS)  # partition ELL data on its leading (site) axis

    @property
    def vec_spec(self):
        # Probe vectors [N, 4, K]: rows on the site axis; optionally the
        # probe batch K on the second mesh axis.
        return P(AXIS, None, PROBE_AXIS) if self.has_probe_axis else P(AXIS)

    def shard_data(self, data):
        return jax.device_put(data, NamedSharding(self.mesh, self.data_spec))

    def shard_vector(self, v):
        return jax.device_put(v, NamedSharding(self.mesh, self.vec_spec))


def _local_stencil_spmm(sk: Skeleton, n_shards: int, data_l, v_l):
    """Per-device stencil SpMM with ppermute halo exchange along x.

    ``data_l: [N/P, S, 4, 4]``, ``v_l: [N/P, 4, K]`` are the local slabs.
    """
    Lx, Ly, Lz = sk.shape
    Lxl = Lx // n_shards
    K = v_l.shape[-1]
    v3 = v_l.reshape(Lxl, Ly, Lz, BLOCK, K)
    d3 = data_l.reshape(Lxl, Ly, Lz, sk.n_slots, BLOCK, BLOCK)

    fwd = [(i, (i + 1) % n_shards) for i in range(n_shards)]
    bwd = [(i, (i - 1) % n_shards) for i in range(n_shards)]
    # My predecessor's last plane (serves as local plane "x = −1") and my
    # successor's first plane (plane "x = Lxl"); ring wrap = periodic link.
    halo_lo = lax.ppermute(v3[-1], AXIS, perm=fwd)
    halo_hi = lax.ppermute(v3[0], AXIS, perm=bwd)

    y = block_einsum("xyzab,xyzbk->xyzak", d3[..., 0, :, :], v3)
    for s, (axis, d) in enumerate(sk.slots):
        if axis < 0:
            continue
        if axis == 0:
            if d == +1:
                shifted = jnp.concatenate([v3[1:], halo_hi[None]], axis=0)
            else:
                shifted = jnp.concatenate([halo_lo[None], v3[:-1]], axis=0)
        else:
            shifted = jnp.roll(v3, shift=-d, axis=axis)
        y = y + block_einsum("xyzab,xyzbk->xyzak", d3[..., s, :, :], shifted)

    return y.reshape(-1, BLOCK, K)


def spmm_sharded(rs: RowSharding, data, v):
    """``H @ v`` with H row-partitioned over the mesh (halo-exchange SpMM)."""
    local = partial(_local_stencil_spmm, rs.sk, rs.n_shards)
    fn = jax.shard_map(
        local, mesh=rs.mesh, in_specs=(rs.data_spec, rs.vec_spec), out_specs=rs.vec_spec
    )
    return fn(data, v)


@partial(jax.jit, static_argnames=("rs", "order"))
def _moments_sharded_jit(rs: RowSharding, data, v0, inv_scale, order: int):
    sk, n = rs.sk, rs.n_shards

    def local(data_l, v0_l, inv_l):
        def H(v):
            return _local_stencil_spmm(sk, n, data_l, v) * inv_l

        def inner(a, b):
            return lax.psum(jnp.real(jnp.sum(jnp.conj(a) * b, axis=(0, 1))), AXIS)

        return _doubled_moment_scan(H, inner, v0_l, order)

    # Per-probe-column moments: reduced over rows, still sharded over the
    # probe axis when one exists.
    out_spec = P(None, PROBE_AXIS) if rs.has_probe_axis else P()
    fn = jax.shard_map(
        local,
        mesh=rs.mesh,
        in_specs=(rs.data_spec, rs.vec_spec, P()),
        out_specs=out_spec,
    )
    return fn(data, v0, inv_scale)


def moments_sharded(rs: RowSharding, data, v0, order: int, scale: float):
    """Chebyshev moments with row-partitioned SpMM and psum inner products."""
    rdtype = jnp.real(jnp.zeros((), data.dtype)).dtype
    inv = jnp.asarray(1.0 / scale, dtype=rdtype)
    return _moments_sharded_jit(rs, data, v0, inv, order)


@partial(jax.jit, static_argnames=("rs", "order"))
def _trace_sharded_jit(rs: RowSharding, data, probes, coeffs, inv_scale, order: int):
    sk, n = rs.sk, rs.n_shards

    def local(data_l, z_l, coeffs_l, inv_l):
        def H(v):
            return _local_stencil_spmm(sk, n, data_l, v) * inv_l

        def inner(a, b):
            return lax.psum(jnp.real(jnp.sum(jnp.conj(a) * b)), rs.reduce_axes)

        mu = _doubled_moment_scan(H, inner, z_l, order)
        return jnp.dot(coeffs_l[: mu.shape[0]], mu, precision=lax.Precision.HIGHEST)

    fn = jax.shard_map(
        local,
        mesh=rs.mesh,
        in_specs=(rs.data_spec, rs.vec_spec, P(), P()),
        out_specs=P(),
    )
    return fn(data, probes, coeffs, inv_scale)


def free_energy_kpm_sharded(
    rs: RowSharding,
    data,
    temperature: float,
    scale: float,
    order: int = 512,
    samples: int = 64,
    key=None,
    kernel: str = "jackson",
) -> float:
    """Row-partitioned KPM free energy (the multi-host sweep workhorse)."""
    T = float(temperature)
    if T < 0:
        raise ValueError("Expected non-negative temperature!")
    if T == 0:
        g = lambda E: -np.abs(E) / 2
    else:
        g = lambda E: -np.abs(E) / 2 - T * np.log1p(np.exp(-np.abs(E) / T))

    coeffs = chebyshev_coefficients(lambda x: g(scale * x), order)
    coeffs = jnp.asarray(coeffs * _KERNELS[kernel](order))

    N = rs.sk.n_sites
    rdtype = jnp.real(jnp.zeros((), data.dtype)).dtype
    inv = jnp.asarray(1.0 / scale, dtype=rdtype)
    z = jnp.asarray(rademacher_probes(N, samples, key, np.dtype(data.dtype)))
    z = rs.shard_vector(z)
    est = _trace_sharded_jit(rs, data, z, coeffs, inv, order)
    return 0.5 * float(est) / samples
