"""Multi-host entry point: ``jax.distributed`` setup + host-spanning meshes.

The reference is explicitly single-machine ("no support for e.g. MPI",
``README.md:36-39``).  The JAX equivalent of an MPI layer is *no
hand-written transport at all*: one ``jax.distributed.initialize()`` call
per host process, after which ``jax.devices()`` spans every GPU of the job
and the same ``shard_map`` programs used on one host run across hosts —
XLA hands the ``ppermute`` halos and ``psum`` reductions to NCCL, over
NVLink between the GPUs of a host and over the network between hosts
(SURVEY §2.2, "collectives backend").

Typical multi-host driver (one process per host):

    from bodge_tpu.parallel import initialize_multihost, make_row_mesh
    initialize_multihost("host0:1234", num_processes=2, process_id=rank)
    mesh = make_row_mesh()                    # all global devices
    ...                                       # identical single-host code

Nothing here imports at package-import time on single-host setups; calling
:func:`initialize_multihost` on one host is a no-op by default so driver
scripts work unchanged from one GPU to many hosts.
"""

from __future__ import annotations

from typing import Optional

import jax

__all__ = ["initialize_multihost", "is_multihost", "local_device_count"]

_initialized = False


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    **kwargs,
) -> bool:
    """Initialize ``jax.distributed`` for a multi-host run (idempotent).

    Without arguments, a coordinator address in the environment
    (``JAX_COORDINATOR_ADDRESS``) lets ``jax.distributed`` read the rest
    from there.  Returns ``True`` if a multi-process
    runtime was initialized, ``False`` for the single-process no-op (no
    arguments given and no multi-host environment detected) — so scripts
    can call this unconditionally.
    """
    global _initialized
    if _initialized:
        return True
    explicit = any(v is not None for v in (coordinator_address, num_processes, process_id))
    if not explicit and not _env_looks_multihost():
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        **kwargs,
    )
    _initialized = True
    return True


def _env_looks_multihost() -> bool:
    """True when the process environment names a coordinator."""
    import os

    return any(
        os.environ.get(k) for k in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS")
    )


def is_multihost() -> bool:
    """Whether this runtime spans more than one host process."""
    return jax.process_count() > 1


def local_device_count() -> int:
    """Devices attached to *this* host (vs ``jax.device_count()`` global)."""
    return jax.local_device_count()
