#!/usr/bin/env python
"""Solve the BCS gap equation by gradient descent on the free energy.

The stationarity condition of F_total(Δ) = F_BdG + Σ|Δ_i|²/V *is* the
self-consistency (gap) equation; because the whole free-energy evaluation
is a differentiable JAX program, we can let AD drive the loop — including
spatially-resolved gaps Δ_i near boundaries (proximity suppression).

    python examples/self_consistent_gap.py            # CPU is fine
"""

import numpy as np


def main():
    import jax

    jax.config.update("jax_platforms", jax.default_backend())  # leave as-is

    from bodge_tpu import CubicLattice, Hamiltonian, σ0
    from bodge_tpu.models.selfconsistency import solve_gap

    lattice = CubicLattice((32, 1, 1))
    system = Hamiltonian(lattice)
    system.assemble(
        onsite=lambda ci: 0.0 * σ0,
        hopping=lambda ci, cj: np.where(
            (np.abs(ci - cj).max(axis=1) == 1)[:, None, None], -1.0 * σ0, 0
        ),
    )

    print("V      Δ(center)   F_total")
    for V in (0.5, 1.0, 1.5, 2.0, 2.5, 3.0):
        Δ, F = solve_gap(system, V=V, temperature=0.0, uniform=False,
                         delta0=0.3, steps=250, learning_rate=0.02)
        mid = np.real(Δ[len(Δ) // 2])
        print(f"{V:4.1f}   {mid:9.4f}   {F:10.3f}")

    # At scale, the same loop runs through the KPM trace — forward and
    # backward on the device, optionally row-sharded over several GPUs:
    #
    #     solve_gap(system2d, V=2.0, method="kpm", order=256, samples=32,
    #               steps=150, mesh=make_row_mesh())
    #
    # (docs/tutorial.md §6).

    # Spatial profile at strong coupling: uniform in the bulk, with the
    # well-known boundary enhancement + Friedel oscillation at the open
    # chain ends (edge sites see a narrower local band).
    Δ, _ = solve_gap(system, V=2.5, temperature=0.0, uniform=False,
                     delta0=0.3, steps=300, learning_rate=0.02)
    prof = np.real(Δ)
    print("\ngap profile (x):")
    print(np.array2string(prof, precision=3, max_line_width=100))
    bulk = prof[len(prof) // 2]
    assert abs(prof[len(prof) // 2 + 1] - bulk) < 0.01  # flat bulk
    assert prof[0] != bulk  # boundary effect resolved


if __name__ == "__main__":
    main()
