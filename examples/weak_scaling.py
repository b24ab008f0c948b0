#!/usr/bin/env python
"""Weak-scaling study of the row-partitioned Chebyshev free-energy sweep.

BASELINE config 5: a large row-partitioned lattice whose Chebyshev
free-energy sweep runs with halo-exchange collectives.  Each device owns a
fixed LOCAL problem (Lx_local x W plane slab); the global lattice grows
with the device count, so on real hardware ideal scaling is constant
wall-clock and efficiency = t(1) / t(P).

On *virtual CPU devices* (the test mode below) all "devices" share
one host's physical cores, so even perfect sharding runs P× the work on
fixed compute — the honest ideal there is t(P) = P·t(1), and efficiency is
reported as P·t(1) / t(P) (aggregate-throughput normalization).  The
communication structure (halo ppermute + psum) is identical either way.

Run without hardware on virtual devices:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python examples/weak_scaling.py --local-lx 16 --width 64

On the GPUs of one host, run it as it is; across hosts, run one process
per host with jax.distributed initialized (halos and reductions over NCCL).
"""

import argparse
import json
import time


def main():
    ap = argparse.ArgumentParser()
    # Defaults give 65 536 sites per device: large enough that per-run
    # timing noise is a few percent of the runtime, so the efficiency
    # column carries information (a 256-site, ~12 ms single shot
    # fluctuates ±40% around 1.0).
    ap.add_argument("--local-lx", type=int, default=256, help="x-planes per device")
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--order", type=int, default=32)
    ap.add_argument("--samples", type=int, default=4)
    ap.add_argument("--reps", type=int, default=3,
                    help="timing repeats; min is kept (the repo's estimator)")
    ap.add_argument("--temperature", type=float, default=0.1)
    ap.add_argument("--out", default="weak_scaling.json", help="where to write the results")
    ap.add_argument(
        "--cpu",
        action="store_true",
        help="force the CPU backend with 8 virtual devices",
    )
    args = ap.parse_args()

    if args.cpu:
        import os

        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8"
            ).strip()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from bodge_tpu.models.systems import swave_superconductor
    from bodge_tpu.parallel import RowSharding, free_energy_kpm_sharded, make_row_mesh

    n_avail = len(jax.devices())
    if jax.devices()[0].platform == "cpu":
        print(
            "NOTE: virtual CPU devices share the host's physical cores — "
            "efficiencies here validate correctness, not scaling. Run on "
            "several GPUs for meaningful numbers."
        )
    counts = [p for p in (1, 2, 4, 8, 16, 32) if p <= n_avail]
    results = []

    for p in counts:
        mesh = make_row_mesh(p)
        system = swave_superconductor((args.local_lx * p, args.width, 1), delta=0.4)
        rs = RowSharding(system.skeleton, mesh)

        data = rs.shard_data(system.data)

        def run():
            return free_energy_kpm_sharded(
                rs, data, args.temperature, scale=6.0,
                order=args.order, samples=args.samples,
            )

        F = run()  # compile + warmup
        # Min over repeats: for deterministic constant work the minimum is
        # the consistent estimator (it approaches the true time from
        # above); a mean would fold scheduler noise into the curve.
        dt = float("inf")
        for _ in range(args.reps):
            t0 = time.perf_counter()
            F = run()
            dt = min(dt, time.perf_counter() - t0)
        entry = {"devices": p, "sites": system.lattice.size, "time_s": dt,
                 "F": F, "timing": f"min of {args.reps} after warmup"}
        results.append(entry)
        print(f"P={p:3d}  sites={system.lattice.size:9d}  t={dt:8.4f}s  F={F:.2f}")

    t1 = results[0]["time_s"]
    shared_host = jax.devices()[0].platform == "cpu"
    # Marginal reference: the smallest P that engages the real collective
    # path (P=1's ppermute is an identity).  On shared-host virtual
    # devices the P=1→2 jump folds in the one-time cost of engaging the
    # halo machinery; the marginal column isolates how the overhead GROWS
    # with P.
    t2 = next((r["time_s"] for r in results if r["devices"] == 2), None)
    for r in results:
        if shared_host:
            # Virtual devices share one host's cores: constant-wall-clock
            # "weak scaling" is meaningless here, so report the aggregate-
            # throughput number under its own key and do NOT emit
            # weak_scaling_efficiency at all (the same key must not mean
            # different things across runs). No clamping —
            # >1 just means XLA parallelized the P-fold workload well.
            # For stable numbers pin the run to ONE core (taskset -c 0):
            # ideal is then exactly t(P) = P·t(1) and deviations measure
            # sharding overhead, not core contention.
            r["normalization"] = "aggregate-throughput (shared-host virtual devices)"
            r["shared_host_throughput_efficiency"] = t1 * r["devices"] / r["time_s"]
            eff = r["shared_host_throughput_efficiency"]
            if t2 is not None and r["devices"] >= 2:
                r["marginal_efficiency_vs_p2"] = (
                    t2 * r["devices"] / 2 / r["time_s"]
                )
        else:
            r["normalization"] = "constant wall-clock (dedicated devices)"
            r["weak_scaling_efficiency"] = t1 / r["time_s"]
            eff = r["weak_scaling_efficiency"]
        print(f"P={r['devices']:3d}  efficiency={100*eff:.1f}%"
              + (f"  (marginal vs P=2: {100*r['marginal_efficiency_vs_p2']:.1f}%)"
                 if "marginal_efficiency_vs_p2" in r else ""))

    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)


if __name__ == "__main__":
    main()
