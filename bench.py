#!/usr/bin/env python
"""Benchmark sections for bodge_tpu on the GPU.

    python bench.py                      # every section, in order
    python bench.py --only spmm_stencil  # one section
    python bench.py --results out.json   # also write every section's record

Each section runs in a child process (``bench.py --section NAME``), one
after another, so only one JAX process ever holds the card.  A section
that fails or overruns its time limit fails the run: the exit code is
non-zero and no headline line is printed.  Otherwise the last line of
standard output is

    {"metric": "chebyshev_spmm_throughput", "value": <nnz/s>,
     "unit": "nnz/s", "vs_baseline": <share of the published HBM rate>}

taken from the fastest SpMM section.  Every record names the device it ran
on; a device without published peaks in
:data:`bodge_tpu.utils.profiling.DEVICE_PEAKS` fails ``device_info``.
Timings are the minimum over repeats after warm-up (the reference's
methodology, misc/benchmark.py:145-153).
"""

import argparse
import json
import os
import subprocess
import sys
import time
from functools import partial

import numpy as np


def log(msg):
    print(msg, file=sys.stderr, flush=True)


# ===========================================================================
# Child mode: the sections (JAX is imported here only).
# ===========================================================================
def build_swave(L, W=None, Δ0=0.4, μ=0.5, t=1.0):
    from bodge_tpu import CubicLattice, Hamiltonian, jσ2, σ0

    lattice = CubicLattice((L, W or L, 1))
    system = Hamiltonian(lattice)
    system.assemble(
        onsite=lambda ci: -μ * σ0,
        pairing_onsite=lambda ci: Δ0 * jσ2,
        hopping=lambda ci, cj: np.where(
            (np.abs(ci - cj).max(axis=1) == 1)[:, None, None], -t * σ0, 0
        ),
        check=False,  # Hermitian by construction
    )
    return lattice, system


def _device_record():
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind, "count": len(jax.devices())}


def _chebyshev_record(system, order, K, impl, apply=None):
    """Per-step time of a ``lax.scan`` of ``order`` Chebyshev steps
    ``t_next = 2·H̃·t_cur − t_prev`` and its share of the HBM roof."""
    import jax
    import jax.numpy as jnp

    from bodge_tpu.ops.blocksparse import BLOCK
    from bodge_tpu.ops.spmm import chebyshev_step_bytes, spmm, spmm_flops
    from bodge_tpu.utils.profiling import Roofline, best_time, peaks_for_device

    sk, dtype = system.skeleton, system.dtype
    N = sk.n_sites
    apply = apply or (lambda data, v: spmm(data, sk, v, impl=impl))
    v0 = np.zeros((N, BLOCK, K), dtype=dtype)
    v0[N // 2, np.arange(K) % BLOCK, np.arange(K)] = 1.0
    inv = jnp.asarray(0.1, jnp.real(jnp.zeros((), dtype)).dtype)

    @partial(jax.jit, static_argnames=("n",))
    def scan(data, v, inv, n):
        def step(carry, _):
            t_prev, t_cur = carry
            return (t_cur, 2.0 * inv * apply(data, t_cur) - t_prev), None

        (_, out), _ = jax.lax.scan(step, (v, v), None, length=n)
        return out

    data, v = jnp.asarray(system.data), jnp.asarray(v0)
    log(f"[{impl}] compiling a {order}-step scan on {tuple(sk.shape)}, K={K}, {np.dtype(dtype)}")
    t_step = best_time(lambda: scan(data, v, inv, order), repeats=5, warmup=1) / order
    step_bytes = chebyshev_step_bytes(sk, K, np.dtype(dtype).itemsize)
    roof = Roofline(t_step, step_bytes, spmm_flops(sk, K), peaks_for_device().hbm_bytes_per_s)
    nnz = sk.nnz_blocks * BLOCK * BLOCK
    log(f"[{impl}] {roof.summary()}, {nnz / t_step / 1e9:.2f} Gnnz/s")
    return {
        "impl": impl, "lattice": list(sk.shape), "order": order, "K": K,
        "dtype": str(np.dtype(dtype)), "time_per_step_s": t_step, "nnz_per_s": nnz / t_step,
        "bytes_per_step": step_bytes, "achieved_GBps": roof.achieved_bw / 1e9,
        "fraction_of_roof": roof.fraction_of_roof,
    }


def bench_device_info():
    from bodge_tpu.utils.profiling import measure_copy_bandwidth, peaks_for_device

    peaks = peaks_for_device()
    copy = measure_copy_bandwidth()
    log(f"[device] copy ceiling {copy / 1e9:.0f} GB/s of {peaks.hbm_bytes_per_s / 1e9:.0f} published")
    return {**_device_record(), "hbm_GBps_published": peaks.hbm_bytes_per_s / 1e9,
            "peaks_source": peaks.source, "copy_GBps_measured": copy / 1e9}


def bench_spmm(L=200, order=256, K=4, impl="stencil"):
    _, system = build_swave(L)
    return _chebyshev_record(system, order, K, impl)


def bench_spmm_3d_rashba(shape=(64, 64, 4), order=256, K=4):
    """BASELINE config 4: the full 7-slot 3D stencil with complex hopping."""
    from bodge_tpu.models.systems import rashba_dp_wave

    return {"system": "rashba_dp_wave", **_chebyshev_record(rashba_dp_wave(shape), order, K, "stencil")}


def bench_spmm_sharded(L=200, order=256, K=4):
    """The row-sharded halo-exchange stencil over every visible device."""
    import jax

    from bodge_tpu.parallel import RowSharding, make_row_mesh
    from bodge_tpu.parallel.sharded import _local_stencil_spmm

    _, system = build_swave(L)
    rs = RowSharding(system.skeleton, make_row_mesh())
    local = partial(_local_stencil_spmm, rs.sk, rs.n_shards)
    apply = jax.shard_map(local, mesh=rs.mesh, in_specs=(rs.data_spec, rs.vec_spec),
                          out_specs=rs.vec_spec)
    return {"devices": rs.n_shards, **_chebyshev_record(system, order, K, "sharded", apply)}


def bench_assembly(L=1024, W=1024):
    """Vectorized host assembly wall-clock (the reference assembles 1M
    sites in 133.9 s through its Python-dict loop, benchmark.csv:40)."""
    from bodge_tpu import CubicLattice, Hamiltonian, jσ2, native, σ0, σ3
    from bodge_tpu.utils.profiling import best_time

    t_mu, M0, Δ0, χ, t_hop = 1.0, 1.5, 0.1, 0.5, 1.0
    lattice = CubicLattice((L, W, 1))

    def onsite(ci):
        sc = (ci[:, 0] < L // 2)[:, None, None]
        return np.where(sc, 3 * t_hop * σ0, 3 * t_hop * σ0 - M0 * σ3)

    def pair_onsite(ci):
        sc = (ci[:, 0] < L // 2)[:, None, None]
        phase = np.exp(1j * χ * ci[:, 0] / L)[:, None, None]
        return np.where(sc, -Δ0 * phase * jσ2, 0)

    def hopping(ci, cj):
        bond = (np.abs(ci - cj).max(axis=1) == 1)[:, None, None]
        along_y = (ci[:, 1] != cj[:, 1])[:, None, None]
        return np.where(bond, np.where(along_y, -2 * t_hop * σ0, -t_hop * σ0), 0)

    def run():
        system = Hamiltonian(lattice)
        system.assemble(onsite=onsite, pairing_onsite=pair_onsite, hopping=hopping,
                        check=False, device=False)
        return system.host_data()

    t = best_time(run, repeats=3, warmup=1)
    log(f"[assembly] {L * W} sites in {t:.3f} s")
    return {"sites": L * W, "time_s": t, "sites_per_s": L * W / t,
            "native_tier": native.available(), "reference_s_at_1M": 133.9}


def bench_diagonalize(L=32):
    """Device eigh of the dense operator against the banded host solver."""
    from bodge_tpu.ops import banded as banded_ops
    from bodge_tpu.ops import dense as dense_ops

    _, system = build_swave(L)
    t0 = time.perf_counter()
    Eb = banded_ops.eigvalsh_banded(system.host_data(), system.skeleton)
    t_banded = time.perf_counter() - t0
    dense_ops.eigvalsh_device(system.data, system.skeleton)  # compile
    t0 = time.perf_counter()
    E = dense_ops.eigvalsh_device(system.data, system.skeleton)
    t_dev = time.perf_counter() - t0
    err = float(np.abs(E - Eb).max())
    log(f"[diag] {L}×{L}: device eigvalsh {t_dev:.3f} s, banded host {t_banded:.2f} s, "
        f"max |ΔE| {err:.2e}")
    return {"L": L, "dim": 4 * L * L, "device_eigvalsh_s": t_dev, "banded_host_s": t_banded,
            "max_abs_err_vs_banded": err}


def bench_diag_lanczos(L=32, k=8):
    """Lowest positive states by Chebyshev-filtered subspace iteration,
    checked against host shift-invert ARPACK in complex128."""
    from bodge_tpu.ops import lanczos as lz

    _, system = build_swave(L)
    t0 = time.perf_counter()
    E, _, info = lz.lowest_eigenstates(system.host_data(), system.skeleton, 2 * k + 2,
                                       full_output=True, seed=1)
    t = time.perf_counter() - t0
    Epos = np.sort(E[E > 0])[:k]
    E_si = system.eigenvalues(method="shift_invert", k=k)
    m = min(len(Epos), len(E_si))
    err = float(np.abs(Epos[:m] - E_si[:m]).max())
    log(f"[lanczos] {L}×{L}: {t:.1f} s, {info['iterations']} sweeps, max |ΔE| {err:.2e}")
    return {"L": L, "k": k, "time_s": t, "iterations": info["iterations"],
            "converged": bool(info["converged"]), "max_abs_err_vs_shift_invert": err}


def bench_kpm_ldos(L=200, order=512):
    from bodge_tpu.ops import chebyshev as kpm
    from bodge_tpu.utils.profiling import best_time

    lattice, system = build_swave(L)
    i0 = lattice[(L // 2, L // 2, 0)]
    energies = np.linspace(-1.5, 1.5, 41)
    scale = kpm.spectral_bound(system.data, system.skeleton)
    run = lambda: kpm.ldos_kpm(system.data, system.skeleton, i0, energies, order=order, scale=scale)
    t = best_time(run, repeats=3, warmup=1)
    ρ = run()
    log(f"[ldos] KPM order {order} on {L}×{L}: {t:.3f} s")
    return {"lattice": [L, L, 1], "order": order, "time_s": t,
            "ldos_min": float(np.min(ρ)), "ldos_max": float(np.max(ρ))}


def bench_consistency(L=12, order=48):
    """Drift of the device KPM moments from a host complex128 recursion."""
    from bodge_tpu.ops import chebyshev as kpm
    from bodge_tpu.ops.blocksparse import BLOCK, ell_to_dense

    _, system = build_swave(L)
    sk, N = system.skeleton, L * L
    a = float(kpm.spectral_bound(system.data, sk))
    v0 = np.zeros((N, BLOCK, BLOCK), dtype=system.dtype)
    v0[N // 2, np.arange(BLOCK), np.arange(BLOCK)] = 1.0
    mu_dev = np.asarray(kpm.moments(system.data, sk, v0, order, a))

    H = ell_to_dense(system.host_data().astype(np.complex128), sk) / a
    V0 = v0.reshape(4 * N, BLOCK).astype(np.complex128)
    t_prev, t_cur = V0, H @ V0
    mu_ref = [np.real(np.sum(np.conj(V0) * t_prev, axis=0)), np.real(np.sum(np.conj(V0) * t_cur, axis=0))]
    for _ in range(order - 2):
        t_prev, t_cur = t_cur, 2 * (H @ t_cur) - t_prev
        mu_ref.append(np.real(np.sum(np.conj(V0) * t_cur, axis=0)))
    drift = float(np.max(np.abs(mu_dev - np.array(mu_ref))))
    log(f"[consistency] max |μ_dev − μ_host64| = {drift:.2e} over {order} orders")
    return {"order": order, "lattice": [L, L, 1], "max_moment_drift": drift,
            "dtype": str(np.dtype(system.dtype))}


SECTIONS = {
    "device_info": bench_device_info,
    "spmm_stencil": bench_spmm,
    # BASELINE config 5: 1000×1000, 1M sites.
    "spmm_stencil_1m": lambda: bench_spmm(L=1000, order=64),
    "spmm_gather": lambda: bench_spmm(impl="gather"),
    "spmm_3d_rashba": bench_spmm_3d_rashba,
    "spmm_sharded": bench_spmm_sharded,
    "consistency": bench_consistency,
    "kpm_ldos": bench_kpm_ldos,
    "diagonalize": bench_diagonalize,
    "diag_lanczos": bench_diag_lanczos,
    "assembly": bench_assembly,
}
SPMM_SECTIONS = ("spmm_stencil", "spmm_stencil_1m", "spmm_gather", "spmm_3d_rashba", "spmm_sharded")
SECTION_TIMEOUT_S = 900


def child_main(section: str, out_path: str) -> int:
    result = {"device": _device_record(), **SECTIONS[section]()}
    with open(out_path, "w") as f:
        json.dump(result, f)
    return 0


# ===========================================================================
# Parent mode: JAX-free, one child at a time.
# ===========================================================================
def run_section(section: str, out_path: str):
    """Run one section's child; its record, or ``None`` if it failed."""
    log(f"[bench] section {section}")
    cmd = [sys.executable, os.path.abspath(__file__), "--section", section, "--out", out_path]
    try:
        rc = subprocess.run(cmd, timeout=SECTION_TIMEOUT_S).returncode
    except subprocess.TimeoutExpired:
        log(f"[bench] section {section} exceeded {SECTION_TIMEOUT_S} s")
        return None
    if rc != 0 or not os.path.exists(out_path):
        log(f"[bench] section {section} failed (exit code {rc})")
        return None
    with open(out_path) as f:
        return json.load(f)


def parent_main(sections, results_path=None) -> int:
    import tempfile

    results, failed = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        for section in sections:
            results[section] = run_section(section, os.path.join(tmp, f"{section}.json"))
            if results[section] is None:
                failed.append(section)
    if results_path:
        with open(results_path, "w") as f:
            json.dump(results, f, indent=2)
    if failed:
        log(f"[bench] failed sections: {', '.join(failed)}")
        return 1
    spmm = [results[s] for s in SPMM_SECTIONS if s in results]
    if spmm:
        head = max(spmm, key=lambda r: r["nnz_per_s"])
        print(json.dumps({"metric": "chebyshev_spmm_throughput", "value": head["nnz_per_s"],
                          "unit": "nnz/s", "vs_baseline": head["fraction_of_roof"]}), flush=True)
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--section", choices=sorted(SECTIONS), help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    ap.add_argument("--only", nargs="+", choices=list(SECTIONS), help="run these sections only")
    ap.add_argument("--results", help="write every section's record to this JSON file")
    args = ap.parse_args()
    if args.section:
        sys.exit(child_main(args.section, args.out))
    sys.exit(parent_main(args.only or list(SECTIONS), args.results))


if __name__ == "__main__":
    main()
