#!/usr/bin/env python
"""Smoke run of bodge_tpu's main path on an NVIDIA GPU.

    python chip_smoke.py               # one card: device, kpm, quickstart, selfconsistency
    python chip_smoke.py --multi       # four cards, one process: row-sharded KPM vs one card
    python chip_smoke.py --trace DIR   # also trace the 1000×1000 Chebyshev step into DIR
    python chip_smoke.py --rehearse    # tiny sizes on any platform (a CPU dry run)

Every phase goes through the public entry points and compares what comes
out with an independent float64 host reference (SciPy in complex128),
printing the error beside its tolerance.  A failed phase makes the exit
code non-zero and suppresses the result line.  The last line of standard
output is one JSON object naming the device JAX ran on.  Times printed here
are smoke timings of one run, not benchmark numbers.
"""

import argparse
import json
import subprocess
import sys
import time
import traceback

import numpy as np

FULL = {"kpm": 1000, "quickstart": 100, "selfconsistency": 200, "multi": 1000}
TINY = {"kpm": 16, "quickstart": 10, "selfconsistency": 12, "multi": 16}


class PhaseFailed(Exception):
    pass


def log(msg):
    print(msg, flush=True)


def check(name, err, tol):
    """Print one comparison and fail the phase when it misses its tolerance."""
    ok = bool(np.isfinite(err) and err <= tol)
    log(f"  check {name}: error {err:.3e}  tolerance {tol:.1e}  {'ok' if ok else 'FAILED'}")
    if not ok:
        raise PhaseFailed(f"{name}: error {err:.3e} > tolerance {tol:.1e}")


def swave(L, dtype=None):
    """BASELINE config 5's s-wave lattice (open boundaries), assembled with
    the vectorized device path."""
    from bodge_tpu import CubicLattice, Hamiltonian, jσ2, σ0, σ3

    system = Hamiltonian(CubicLattice((L, L, 1)), dtype=dtype)
    system.assemble(
        onsite=lambda ci: 3.0 * σ0 - 0.05 * σ3,
        pairing_onsite=lambda ci: -0.1 * jσ2,
        hopping=lambda ci, cj: np.where(
            (np.abs(ci - cj).max(axis=1) == 1)[:, None, None], -1.0 * σ0, 0
        ),
    )
    return system


def normal_metal(L, mu=0.5):
    from bodge_tpu import CubicLattice, Hamiltonian, σ0

    system = Hamiltonian(CubicLattice((L, L, 1)))
    system.assemble(
        onsite=lambda ci: -mu * σ0,
        hopping=lambda ci, cj: np.where(
            (np.abs(ci - cj).max(axis=1) == 1)[:, None, None], -1.0 * σ0, 0
        ),
    )
    return system


def host_moments(csr, v0, order, scale):
    """Plain float64 Chebyshev recursion μ_m = Re⟨v0|T_m(H/a)|v0⟩."""
    V0 = v0.reshape(csr.shape[0], -1).astype(np.complex128)
    t_prev, t_cur = V0, (csr @ V0) / scale
    mus = [np.real(np.sum(np.conj(V0) * V0, axis=0)), np.real(np.sum(np.conj(V0) * t_cur, axis=0))]
    for _ in range(order - 2):
        t_prev, t_cur = t_cur, 2.0 * (csr @ t_cur) / scale - t_prev
        mus.append(np.real(np.sum(np.conj(V0) * t_cur, axis=0)))
    return np.array(mus[:order])


def peak_memory(device):
    stats = device.memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    return "not reported" if peak is None else f"{peak / 1e9:.2f} GB"


def phase_device(rehearse):
    import jax

    devices = jax.devices()
    d = devices[0]
    log(f"  jax: platform={d.platform} device_kind={d.device_kind!r} count={len(devices)}")
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        card = smi.stdout.strip() if smi.returncode == 0 else f"nvidia-smi failed: {smi.stderr.strip()}"
    except (OSError, subprocess.TimeoutExpired) as e:
        card = f"nvidia-smi unavailable: {e}"
    log(f"  card (nvidia-smi name, power.limit): {card}")
    if rehearse:
        return
    if d.platform != "gpu":
        raise PhaseFailed(f"JAX's default device is {d.platform}, not a GPU")
    from bodge_tpu.utils.profiling import peaks_for_device

    peaks = peaks_for_device(d)
    log(f"  published peaks: HBM {peaks.hbm_bytes_per_s / 1e12:.2f} TB/s, "
        f"FP32 {peaks.fp32_flops / 1e12:.0f} TFLOP/s ({peaks.source})")


def phase_kpm(L, trace_dir=None):
    import jax
    import jax.numpy as jnp

    from bodge_tpu.ops import chebyshev as kpm
    from bodge_tpu.ops.spmm import chebyshev_step_bytes, spmm
    from bodge_tpu.utils.profiling import measure_copy_bandwidth

    t0 = time.perf_counter()
    system = swave(L)
    jax.block_until_ready(system.data)
    sk, N = system.skeleton, system.skeleton.n_sites
    log(f"  {L}×{L} s-wave, {N} sites, dim {4 * N}, operator "
        f"{system.data.nbytes / 1e9:.3f} GB {system.dtype}; assembled in "
        f"{time.perf_counter() - t0:.2f} s")
    csr = system.matrix("csr").astype(np.complex128)

    rng = np.random.default_rng(0)
    v = (rng.standard_normal((N, 4, 4)) + 1j * rng.standard_normal((N, 4, 4))).astype(system.dtype)
    got = np.asarray(system.apply(jnp.asarray(v)))
    want = (csr @ v.astype(np.complex128).reshape(4 * N, 4)).reshape(N, 4, 4)
    # complex64 products of 4×4 blocks, six terms a row: ~10 ulp; TF32
    # would leave ~1e-3.
    check("apply(v), K=4, vs SciPy csr complex128",
          np.abs(got - want).max() / np.abs(want).max(), 1e-6)

    scale = kpm.spectral_bound(system.data, sk)
    v0 = v / np.linalg.norm(v.reshape(4 * N, 4), axis=0)
    mu = np.asarray(kpm.moments(system.data, sk, jnp.asarray(v0), 64, scale))
    mu_ref = host_moments(csr, v0, 64, scale)
    # Unit probes, |μ_m| ≤ 1; 31 doubled complex64 steps: rounding grows
    # about linearly in the step count, ~1e-5 here.
    check("64 Chebyshev moments of 4 probes vs host float64 recursion",
          np.abs(mu - mu_ref).max(), 1e-4)

    F = system.free_energy(0.01, method="kpm", order=256, samples=4, scale=scale)
    energies = np.linspace(-0.5, 0.5, 11)
    rho = system.ldos((L // 2, L // 2, 0), energies, method="kpm", order=512, scale=scale)
    log(f"  free_energy(T=0.01, kpm, order 256, 4 samples) = {F:.6e}; "
        f"ldos at centre = {np.array2string(rho, precision=4)}")
    if not np.isfinite(F) or not np.all(np.isfinite(rho)) or rho.min() < -1e-3 * rho.max():
        raise PhaseFailed("KPM free energy or LDOS is not finite and non-negative")

    inv = jnp.asarray(1.0 / scale, jnp.float32)

    @jax.jit
    def step(data, t_cur, t_prev, inv):
        return 2.0 * inv * spmm(data, sk, t_cur) - t_prev

    args = (system.data, jnp.asarray(v0), jnp.zeros_like(jnp.asarray(v0)), inv)
    compiled = step.lower(*args).compile()
    log(f"  Chebyshev step memory_analysis: {compiled.memory_analysis()}")
    t_prev, t_cur = args[2], args[1]
    for _ in range(3):
        t_prev, t_cur = t_cur, compiled(system.data, t_cur, t_prev, inv)
    jax.block_until_ready(t_cur)
    n = 50
    t0 = time.perf_counter()
    for _ in range(n):
        t_prev, t_cur = t_cur, compiled(system.data, t_cur, t_prev, inv)
    jax.block_until_ready(t_cur)
    dt = (time.perf_counter() - t0) / n
    nbytes = chebyshev_step_bytes(sk, 4, np.dtype(system.dtype).itemsize)
    copy_bw = measure_copy_bandwidth(1 << 30)
    log(f"  smoke timing (not a benchmark number): Chebyshev step {dt * 1e3:.3f} ms, "
        f"{nbytes / 1e9:.3f} GB/step -> {nbytes / dt / 1e9:.1f} GB/s; copy ceiling "
        f"measured here {copy_bw / 1e9:.1f} GB/s ({100 * nbytes / dt / copy_bw:.1f}%)")

    if trace_dir:
        from bodge_tpu.utils.profiling import device_lines

        with jax.profiler.trace(trace_dir):
            for _ in range(5):
                t_prev, t_cur = t_cur, compiled(system.data, t_cur, t_prev, inv)
            jax.block_until_ready(t_cur)
        import glob

        path = sorted(glob.glob(f"{trace_dir}/**/*.xplane.pb", recursive=True))[-1]
        for ln in device_lines(jax.profiler.ProfileData.from_file(path)):
            log(f"  trace {ln.plane} | {ln.line}: busy {ln.busy_ns / 5e6:.3f} ms/step, "
                f"window {ln.window_ns / 1e6:.3f} ms, idle share {ln.idle_share:.3f}")
            for name, ns, cnt in ln.top(12):
                log(f"      {ns / 5e6:9.4f} ms/step  x{cnt // 5 if cnt >= 5 else cnt:<3d} {name}")


def phase_quickstart(L):
    import jax

    from bodge_tpu import CubicLattice, Hamiltonian, jσ2, σ0, σ3
    from bodge_tpu.ops import dense as dense_ops

    lattice = CubicLattice((L, L, 1))
    system = Hamiltonian(lattice)
    t, μ, m, Δs = 1, -3, 0.05, 0.10
    t0 = time.perf_counter()
    with system as (H, Δ):
        for i in lattice.sites():
            H[i, i] = -μ * σ0 - m * σ3
            Δ[i, i] = -Δs * jσ2
        for i, j in lattice.bonds():
            H[i, j] = -t * σ0
    log(f"  {L}×{L} s-wave + Zeeman via the with-DSL, dim {system.shape[0]} "
        f"{system.dtype}: built in {time.perf_counter() - t0:.2f} s")

    sectors = dense_ops.decoupled_sectors(system.data, system.skeleton)
    log(f"  decoupled sectors solved one by one: dims {[int(s.size) for s in sectors]}")
    t0 = time.perf_counter()
    E, X = system.diagonalize()
    log(f"  smoke timing: diagonalize() (device eigh incl. compile and host copy) "
        f"{time.perf_counter() - t0:.2f} s; {E.size} positive states, X {X.shape}")
    F = system.free_energy(0.01)
    rho = system.ldos((L // 2, L // 2, 0), [0.0, 0.05, 0.1])
    log(f"  free_energy(0.01) = {F:.6e}; ldos(centre, [0, 0.05, 0.1]) = {np.array2string(rho, precision=5)}")
    log(f"  device peak_bytes_in_use after diagonalize: {peak_memory(jax.devices()[0])}")

    t0 = time.perf_counter()
    E_ref = system.eigenvalues(method="shift_invert", k=8)
    log(f"  reference: host shift-invert ARPACK complex128, {time.perf_counter() - t0:.2f} s: "
        f"{np.array2string(E_ref, precision=7)}")
    norm = np.abs(E).max()
    # A backward-stable complex64 eigensolver errs by ~n·ε₃₂·‖H‖ at worst;
    # 1e-4·‖H‖ (≈1700 ε₃₂·‖H‖) bounds it with room and still resolves the
    # 0.05-wide Zeeman-split gap edges.
    check("lowest 8 positive eigenvalues vs shift-invert",
          np.abs(E[:8] - E_ref).max(), 1e-4 * norm)
    if not (np.isfinite(F) and np.all(np.isfinite(rho)) and rho.min() >= 0):
        raise PhaseFailed("free energy or LDOS is not finite and non-negative")


def phase_selfconsistency(L):
    import jax
    import jax.numpy as jnp

    from bodge_tpu.models import selfconsistency as sc

    system = normal_metal(L)
    N = system.skeleton.n_sites
    V, T, delta0, order, samples = 2.5, 0.05, 0.2, 128, 8
    kw = dict(method="kpm", order=order, samples=samples)
    F_total = sc.make_total_free_energy(system, V=V, temperature=T, **kw)
    cdtype = system.dtype

    def loss(x):
        return F_total(jnp.broadcast_to(x, (N,)).astype(cdtype))

    x0 = jnp.asarray([delta0], jnp.float32)
    F0 = float(loss(x0))
    g = float(jax.grad(loss)(x0)[0])
    eps = 1e-2
    fd = (float(loss(x0 + eps)) - float(loss(x0 - eps))) / (2 * eps)
    # Central difference of a complex64 objective of magnitude ~N: rounding
    # ~1e-4 of the derivative at ε = 1e-2, truncation far below that.
    check("dF/dΔ (uniform) by jax.grad vs central difference", abs(g - fd) / abs(fd), 1e-2)

    t0 = time.perf_counter()
    Δ, F5 = sc.solve_gap(system, V=V, temperature=T, delta0=delta0, steps=5,
                         learning_rate=2.0 / N, uniform=True, **kw)
    log(f"  solve_gap({L}×{L}, kpm order {order}, {samples} probes, 5 steps): "
        f"Δ {delta0} -> {float(np.real(Δ[0])):.6f}, F {F0:.6e} -> {F5:.6e} "
        f"({time.perf_counter() - t0:.2f} s incl. compile)")
    if not F5 < F0:
        raise PhaseFailed(f"objective did not decrease: {F0} -> {F5}")


def phase_multi(L, n=4):
    import jax
    import jax.numpy as jnp

    from bodge_tpu.models import selfconsistency as sc
    from bodge_tpu.ops import chebyshev as kpm
    from bodge_tpu.parallel import RowSharding, free_energy_kpm_sharded, make_row_mesh
    from bodge_tpu.utils.profiling import best_time

    if len(jax.devices()) < n:
        raise PhaseFailed(f"needs {n} devices, found {len(jax.devices())}")
    mesh = make_row_mesh(n)
    system = swave(L)
    sk = system.skeleton
    scale = kpm.spectral_bound(system.data, sk)
    key = jax.random.PRNGKey(3)
    T, order, samples = 0.01, 128, 4
    rs = RowSharding(sk, mesh)
    data_sh = rs.shard_data(system.data)
    one = lambda: kpm.free_energy_kpm(system.data, sk, T, order=order, samples=samples,
                                      key=key, scale=scale)
    sharded = lambda: free_energy_kpm_sharded(rs, data_sh, T, scale, order=order,
                                              samples=samples, key=key)
    F1, Fn = one(), sharded()  # compile
    t_one, t_sharded = best_time(one, repeats=3, warmup=0), best_time(sharded, repeats=3, warmup=0)
    log(f"  {L}×{L} KPM free energy (order {order}, {samples} probes): one card {F1:.8e}, "
        f"{n} cards {Fn:.8e}; smoke timings, best of 3 warm: one card {t_one:.3f} s, "
        f"{n} cards {t_sharded:.3f} s")
    # Same probes and coefficients; only the summation order differs.
    check(f"free energy, {n}-card row-sharded vs one card", abs(Fn - F1) / abs(F1), 1e-5)

    metal = normal_metal(L)
    N = metal.skeleton.n_sites
    kw = dict(V=2.5, temperature=0.05, method="kpm", order=32, samples=4)
    F_one = sc.make_total_free_energy(metal, **kw)
    F_sh = sc.make_total_free_energy(metal, mesh=mesh, **kw)
    x = jnp.full((N,), 0.2, jnp.float32)

    # The objective rides in as an argument, so its operator and probes
    # stay arguments of the compiled program.
    vg = jax.jit(jax.value_and_grad(lambda d, F: F(d.astype(metal.dtype))))

    def value_and_grad(F):
        val, grad = vg(x, F)
        return float(val), np.asarray(grad)

    t0 = time.perf_counter()
    v1, g1 = value_and_grad(F_one)
    t1 = time.perf_counter()
    vn, gn = value_and_grad(F_sh)
    t2 = time.perf_counter()
    log(f"  self-consistency objective at {L}×{L}: one card {v1:.8e} ({t1 - t0:.2f} s), "
        f"{n} cards {vn:.8e} ({t2 - t1:.2f} s); value_and_grad incl. compile")
    check(f"objective, {n}-card vs one card", abs(vn - v1) / abs(v1), 1e-5)
    check(f"gradient dF/dΔ_i, {n}-card vs one card (max over sites / max |g|)",
          np.abs(gn - g1).max() / np.abs(g1).max(), 1e-4)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card row-sharded phase against one card")
    ap.add_argument("--trace", metavar="DIR",
                    help="trace five 1000×1000 Chebyshev steps into DIR and print per-op device time")
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny sizes on any platform (CPU dry run of the control flow)")
    args = ap.parse_args(argv)

    import jax

    sizes = TINY if args.rehearse else FULL
    phases = [("device", lambda: phase_device(args.rehearse))]
    if args.multi:
        phases.append(("multi", lambda: phase_multi(sizes["multi"])))
    else:
        phases += [
            ("kpm", lambda: phase_kpm(sizes["kpm"], args.trace)),
            ("quickstart", lambda: phase_quickstart(sizes["quickstart"])),
            ("selfconsistency", lambda: phase_selfconsistency(sizes["selfconsistency"])),
        ]

    failed = []
    for name, run in phases:
        log(f"phase {name}")
        t0 = time.perf_counter()
        try:
            run()
        except Exception:  # report every phase, then fail the run
            traceback.print_exc()
            failed.append(name)
            log(f"phase {name}: FAILED")
            if name == "device":
                break
        else:
            log(f"phase {name}: ok ({time.perf_counter() - t0:.1f} s)")

    if failed:
        log(f"failed phases: {', '.join(failed)}")
        return 1
    devices = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
