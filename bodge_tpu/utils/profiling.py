"""Roofline accounting and benchmark timing helpers.

[NEW SCOPE] — the reference's only timing code is a min-over-repeats timer
in its benchmark script; here every hot kernel is additionally measured
against the device's published peaks and a copy ceiling measured in the
same process, since block-sparse SpMM at 4×4 block size is memory-bound by
construction.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable

import jax
import jax.numpy as jnp


def best_time(fn: Callable[[], object], repeats: int = 5, warmup: int = 2) -> float:
    """Minimum wall-clock over repeats of ``fn()``, which is waited on with
    ``jax.block_until_ready`` inside the timed region."""
    for _ in range(warmup):
        jax.block_until_ready(fn())
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def measure_copy_bandwidth(nbytes: int = 1 << 30) -> float:
    """Bytes/s a plain device copy-and-scale of ``nbytes`` reaches: one full
    read plus one full write per pass, best of several timed passes.  The
    practical memory ceiling to compare a kernel against."""
    x = jnp.ones((nbytes // 4,), jnp.float32)
    copy = jax.jit(lambda v: v * 1.0000001)
    t = best_time(lambda: copy(x), repeats=10, warmup=2)
    return 2 * x.nbytes / t


@dataclass(frozen=True)
class DevicePeaks:
    """Published per-device peaks (dense rates, no sparsity)."""

    hbm_bytes_per_s: float
    hbm_bytes: float
    fp64_flops: float
    fp32_flops: float
    tf32_flops: float
    bf16_flops: float
    source: str


_H100_SXM = DevicePeaks(
    hbm_bytes_per_s=3.35e12,
    hbm_bytes=80e9,
    fp64_flops=34e12,
    fp32_flops=67e12,
    tf32_flops=495e12,
    bf16_flops=989e12,
    source="NVIDIA H100 Tensor Core GPU data sheet, SXM part (dense rates, 700 W)",
)

# Keyed by ``jax.Device.device_kind`` exactly as JAX reports it.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": _H100_SXM,
}


def peaks_for_device(device=None) -> DevicePeaks:
    """Published peaks of ``device`` (default: the first device).

    Raises ``KeyError`` for a device kind that is not in
    :data:`DEVICE_PEAKS`: a roofline against a guessed peak is wrong.
    """
    device = device or jax.devices()[0]
    kind = device.device_kind
    if kind not in DEVICE_PEAKS:
        raise KeyError(
            f"no published peaks for device kind {kind!r}; add a row with its "
            "source to bodge_tpu.utils.profiling.DEVICE_PEAKS"
        )
    return DEVICE_PEAKS[kind]


@dataclass
class Roofline:
    """Memory-roofline verdict for one measured kernel."""

    time_s: float
    bytes_moved: int
    flops: int
    hbm_bw: float

    @property
    def achieved_bw(self) -> float:
        return self.bytes_moved / self.time_s

    @property
    def fraction_of_roof(self) -> float:
        return self.achieved_bw / self.hbm_bw

    @property
    def roof_time_s(self) -> float:
        return self.bytes_moved / self.hbm_bw

    def summary(self) -> str:
        return (
            f"{self.time_s*1e6:.1f} µs ({self.achieved_bw/1e9:.1f} GB/s, "
            f"{100*self.fraction_of_roof:.1f}% of {self.hbm_bw/1e9:.0f} GB/s roof)"
        )


@dataclass
class DeviceLine:
    """Device time on one line (an XLA op or stream lane) of a trace."""

    plane: str
    line: str
    busy_ns: float  # union of the event intervals
    window_ns: float  # first event start to last event end
    op_ns: dict  # total duration per event name
    op_count: dict  # events per name

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_ns / self.window_ns if self.window_ns else 0.0

    def top(self, n: int = 10):
        """The ``n`` event names with the most device time, as
        ``(name, total_ns, count)``, longest first."""
        ranked = sorted(self.op_ns.items(), key=lambda kv: -kv[1])[:n]
        return [(k, v, self.op_count[k]) for k, v in ranked]


def device_lines(profile) -> list:
    """Reduce a ``jax.profiler.ProfileData`` to per-line device times.

    Every line of every ``/device:`` plane becomes one :class:`DeviceLine`
    (host planes are skipped).  Busy time is the union of the line's event
    intervals, so nested or overlapping events are not counted twice.
    """
    out = []
    for plane in profile.planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            spans, op_ns, op_count = [], {}, {}
            for ev in line.events:
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                op_ns[ev.name] = op_ns.get(ev.name, 0.0) + ev.duration_ns
                op_count[ev.name] = op_count.get(ev.name, 0) + 1
            if not spans:
                continue
            spans.sort()
            busy, cur_lo, cur_hi = 0.0, spans[0][0], spans[0][1]
            for lo, hi in spans[1:]:
                if lo > cur_hi:
                    busy += cur_hi - cur_lo
                    cur_lo, cur_hi = lo, hi
                else:
                    cur_hi = max(cur_hi, hi)
            busy += cur_hi - cur_lo
            window = max(hi for _, hi in spans) - spans[0][0]
            out.append(DeviceLine(plane.name, line.name, busy, window, op_ns, op_count))
    return out
