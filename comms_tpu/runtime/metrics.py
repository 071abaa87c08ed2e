"""Observability: throughput counters, roofline estimates, profiling.

The reference has no tracing/metrics at all (SURVEY.md section 5 —
only test printlns).  Here every pipeline can be wrapped in a
:class:`ThroughputMeter`, ops can be annotated with
:func:`named_scope` (shows up in ``jax.profiler`` traces), and
:func:`roofline` turns op shapes into bytes/FLOP bounds so a bench
can report percent-of-speed-of-light.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time

import jax

__all__ = ["PEAKS", "ThroughputMeter", "device_peaks", "named_scope",
           "roofline", "trace"]

# Published dense peaks per device, keyed by ``device_kind`` as JAX
# reports it.  Source: NVIDIA H100 Tensor Core GPU datasheet (dense
# rates, i.e. the datasheet's sparsity figures halved), at the card's
# full power limit (700 W SXM, 350 W PCIe).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {          # H100 SXM5
        "hbm_gbps": 3350.0, "bf16_tflops": 989.0, "tf32_tflops": 495.0,
        "f32_tflops": 67.0, "int8_tops": 1979.0,
    },
    "NVIDIA H100 PCIe": {
        "hbm_gbps": 2000.0, "bf16_tflops": 756.0, "tf32_tflops": 378.0,
        "f32_tflops": 51.0, "int8_tops": 1513.0,
    },
}


def device_peaks(device_kind: str | None = None) -> dict:
    """The :data:`PEAKS` row of ``device_kind`` (default: the first
    device's).  A device without a row is an error, not a default."""
    if device_kind is None:
        device_kind = jax.devices()[0].device_kind
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device {device_kind!r}; "
            f"known: {sorted(PEAKS)}") from None


@dataclasses.dataclass
class ThroughputMeter:
    """Samples/s counter for a block-streaming loop.

    >>> m = ThroughputMeter()
    >>> with m.block(num_samples=262144): y, s = step(s, x)
    >>> m.report()
    """

    samples: int = 0
    seconds: float = 0.0
    blocks: int = 0

    @contextlib.contextmanager
    def block(self, num_samples: int):
        t0 = time.perf_counter()
        yield
        self.seconds += time.perf_counter() - t0
        self.samples += int(num_samples)
        self.blocks += 1

    @property
    def msps(self) -> float:
        return self.samples / self.seconds / 1e6 if self.seconds else 0.0

    def report(self) -> dict:
        return {
            "samples": self.samples,
            "blocks": self.blocks,
            "seconds": round(self.seconds, 4),
            "Msamples_per_s": round(self.msps, 2),
        }

    def __str__(self):
        return json.dumps(self.report())


def named_scope(name: str):
    """Profiler annotation for an op region (jax.named_scope)."""
    return jax.named_scope(name)


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace around a region; view with TensorBoard or
    xprof."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def roofline(bytes_moved: int, flops: int, seconds: float,
             hbm_gbps: float, peak_tflops: float) -> dict:
    """Percent-of-speed-of-light for a measured kernel execution.

    ``bytes_moved``: device-memory traffic (read + write); ``flops``:
    useful floating ops; the peaks from :func:`device_peaks` or a
    same-run measurement.  The bound is max(bytes/BW, flops/peak).
    """
    t_mem = bytes_moved / (hbm_gbps * 1e9)
    t_cmp = flops / (peak_tflops * 1e12)
    t_sol = max(t_mem, t_cmp)
    return {
        "sol_seconds": t_sol,
        "bound": "memory" if t_mem >= t_cmp else "compute",
        "pct_of_sol": round(100.0 * t_sol / seconds, 1) if seconds else 0.0,
        "achieved_gbps": round(bytes_moved / seconds / 1e9, 1)
        if seconds else 0.0,
        "achieved_tflops": round(flops / seconds / 1e12, 3)
        if seconds else 0.0,
    }
