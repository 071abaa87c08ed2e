#!/usr/bin/env python
"""Streaming QPSK receiver demo: continuous synchronization over a
simulated channel with a mid-stream carrier-frequency step.

The reference ships the estimator PIECES (frequency/phase/timing,
/root/reference/src/demodulation/) but never a closed receiver; this
demo runs ``models/qpsk_rx_stream`` — carried matched filter, EMA'd
carrier and timing, Costas fine tracking — through the StreamRunner
serving loop and reports the bit error rate.

Usage: python examples/qpsk_receiver.py [num_blocks]
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))  # run examples without install

import sys

import numpy as np
import jax.numpy as jnp

from comms_tpu.models import qpsk_rx_stream
from comms_tpu.models.qpsk_rx import decide_bits
from comms_tpu.ops import taps
from comms_tpu.runtime.stream import StreamRunner

SPS, T, BETA = 4, 32, 0.25


def make_channel(bits, freq1, freq2, step_at, delay, phase0):
    rrc = np.asarray(taps.rrc_taps(T, float(SPS), BETA))
    rrc = rrc / np.sqrt(np.sum(np.abs(rrc) ** 2))
    pairs = bits.reshape(-1, 2)
    sym = ((2.0 * pairs[:, 0] - 1) + 1j * (2.0 * pairs[:, 1] - 1)
           ).astype(np.complex64)
    up = np.zeros(len(sym) * SPS, np.complex64)
    up[::SPS] = sym
    s = np.convolve(up, rrc.astype(np.complex64))[: len(up)]
    X = np.fft.fft(np.concatenate([s, np.zeros(256, s.dtype)]))
    k = np.fft.fftfreq(len(X))
    s = np.fft.ifft(X * np.exp(-2j * np.pi * k * delay))[: len(s)]
    n = np.arange(len(s))
    dph = np.where(n < step_at, freq1, freq2)
    return (s * np.exp(1j * (phase0 + np.cumsum(dph)))).astype(np.complex64)


def main():
    from comms_tpu.runtime.compile_cache import enable_compile_cache

    enable_compile_cache()
    n_blocks = int(sys.argv[1]) if len(sys.argv) > 1 else 24
    cfg = qpsk_rx_stream.QpskRxStreamConfig(block=8192)
    rng = np.random.default_rng(0)
    n_sym = n_blocks * cfg.syms_per_block + 64
    bits = rng.integers(0, 2, size=2 * n_sym).astype(np.uint8)
    r = make_channel(bits, 0.01, 0.013, n_blocks * cfg.block // 2,
                     1.4, 0.7)

    blocks = (
        np.stack([r[b * cfg.block:(b + 1) * cfg.block].real,
                  r[b * cfg.block:(b + 1) * cfg.block].imag],
                 axis=-1).astype(np.float32)
        for b in range(n_blocks)
    )
    out = []
    runner = StreamRunner(qpsk_rx_stream.make_stream_fn(cfg),
                          qpsk_rx_stream.init_state(cfg),
                          blocks, sink=out.append)
    meter = runner.run()

    skip = 3  # acquisition blocks
    sym = np.concatenate(out[skip:])
    sym = sym[:, 0] + 1j * sym[:, 1]
    best = None
    for rot in range(4):
        cand = decide_bits(sym * np.exp(1j * np.pi / 2 * rot))
        for lag in range(-24, 25):
            s0 = 2 * (skip * cfg.syms_per_block + lag)
            if s0 < 0:
                continue
            ref = bits[s0:]
            m = min(len(cand), len(ref))
            errs = int(np.sum(cand[:m] != ref[:m]))
            if best is None or errs < best[0]:
                best = (errs, m)
    errs, m = best
    print(f"{n_blocks} blocks ({meter.report()['samples']:,} samples), "
          f"frequency step at midpoint")
    print(f"BER after acquisition: {errs}/{m} = {errs / m:.2e}")


if __name__ == "__main__":
    main()
