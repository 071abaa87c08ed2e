#!/usr/bin/env python
"""Wideband FM band monitor: channelize a capture and demodulate
every channel at once (vmapped receivers).

Usage: python examples/fm_band_monitor.py capture.f32pairs [K]

The capture is raw float32 re/im pairs at the wideband rate; each of
the K channels' audio is written to fm_ch<k>.wav.
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))  # run examples without install

import sys

import numpy as np
import jax.numpy as jnp

from comms_tpu.io import audio as caudio
from comms_tpu.models import fm_band_monitor as fbm


def main():
    from comms_tpu.runtime.compile_cache import enable_compile_cache

    enable_compile_cache()
    if len(sys.argv) < 2:
        print(__doc__)
        sys.exit(1)
    K = int(sys.argv[2]) if len(sys.argv) > 2 else 16
    raw = np.fromfile(sys.argv[1], dtype=np.float32).reshape(-1, 2)

    cfg = fbm.BandMonitorConfig(num_channels=K,
                                block=(len(raw) // (K * 4)) * K * 4)
    block = fbm.make_block_fn(cfg)
    audio, _ = block(fbm.init_state(cfg), jnp.asarray(raw[: cfg.block]))
    audio = np.asarray(audio)

    for k in range(K):
        a = audio[k]
        peak = np.max(np.abs(a)) or 1.0
        with caudio.WavSink(f"fm_ch{k}.wav", channels=1,
                            sample_rate=44100) as sink:
            sink.write(a / peak)
    print(f"wrote {K} channel WAVs ({audio.shape[1]} samples each)")


if __name__ == "__main__":
    main()
