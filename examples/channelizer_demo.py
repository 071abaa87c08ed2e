#!/usr/bin/env python
"""64-channel polyphase channelizer demo (BASELINE config 4).

Feeds a multi-tone test signal through the channelizer and prints the
per-channel power map — each tone lands in its own channel.

Usage: python examples/channelizer_demo.py [num_channels]
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))  # run examples without install

import sys

import numpy as np
import jax.numpy as jnp

from comms_tpu.models import channelizer


def main():
    from comms_tpu.runtime.compile_cache import enable_compile_cache

    enable_compile_cache()
    K = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    cfg = channelizer.ChannelizerConfig(num_channels=K, block=K * 2048)
    block = channelizer.make_block_fn(cfg)
    state = channelizer.init_state(cfg)

    n = np.arange(cfg.block)
    tones = [3, K // 2, K - 5]
    x = sum(np.exp(2j * np.pi * c * n / K) for c in tones)
    pairs = np.stack([x.real, x.imag], -1).astype(np.float32)

    yp, state = block(state, jnp.asarray(pairs))
    yp = np.asarray(yp)
    power = (yp[..., 0] ** 2 + yp[..., 1] ** 2).mean(axis=0)
    top = np.argsort(power)[-len(tones):]
    print(f"tones at channels {sorted(tones)}; "
          f"detected {sorted(top.tolist())}")


if __name__ == "__main__":
    main()
