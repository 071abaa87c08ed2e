#!/usr/bin/env python
"""Sharded fused FM chain demo: the single-kernel receiver on every
device of a mesh, bit-identical to the sequential stream.

The whole-graph concurrency of the reference
(comms-rs src/node/mod.rs:275-284) across devices: each shard
runs the complete chain on its time slice; one ppermute of the raw u8
tail per boundary is the only communication
(comms_tpu/parallel/fused_wideband.py).

By default it runs on a virtual 8-device CPU mesh with the kernel in
the Pallas interpreter; ``--native`` runs the compiled kernel on the
attached GPUs.  Either way it checks bit-exactness against the
sequential streaming path.

Usage: python examples/fused_sharded_fm.py [n_devices] [--native]
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))  # run examples without install

import os
import sys

NATIVE = "--native" in sys.argv   # run on attached accelerators
if __name__ == "__main__" and not NATIVE:
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np
import jax
import jax.numpy as jnp

args = [a for a in sys.argv[1:] if not a.startswith("-")]


def main():
    if not NATIVE:
        jax.config.update("jax_platforms", "cpu")
    from comms_tpu.models import fm_receiver
    from comms_tpu.parallel import fused_wideband, sharding as sh
    from comms_tpu.runtime.compile_cache import enable_compile_cache

    enable_compile_cache()
    n = int(args[0]) if args else min(8, len(jax.devices()))
    per_shard = fm_receiver.FUSED_BLOCK_QUANTUM
    N = n * per_shard
    interpret = not NATIVE

    mesh = sh.time_mesh(n)
    step = fused_wideband.make_sharded_fused_step(
        mesh, block=N, interpret=interpret)

    rng = np.random.default_rng(0)
    iq = rng.integers(0, 256, size=(N, 2), dtype=np.uint8)
    state = fused_wideband.fused_init_state()
    audio, state = step(state, jnp.asarray(iq))
    print(f"{n} shards x {per_shard} samples -> {audio.shape[0]} "
          f"audio samples")

    # sequential oracle: the same stream through make_fused_block_fn.
    cfg = fm_receiver.FmReceiverConfig(block=per_shard)
    blk = fm_receiver.make_fused_block_fn(cfg, interpret=interpret)
    st = fm_receiver.fused_init_state()
    chunks = []
    for b in range(n):
        a, st = blk(st, jnp.asarray(iq[b * per_shard:(b + 1) * per_shard]))
        chunks.append(np.asarray(a))
    ref = np.concatenate(chunks)
    exact = np.array_equal(np.asarray(audio), ref)
    print(f"sharded == sequential stream: {'BIT-EXACT' if exact else 'NO'}")
    assert exact


if __name__ == "__main__":
    main()
