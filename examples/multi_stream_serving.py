#!/usr/bin/env python
"""Batched multi-stream FM serving: B radio clients per dispatch.

The reference serves N independent flowgraphs as N thread sets
(comms-rs src/node/mod.rs:275-284).  Here ONE program launch
carries all B streams per round (runtime.BatchedStreamRunner,
mode='unroll' — bit-identical to B separate runs).

Usage: python examples/multi_stream_serving.py cap1.u8 [cap2.u8 ...]
       (each capture is raw interleaved u8 IQ; each gets its own
        independent receiver state and its own WAV output)
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))  # run examples without install

import sys

import numpy as np

from comms_tpu.io import audio as caudio
from comms_tpu.models import fm_receiver
from comms_tpu.runtime import BatchedStreamRunner
from comms_tpu.runtime.compile_cache import enable_compile_cache


def _blocks(path, block):
    """Per-stream source: interleaved u8 ``[block, 2]`` blocks."""
    raw = np.fromfile(path, dtype=np.uint8)
    raw = raw[: 2 * (raw.size // 2)].reshape(-1, 2)
    if raw.shape[0] < block:
        raise SystemExit(f"{path}: shorter than one block ({block})")
    nblk = raw.shape[0] // block
    for b in range(nblk):
        yield raw[b * block:(b + 1) * block]


def main():
    paths = sys.argv[1:]
    if not paths:
        print(__doc__)
        sys.exit(1)
    enable_compile_cache()
    cfg = fm_receiver.FmReceiverConfig(
        block=16 * fm_receiver.FUSED_BLOCK_QUANTUM)
    if fm_receiver.fused_chain_ok(cfg):      # fused kernel
        step = fm_receiver.make_fused_block_fn(cfg)
        states = [fm_receiver.fused_init_state() for _ in paths]
    else:                                    # XLA chain (same semantics)
        step = fm_receiver.make_block_fn(cfg)
        states = [fm_receiver.init_state(cfg) for _ in paths]

    sinks = []
    for p in paths:
        out = p + ".wav"
        sink = caudio.WavSink(out, channels=1, sample_rate=45600)
        sinks.append(sink)
    try:
        runner = BatchedStreamRunner(
            step, states,
            sources=[_blocks(p, block) for p in paths],
            sinks=[(lambda a, s=s: s.write(
                np.asarray(a) / (np.max(np.abs(a)) or 1.0)))
                   for s in sinks],
            depth=4, mode="unroll")
        meter = runner.run()
        print(meter)
        for p in paths:
            print(f"{p} -> {p}.wav")
    finally:
        for s in sinks:
            s.close()


if __name__ == "__main__":
    main()
