#!/usr/bin/env python
"""BPSK transmit chain -> bpsk_out.bin.

Parity with /root/reference/examples/bpsk_mod.rs and
single_thread_bpsk.rs (random bits -> BPSK -> RRC(32, sps=4, 0.25)
-> *8192 -> i16 IQ file); the whole graph is one jitted block.

Usage: python examples/bpsk_mod.py [num_blocks] [out_path]
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))  # run examples without install

import sys

from comms_tpu.models import bpsk_tx


def main():
    from comms_tpu.runtime.compile_cache import enable_compile_cache

    enable_compile_cache()
    blocks = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    out = sys.argv[2] if len(sys.argv) > 2 else "bpsk_out.bin"
    n = bpsk_tx.run_to_file(out, blocks)
    print(f"wrote {n} samples to {out}")


if __name__ == "__main__":
    main()
