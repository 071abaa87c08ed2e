#!/usr/bin/env python
"""QPSK transmit chain -> qpsk_out.bin.

Parity with /root/reference/examples/single_thread_qpsk.rs (random
bits -> QPSK -> RRC -> *8192 -> i16 IQ file), plus optional mixer
upconversion (--dphase).

Usage: python examples/qpsk_mod.py [num_blocks] [out_path] [dphase]
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))  # run examples without install

import sys

from comms_tpu.models import qpsk_tx


def main():
    from comms_tpu.runtime.compile_cache import enable_compile_cache

    enable_compile_cache()
    blocks = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    out = sys.argv[2] if len(sys.argv) > 2 else "qpsk_out.bin"
    dphase = float(sys.argv[3]) if len(sys.argv) > 3 else 0.0
    cfg = qpsk_tx.QpskTxConfig(dphase=dphase)
    n = qpsk_tx.run_to_file(out, blocks, cfg)
    print(f"wrote {n} samples to {out}")


if __name__ == "__main__":
    main()
