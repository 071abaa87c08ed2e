#!/usr/bin/env python
"""QPSK over the network transport (two processes).

Parity with /root/reference/examples/qpsk_zmq.rs: sender generates
QPSK sample blocks and pushes them over a socket; receiver
deserializes and reports.

Usage:
  python examples/qpsk_zmq.py recv tcp://127.0.0.1:5556 [blocks] [codec] &
  python examples/qpsk_zmq.py send tcp://127.0.0.1:5556 [blocks] [codec]

codec "cbor" speaks the reference's serde_cbor wire format — point
"send" at a running comms-rs ZMQRecv (or "recv" at its ZMQSend) to
interoperate with the Rust peer directly.
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))  # run examples without install

import sys

from comms_tpu.models import qpsk_stream


def main():
    from comms_tpu.runtime.compile_cache import enable_compile_cache

    enable_compile_cache()
    if len(sys.argv) < 3 or sys.argv[1] not in ("send", "recv"):
        print(__doc__)
        sys.exit(1)
    role, endpoint = sys.argv[1], sys.argv[2]
    blocks = int(sys.argv[3]) if len(sys.argv) > 3 else 10
    codec = sys.argv[4] if len(sys.argv) > 4 else "raw"
    if role == "send":
        n = qpsk_stream.stream_blocks(endpoint, blocks, codec=codec)
        print(f"sent {n} samples")
    else:
        got = qpsk_stream.receive_blocks(endpoint, blocks, codec=codec)
        print(f"received {sum(len(b) for b in got)} samples "
              f"in {len(got)} blocks")


if __name__ == "__main__":
    main()
