#!/usr/bin/env python
"""Play (or transcode) a raw PCM file.

Parity with /root/reference/examples/play_audio.rs: stream file
samples into the audio sink (live device when available, WAV file
otherwise).

Usage: python examples/play_audio.py input.f32 [out.wav] [rate]
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))  # run examples without install

import sys

from comms_tpu.models import play_audio


def main():
    from comms_tpu.runtime.compile_cache import enable_compile_cache

    enable_compile_cache()
    if len(sys.argv) < 2:
        print(__doc__)
        sys.exit(1)
    src = sys.argv[1]
    out = sys.argv[2] if len(sys.argv) > 2 else "play_out.wav"
    rate = int(sys.argv[3]) if len(sys.argv) > 3 else 44100
    n = play_audio.play_file(src, out, sample_rate=rate)
    print(f"played {n} samples")


if __name__ == "__main__":
    main()
