#!/usr/bin/env python
"""FM broadcast receiver: recorded IQ capture -> demodulated audio.

Parity with /root/reference/examples/fm_radio.rs with the SDR source
replaced by a recorded rtl-sdr capture (raw interleaved u8 IQ) and the
audio device replaced by a WAV file — the BASELINE's file-driven form.

Usage: python examples/fm_radio.py capture.u8 [out.wav]
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))  # run examples without install

import sys

import numpy as np

from comms_tpu.io import audio as caudio
from comms_tpu.models import fm_receiver


def main():
    from comms_tpu.runtime.compile_cache import enable_compile_cache

    enable_compile_cache()
    if len(sys.argv) < 2:
        print(__doc__)
        sys.exit(1)
    cap = sys.argv[1]
    out = sys.argv[2] if len(sys.argv) > 2 else "fm_audio.wav"
    # 1.14 Msps capture, /25 -> 45.6 kHz audio (fm_radio.rs:57,148-151).
    audio = fm_receiver.run_file(cap)
    if len(audio) == 0:
        print(f"capture shorter than one block "
              f"({fm_receiver.FmReceiverConfig().block} samples); "
              f"nothing to demodulate")
        sys.exit(1)
    with caudio.WavSink(out, channels=1, sample_rate=45600) as sink:
        peak = np.max(np.abs(audio)) or 1.0
        sink.write(audio / peak)
    print(f"wrote {len(audio)} audio samples to {out}")


if __name__ == "__main__":
    main()
