#!/usr/bin/env python
"""Wideband spectral monitor: one 2^20-bin Welch PSD computed
cooperatively by every chip of a mesh (the distributed FFT's consumer,
comms_tpu/parallel/wideband.make_sharded_psd).

The reference's only spectral tool is a single-thread FFT node
(/root/reference/src/fft/mod.rs:73-96); here a spectrum far larger
than one chip's comfortable working set spans the whole mesh, with the
frequency axis staying sharded end to end.

By default it runs on a virtual 8-device CPU mesh; ``--native`` uses
the attached GPUs.  Prints the top-power bins of a synthetic
three-carrier band.

Usage: python examples/wideband_psd.py [fft_size_log2]
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
    from comms_tpu.runtime.compile_cache import enable_compile_cache

    enable_compile_cache()
    if not NATIVE:
        jax.config.update("jax_platforms", "cpu")
    from comms_tpu.parallel import sharding as sh
    from comms_tpu.parallel import wideband

    log2 = int(args[0]) if args else 16
    F, B = 1 << log2, 4
    mesh = sh.time_mesh(min(8, len(jax.devices())))
    psd_fn = wideband.make_sharded_psd(F, mesh)

    # three carriers + noise across the band.
    rng = np.random.default_rng(0)
    t = np.arange(B * F)
    carriers = [0.11, 0.37, 0.68]          # fractions of fs
    x = sum(np.exp(2j * np.pi * f * t) for f in carriers)
    x = (x + 0.1 * (rng.normal(size=B * F) + 1j * rng.normal(size=B * F))
         ).astype(np.complex64)
    pairs = np.stack([x.real, x.imag], -1).reshape(B, F, 2)

    psd = np.asarray(psd_fn(jnp.asarray(pairs)))
    top = np.argsort(psd)[-len(carriers):][::-1]
    print(f"{F}-bin PSD over {mesh.shape['time']} shards; "
          f"top bins: {sorted(top.tolist())}")
    expect = sorted(int(round(f * F)) for f in carriers)
    assert sorted(top.tolist()) == expect, (top, expect)
    print(f"carriers recovered at bins {expect} — OK")


if __name__ == "__main__":
    main()
