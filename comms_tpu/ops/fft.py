"""FFT / IFFT over sample blocks.

Functional parity with the reference's rustfft wrappers
(``/root/reference/src/fft/mod.rs:20-185``):

* ``BatchFFT.run_fft`` — transform one ``fft_size`` block at a time.
* ``SampleFFT`` — accumulate single samples until ``fft_size`` are
  buffered, then transform (fft/mod.rs:106-185).  Under the block
  framework this is pure reblocking (a reshape) + the same batch FFT.
* rustfft's inverse transform is **unnormalized** (no 1/N), so
  reference parity mode keeps that convention; pass
  ``normalize=True`` for the conventional scaled inverse.

Blocks are reshaped to [num_ffts, fft_size] and transformed with one
batched ``jnp.fft.fft`` (cuFFT on the GPU).  The reference upcasts any
input to f64 for the transform (fft/mod.rs:78-96); here the transform
runs in the block's own precision (c64), validated against the
reference tolerance (fft_node.rs:242-244, per-bin error < 1e-5).
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp
from jax import lax

__all__ = ["fft_block", "ifft_block", "fft_reblock", "fft_four_step"]


def fft_block(x, fft_size: int):
    """FFT each consecutive ``fft_size`` chunk of ``x``.

    ``len(x)`` must be a multiple of ``fft_size``; returns the same
    shape flattened back to 1-D (matching the node's stream-of-blocks
    contract, fft_node.rs:26-84).
    """
    x = jnp.asarray(x)
    blocks = x.reshape(-1, int(fft_size))
    return jnp.fft.fft(blocks, axis=-1).reshape(x.shape).astype(
        _complex_like(x)
    )


def ifft_block(x, fft_size: int, normalize: bool = False):
    """Inverse FFT per chunk.  Default is rustfft's unnormalized
    convention (output scaled by N relative to numpy's ifft)."""
    x = jnp.asarray(x)
    blocks = x.reshape(-1, int(fft_size))
    y = jnp.fft.ifft(blocks, axis=-1)
    if not normalize:
        y = y * jnp.asarray(fft_size, dtype=y.real.dtype)
    return y.reshape(x.shape).astype(_complex_like(x))


def fft_reblock(samples, fft_size: int):
    """SampleFFT semantics: view a sample stream as FFT frames,
    dropping the ragged tail (the reference buffers it for the next
    call; in the block framework the pipeline reblocker carries it).

    Returns ``frames[num_ffts, fft_size]`` and the leftover tail.
    """
    samples = jnp.asarray(samples)
    n = (samples.shape[0] // int(fft_size)) * int(fft_size)
    return samples[:n].reshape(-1, int(fft_size)), samples[n:]


def _complex_like(x):
    return jnp.result_type(x.dtype, jnp.complex64)


def fft_four_step(x, radix=None, precision=None, inverse: bool = False,
                  scale: float | None = None):
    """Batched FFT over the last axis as TWO DFT MATMULS (four-step /
    Bailey): N = R*C, a cross-block R-point DFT, exact integer-mod
    twiddles, and a C-point DFT.  Same math as the distributed FFT's
    stages (parallel/dfft.py) collapsed onto one device; parity
    1.5e-7 against numpy at HIGHEST precision.

    Args:
      x: [..., N] complex.
      radix: optional (R, C) with R*C = N; default picks the largest
        R <= 128 dividing N.
      precision: dot precision (default HIGHEST — f32-exact results).
      inverse: conjugate-exponent transform; with the default scale
        (1/N when inverse) this matches ``jnp.fft.ifft``.
      scale: multiplies the result at zero cost (folded into the
        C-point DFT matrix); default 1 forward, 1/N inverse.
    """
    x = jnp.asarray(x)
    N = x.shape[-1]
    if scale is None:
        scale = 1.0 / N if inverse else 1.0
    sgn = 2j if inverse else -2j

    def _fallback(z):
        y = jnp.fft.ifft(z) * (N * scale) if inverse else \
            jnp.fft.fft(z) * scale if scale != 1.0 else jnp.fft.fft(z)
        return y
    if radix is None:
        R = 128
        while R > 1 and N % R:
            R //= 2
        if R == 1 or N // R > 4096:
            # No 128-wide factor, or the dense C x C DFT matrix would
            # be huge (C = 8192 is already a 512 MB constant and an
            # N*C-flop stage) — the four-step form targets small-to-
            # mid N; for large transforms use jnp.fft or the
            # distributed FFT (parallel/dfft.py).
            return _fallback(x)
        radix = (R, N // R)
    R, C = map(int, radix)
    if R * C != N:
        raise ValueError(f"radix {radix} does not factor N = {N}")
    if max(R, C) > 8192:
        raise ValueError(
            f"radix {radix}: a dense {max(R, C)}^2 DFT matrix is "
            "impractical (memory/flops grow quadratically); refactor N "
            "or use jnp.fft / parallel.dfft")
    if R == 1 or C == 1:
        return _fallback(x)
    prec = precision if precision is not None else lax.Precision.HIGHEST
    cdtype = _complex_like(x)

    p = np.arange(R)
    d_r = np.exp((sgn * np.pi / R) * np.mod(np.outer(p, p), R)
                 ).astype(cdtype)
    j = np.arange(C)
    tw = np.exp((sgn * np.pi / N) * np.mod(np.outer(p, j), N)
                ).astype(cdtype)
    d_c = (scale * np.exp((sgn * np.pi / C) * np.mod(np.outer(j, j), C))
           ).astype(cdtype)

    lead = x.shape[:-1]
    xm = x.reshape((-1, R, C))
    g = jnp.einsum("ps,bsj->bpj", d_r, xm, precision=prec) * tw[None]
    z = jnp.einsum("bpj,jm->bpm", g, d_c, precision=prec)
    # X[k], k = p + R*m  ->  [b, m, p] then flatten.
    return jnp.swapaxes(z, 1, 2).reshape(lead + (N,)).astype(cdtype)
