"""Spectral monitoring: Welch power spectral density + spectrogram.

Beyond the reference (its only spectral tool is the raw FFT node);
production serving needs live spectrum observability — channel
occupancy, interference, SNR monitoring.  Welch's method is
FFT-over-overlapped-windowed-segments + average: batched FFT work
(``jnp.fft``, cuFFT on the GPU), one jittable function.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

__all__ = ["hann", "welch_psd", "welch_psd_planar", "spectrogram"]


def hann(n: int) -> np.ndarray:
    """Periodic Hann window (host, float64)."""
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)


def _segments(x, nperseg: int, noverlap: int):
    x = jnp.asarray(x)
    step = nperseg - noverlap
    if step <= 0:
        raise ValueError(f"noverlap {noverlap} must be < nperseg {nperseg}")
    nseg = (x.shape[0] - noverlap) // step
    if nseg < 1:
        raise ValueError(
            f"signal length {x.shape[0]} shorter than one segment "
            f"({nperseg})"
        )
    if nperseg % step == 0:
        # Gather-free overlapped view: when step divides nperseg the
        # segments split into k = nperseg/step interleaved groups, one
        # contiguous shifted reshape each (k=2 at the default 50%
        # overlap) — O(k) HLO ops total, not O(nseg).
        k = nperseg // step
        parts = []
        for o in range(k):
            m = -(-(nseg - o) // k) if nseg > o else 0
            part = x[o * step: o * step + m * nperseg].reshape(m, nperseg)
            parts.append(part)
        mmax = parts[0].shape[0]
        padded = [
            jnp.concatenate(
                [p, jnp.zeros((mmax - p.shape[0], nperseg), p.dtype)])
            if p.shape[0] < mmax else p
            for p in parts
        ]
        inter = jnp.stack(padded, axis=1).reshape(mmax * k, nperseg)
        return inter[:nseg]
    # Non-dividing overlaps: one gather op.
    idx = jnp.arange(nseg)[:, None] * step + jnp.arange(nperseg)[None, :]
    return x[idx]


def welch_psd_planar(re, im, nperseg: int = 1024, window=None,
                     fs: float = 1.0, onesided: bool = False):
    """Plane-native Welch PSD at the standard 50% overlap: raw f32
    re/im planes in (the serving-ingest layout); otherwise
    :func:`welch_psd`."""
    x = jax.lax.complex(jnp.asarray(re, jnp.float32),
                        jnp.asarray(im, jnp.float32))
    return welch_psd(x, nperseg=nperseg, window=window, fs=fs,
                     onesided=onesided)


def welch_psd(x, nperseg: int = 1024, noverlap: int | None = None,
              window=None, fs: float = 1.0, onesided: bool = False):
    """Welch PSD estimate of a (complex or real) sample block.

    Returns ``(freqs, psd)``; density normalization matches the
    standard Welch definition (window power corrected).  ``onesided``
    folds the spectrum for real inputs.
    """
    x = jnp.asarray(x)
    nperseg = int(nperseg)
    noverlap = nperseg // 2 if noverlap is None else int(noverlap)
    # Traced windows are legal (tiny [nperseg] operand); the window
    # power correction then computes on device.
    traced_w = isinstance(window, jax.Array)
    if traced_w:
        w = window.astype(jnp.float32)
    else:
        w = np.asarray(window) if window is not None else hann(nperseg)
    if w.shape[0] != nperseg:
        raise ValueError("window length must equal nperseg")

    if traced_w:
        scale = 1.0 / (fs * jnp.sum(w ** 2))
    else:
        scale = 1.0 / (fs * float(np.sum(w ** 2)))
    segs = _segments(x, nperseg, noverlap)           # [nseg, nperseg]
    segs = segs - jnp.mean(segs, axis=1, keepdims=True)
    wv = w if traced_w else jnp.asarray(w.astype(np.float32))
    xs = segs * wv[None, :]
    spec = jnp.fft.fft(xs, axis=1)
    p = jnp.mean(jnp.abs(spec) ** 2, axis=0)
    psd = p * jnp.asarray(scale, p.dtype)
    return _fold(psd, nperseg, fs, onesided)


def _fold(psd, nperseg: int, fs: float, onesided: bool):
    freqs = np.fft.fftfreq(nperseg, d=1.0 / fs)
    if onesided:
        half = nperseg // 2 + 1
        psd = psd[:half] * jnp.where(
            (jnp.arange(half) > 0) & (jnp.arange(half) < nperseg - half + 1),
            2.0, 1.0)
        freqs = np.abs(freqs[:half])
        freqs[-1] = abs(fs / 2.0)
    return freqs, psd


def spectrogram(x, nperseg: int = 256, noverlap: int | None = None,
                window=None):
    """Short-time power spectrogram [time, freq] (fftshifted)."""
    x = jnp.asarray(x)
    noverlap = nperseg // 2 if noverlap is None else int(noverlap)
    w = np.asarray(window) if window is not None else hann(nperseg)
    segs = _segments(x, int(nperseg), noverlap)
    wv = jnp.asarray(w.astype(np.float32))
    spec = jnp.fft.fft(segs * wv[None, :], axis=1)
    return jnp.fft.fftshift(jnp.abs(spec) ** 2, axes=1)
