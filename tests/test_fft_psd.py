"""Batched FFT, Welch PSD and spectrogram ops vs numpy f64 oracles.

Tolerances follow the reference FFT node's per-bin bound
(fft_node.rs:242-244, < 1e-5) scaled to relative error.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from comms_tpu.ops import fft as cfft
from comms_tpu.ops import spectrum


def _rel(y, ref):
    return np.max(np.abs(y - ref)) / np.max(np.abs(ref))


def _cplx(rng, *shape):
    return (rng.standard_normal(shape) +
            1j * rng.standard_normal(shape)).astype(np.complex64)


def _welch_acc(x, n, w, noverlap=None):
    """Sum over segments of |fft(demeaned * w)|^2 through welch_psd
    (which returns the mean, window-power normalized)."""
    noverlap = n // 2 if noverlap is None else noverlap
    nseg = (len(x) - noverlap) // (n - noverlap)
    _, p = spectrum.welch_psd(jnp.asarray(x), nperseg=n,
                              noverlap=noverlap, window=w)
    return np.asarray(p, np.float64) * nseg * float(np.sum(np.asarray(
        w, np.float64) ** 2))


def _welch_oracle(x, n, w, step=None):
    step = n // 2 if step is None else step
    ref = np.zeros(n)
    for s0 in np.arange(0, len(x) - n + 1, step):
        seg = x[s0:s0 + n].astype(np.complex128)
        seg = seg - seg.mean()
        ref += np.abs(np.fft.fft(seg * w)) ** 2
    return ref


@pytest.mark.parametrize("n", [256, 512, 1024, 2048, 4096, 16384])
def test_fft_parity(n):
    rng = np.random.default_rng(0)
    rows = 5
    x = _cplx(rng, rows, n)
    ref = np.fft.fft(x.astype(np.complex128), axis=1)
    y = np.asarray(cfft.fft_block(jnp.asarray(x.ravel()), n)
                   ).reshape(rows, n)
    assert _rel(y, ref) < 1e-5
    y = np.asarray(cfft.fft_four_step(jnp.asarray(x)))
    assert _rel(y, ref) < 1e-5


def test_fft_row_padding():
    """Row counts that are not a power of two keep their shape."""
    rng = np.random.default_rng(1)
    x = _cplx(rng, 3, 1024)
    y = np.asarray(cfft.fft_four_step(jnp.asarray(x)))
    ref = np.fft.fft(x.astype(np.complex128), axis=1)
    assert y.shape == (3, 1024)
    assert _rel(y, ref) < 1e-5


def test_fft_rejects_unsupported():
    with pytest.raises(ValueError, match="does not factor"):
        cfft.fft_four_step(jnp.zeros((4, 100), jnp.complex64),
                           radix=(16, 8))
    with pytest.raises(ValueError, match="impractical"):
        cfft.fft_four_step(jnp.zeros((1, 16384 * 2), jnp.complex64),
                           radix=(2, 16384))


def test_psd_accumulator():
    rng = np.random.default_rng(2)
    rows, n = 6, 1024
    x = _cplx(rng, rows, n)
    win = spectrum.hann(n)
    acc = _welch_acc(x.ravel(), n, win, noverlap=0)
    xm = x.astype(np.complex128)
    xm = xm - xm.mean(axis=1, keepdims=True)
    ref = (np.abs(np.fft.fft(xm * win[None, :], axis=1)) ** 2).sum(axis=0)
    assert _rel(acc, ref) < 1e-5


def test_psd_row_weights_exclude_rows():
    """Rows with weight 0 are left out of the accumulation."""
    rng = np.random.default_rng(3)
    rows, n = 5, 512
    x = _cplx(rng, rows, n)
    win = spectrum.hann(n)
    wts = np.array([1, 0, 1, 0, 1], np.float32)
    acc = _welch_acc(x[wts > 0].ravel(), n, win, noverlap=0)
    xm = x.astype(np.complex128)
    xm = xm - xm.mean(axis=1, keepdims=True)
    ref = (np.abs(np.fft.fft(xm * win[None, :], axis=1)) ** 2 *
           wts[:, None]).sum(axis=0)
    assert _rel(acc, ref) < 1e-5


def test_welch_psd_matches_oracle():
    """welch_psd at the default 50% overlap == the f64 segment oracle
    with Welch's density normalization."""
    rng = np.random.default_rng(4)
    x = _cplx(rng, 1 << 14)
    n = 1024
    w = spectrum.hann(n)
    f, p = spectrum.welch_psd(jnp.asarray(x), nperseg=n)
    np.testing.assert_array_equal(f, np.fft.fftfreq(n))
    nseg = 2 * (len(x) // n) - 1
    ref = _welch_oracle(x, n, w) / nseg / np.sum(w ** 2)
    assert _rel(np.asarray(p), ref) < 1e-4


def test_welch_psd_real_input_onesided():
    import scipy.signal

    rng = np.random.default_rng(5)
    x = rng.standard_normal(1 << 13).astype(np.float32)
    _, p = spectrum.welch_psd(jnp.asarray(x), nperseg=512, onesided=True)
    _, ref = scipy.signal.welch(x.astype(np.float64),
                                window=spectrum.hann(512), nperseg=512,
                                return_onesided=True, scaling="density")
    assert _rel(np.asarray(p), ref) < 1e-4


def test_welch_psd_nondividing_overlap():
    """Gather-pattern overlaps (step does not divide nperseg)."""
    rng = np.random.default_rng(6)
    x = _cplx(rng, 1 << 13)
    n, nov = 1024, 300
    w = spectrum.hann(n)
    acc = _welch_acc(x, n, w, noverlap=nov)
    assert _rel(acc, _welch_oracle(x, n, w, step=n - nov)) < 1e-5


def test_spectrogram_matches_oracle():
    rng = np.random.default_rng(7)
    x = _cplx(rng, 1 << 13)
    n = 256
    w = spectrum.hann(n)
    s = np.asarray(spectrum.spectrogram(jnp.asarray(x), nperseg=n))
    segs = np.stack([x[s0:s0 + n] for s0 in
                     range(0, len(x) - n + 1, n // 2)]).astype(np.complex128)
    ref = np.fft.fftshift(np.abs(np.fft.fft(segs * w, axis=1)) ** 2, axes=1)
    assert s.shape == ref.shape
    assert _rel(s, ref) < 1e-4


def test_fft_four_step_folded_scale():
    """``scale`` folds into the host DFT matrix and must match a
    post-multiplied numpy FFT."""
    rng = np.random.default_rng(8)
    z = _cplx(rng, 8, 1024)
    s = 1.0 / 32.0
    got = np.asarray(cfft.fft_four_step(jnp.asarray(z), scale=s))
    ref = np.fft.fft(z, axis=1) * s
    assert _rel(got, ref) < 1e-5


def test_fft_plane_swap_involution():
    """With unitary scale s = 1/sqrt(n), step(z) = swap(s*fft(swap(z)))
    applied twice is an exact bin reversal — magnitudes (and the L2
    norm) are preserved."""
    rng = np.random.default_rng(9)
    n = 1024
    z = _cplx(rng, 4, n)
    s = 1.0 / np.sqrt(n)

    def swap(v):
        return jnp.imag(v) + 1j * jnp.real(v)

    def step(v):
        return swap(cfft.fft_four_step(swap(v), scale=s))

    got = np.asarray(step(step(jnp.asarray(z))))
    rev = z[:, np.mod(-np.arange(n), n)]
    assert _rel(got, rev) < 1e-4
    assert abs(np.linalg.norm(got) / np.linalg.norm(z) - 1.0) < 1e-5


def test_welch_stream_matches_oracle():
    """Welch over one and several blocks' worth of segments ==
    materialized-segments oracle."""
    rng = np.random.default_rng(10)
    n = 1024
    w = spectrum.hann(n).astype(np.float32)
    for steps in (1, 3):
        x = _cplx(rng, 8 * n * steps)
        acc = _welch_acc(x, n, w)
        assert _rel(acc, _welch_oracle(x, n, w)) < 1e-4, steps


def test_welch_psd_planar_matches_complex_entry():
    rng = np.random.default_rng(11)
    n = 1024
    x = _cplx(rng, 8 * n)
    _, p_ref = spectrum.welch_psd(jnp.asarray(x), nperseg=n)
    _, p_got = spectrum.welch_psd_planar(
        jnp.asarray(x.real.astype(np.float32)),
        jnp.asarray(x.imag.astype(np.float32)), nperseg=n)
    assert _rel(np.asarray(p_got), np.asarray(p_ref)) < 1e-6


def test_psd_accumulator_extended_size():
    """A wideband window size (4096) against the f64 oracle."""
    rng = np.random.default_rng(12)
    rows, n = 4, 4096
    x = _cplx(rng, rows, n)
    win = spectrum.hann(n)
    acc = _welch_acc(x.ravel(), n, win, noverlap=0)
    xm = x.astype(np.complex128)
    xm = xm - xm.mean(axis=1, keepdims=True)
    ref = (np.abs(np.fft.fft(xm * win[None, :], axis=1)) ** 2).sum(axis=0)
    assert _rel(acc, ref) < 1e-5
