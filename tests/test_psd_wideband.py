"""Large-N FFT and wideband Welch PSD (2^16-bin class) through the
ops and the sharded monitors, against numpy f64 oracles.

Parity bound: the reference node tolerance of 1e-5
(fft_node.rs:242-244) at relative scale for spectra; 2e-5 where
|.|^2 doubles a transform's relative error.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from comms_tpu.ops import fft as cfft
from comms_tpu.ops import spectrum
from comms_tpu.parallel import sharding as sh
from comms_tpu.parallel import wideband


def _relmax(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _cplx(rng, *shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)
            ).astype(np.complex64)


def _welch_acc(x, n, w):
    """Non-overlapping Welch numerator (sum of |fft(demeaned*w)|^2)
    through welch_psd."""
    nseg = len(x) // n
    _, p = spectrum.welch_psd(jnp.asarray(x), nperseg=n, noverlap=0,
                              window=w)
    return np.asarray(p, np.float64) * nseg * float(
        np.sum(np.asarray(w, np.float64) ** 2))


def _numerator_oracle(x2d, w):
    xm = x2d.astype(np.complex128)
    xm = xm - xm.mean(axis=1, keepdims=True)
    return (np.abs(np.fft.fft(xm * w[None, :], axis=1)) ** 2).sum(0)


def test_four_step_large_n_routes():
    # 2^16 factors as 128 x 512 DFT matmuls; 2^20 (C > 4096) falls
    # back to jnp.fft — both numpy-exact
    rng = np.random.default_rng(12)
    for n in (1 << 16, 1 << 20):
        x = _cplx(rng, 1, n)
        got = np.asarray(cfft.fft_four_step(jnp.asarray(x)))
        assert _relmax(got, np.fft.fft(x, axis=1)) < 1e-5, n


def test_fft_big_matches_numpy():
    rng = np.random.default_rng(0)
    N = 256 * 512
    x = _cplx(rng, 2, N)
    got = np.asarray(cfft.fft_block(jnp.asarray(x.ravel()), N)
                     ).reshape(2, N)
    assert _relmax(got, np.fft.fft(x, axis=1)) < 1e-5


def test_psd_big_matches_numpy_welch_numerator():
    rng = np.random.default_rng(1)
    N, B = 256 * 256, 3
    x = _cplx(rng, B, N)
    w = np.hanning(N).astype(np.float32)
    acc = _welch_acc(x.ravel(), N, w)
    ref = _numerator_oracle(x, w)
    assert np.max(np.abs(acc - ref)) / ref.max() < 1e-5


def test_psd_big_no_window_no_demean():
    # a rectangular window on a zero-mean stream: the numerator is the
    # plain |fft|^2
    rng = np.random.default_rng(2)
    N = 256 * 256
    x = _cplx(rng, 1, N)
    x = (x - x.mean()).astype(np.complex64)
    acc = _welch_acc(x.ravel(), N, np.ones(N, np.float32))
    ref = (np.abs(np.fft.fft(x.astype(np.complex128), axis=1)) ** 2).sum(0)
    assert np.max(np.abs(acc - ref)) / ref.max() < 1e-5


def test_validation_errors():
    z = jnp.zeros(256 * 256, jnp.complex64)
    with pytest.raises(ValueError, match="window length"):
        spectrum.welch_psd(z, nperseg=1024, window=np.ones(512))
    with pytest.raises(ValueError, match="must be <"):
        spectrum.welch_psd(z, nperseg=1024, noverlap=1024)
    with pytest.raises(ValueError, match="shorter than one segment"):
        spectrum.welch_psd(z[:512], nperseg=1024)


def test_wideband_psd_single_shard_matches_welch_oracle():
    # make_sharded_psd on a 1-shard mesh == the Welch oracle (same
    # window, demean, density normalization)
    rng = np.random.default_rng(3)
    F, B = 1 << 16, 2
    x = _cplx(rng, B * F)
    psd_fn = wideband.make_sharded_psd(F, sh.time_mesh(1))
    pairs = np.stack([x.real, x.imag], -1).reshape(B, F, 2)
    got = np.asarray(psd_fn(jnp.asarray(pairs)))
    _, ref = spectrum.welch_psd(jnp.asarray(x), nperseg=F, noverlap=0)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) / np.max(ref) < 2e-5


def test_welch_psd_big_overlapped_matches_oracle():
    # 50% overlap at a big nperseg (the shifted-reshape segment view)
    rng = np.random.default_rng(4)
    F = 1 << 16
    x = _cplx(rng, 2 * F)
    w = spectrum.hann(F)
    _, got = spectrum.welch_psd(jnp.asarray(x), nperseg=F)
    segs = np.stack([x[s0:s0 + F] for s0 in (0, F // 2, F)])
    ref = _numerator_oracle(segs, w) / 3 / np.sum(w ** 2)
    assert _relmax(got, ref) < 2e-5


def test_fft_four_step_2pow16_matches_numpy():
    rng = np.random.default_rng(5)
    n = 1 << 16
    x = _cplx(rng, 2, n)
    got = np.asarray(cfft.fft_four_step(jnp.asarray(x)))
    assert _relmax(got, np.fft.fft(x, axis=1)) < 1e-5


def test_sharded_psd_segments_matches_welch_oracle():
    # segment-parallel composition: segments sharded over the 8-device
    # mesh, one psum combines — equals the Welch oracle
    rng = np.random.default_rng(6)
    F, B = 1 << 16, 8
    x = _cplx(rng, B * F)
    psd_fn = wideband.make_sharded_psd_segments(F, sh.time_mesh(8))
    pairs = np.stack([x.real, x.imag], -1).reshape(B, F, 2)
    got = np.asarray(psd_fn(jnp.asarray(pairs)))
    _, ref = spectrum.welch_psd(jnp.asarray(x), nperseg=F, noverlap=0)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) / np.max(ref) < 2e-5


def test_sharded_psd_segments_small():
    rng = np.random.default_rng(8)
    F, B = 1 << 12, 8
    x = _cplx(rng, B * F)
    psd_fn = wideband.make_sharded_psd_segments(F, sh.time_mesh(4))
    pairs = np.stack([x.real, x.imag], -1).reshape(B, F, 2)
    got = np.asarray(psd_fn(jnp.asarray(pairs)))
    _, ref = spectrum.welch_psd(jnp.asarray(x), nperseg=F, noverlap=0)
    assert np.max(np.abs(got - np.asarray(ref))) / np.max(ref) < 1e-5


def test_planar_psd_matches_pairs_psd():
    rng = np.random.default_rng(9)
    F, B = 1 << 16, 2
    re = rng.normal(size=(B, F)).astype(np.float32)
    im = rng.normal(size=(B, F)).astype(np.float32)
    mesh = sh.time_mesh(1)
    a = np.asarray(wideband.make_sharded_psd(F, mesh)(
        jnp.asarray(np.stack([re, im], -1))))
    b = np.asarray(wideband.make_sharded_psd_planar(F, mesh)(
        jnp.asarray(re), jnp.asarray(im)))
    assert np.max(np.abs(b - a)) / np.max(np.abs(a)) < 2e-5


def test_hann_is_edge_sparse_and_demean_exact():
    # the periodic Hann window's spectrum is 3-sparse, and the
    # numerator of a zero-mean-ish stream matches the demeaned oracle
    rng = np.random.default_rng(10)
    N = 256 * 256
    x = _cplx(rng, 2, N)
    w = spectrum.hann(N).astype(np.float32)
    spec = np.abs(np.fft.fft(w.astype(np.float64)))
    assert list(np.nonzero(spec > 1e-6 * spec.max())[0]) == [0, 1, N - 1]
    acc = _welch_acc(x.ravel(), N, w)
    ref = _numerator_oracle(x, w)
    assert np.abs(acc - ref).max() / ref.max() < 2e-5


def test_large_dc_offset_is_removed():
    # a 5-sigma DC offset: per-segment demean must remove it
    rng = np.random.default_rng(11)
    N = 256 * 256
    x = (rng.normal(size=(2, N)) + 5.0
         + 1j * (rng.normal(size=(2, N)) - 3.0)).astype(np.complex64)
    w = spectrum.hann(N).astype(np.float32)
    acc = _welch_acc(x.ravel(), N, w)
    ref = _numerator_oracle(x, w)
    assert np.abs(acc - ref).max() / ref.max() < 5e-4


def test_sharded_psd_bad_window_raises_valueerror():
    bad = 1 << 16
    mesh = sh.time_mesh(1)
    for make in (wideband.make_sharded_psd,
                 wideband.make_sharded_psd_planar,
                 wideband.make_sharded_psd_segments):
        with pytest.raises(ValueError, match="window length"):
            make(bad, mesh, window=np.ones(bad // 2))


def test_spectrogram_big_segments():
    rng = np.random.default_rng(13)
    n = 1 << 16
    x = _cplx(rng, 2 * n)
    s = np.asarray(spectrum.spectrogram(jnp.asarray(x), nperseg=n))
    w = spectrum.hann(n)
    segs = np.stack([x[s0:s0 + n] for s0 in (0, n // 2, n)]
                    ).astype(np.complex128)
    ref = np.fft.fftshift(np.abs(np.fft.fft(segs * w, axis=1)) ** 2,
                          axes=1)
    assert s.shape == (3, n)
    assert _relmax(s, ref) < 1e-4


def test_planar_psd_3d_ingest_matches_2d():
    # Pre-factorized [segments, n1, n2] planes (the serving shape) are
    # accepted and give the flat [segments, N] result.
    rng = np.random.default_rng(9)
    n1, n2 = 256, 256
    re = rng.normal(size=(2, n1 * n2)).astype(np.float32)
    im = rng.normal(size=(2, n1 * n2)).astype(np.float32)
    fn = wideband.make_sharded_psd_planar(n1 * n2, sh.time_mesh(1))
    a2 = np.asarray(fn(jnp.asarray(re), jnp.asarray(im)))
    a3 = np.asarray(fn(jnp.asarray(re.reshape(2, n1, n2)),
                       jnp.asarray(im.reshape(2, n1, n2))))
    np.testing.assert_array_equal(a3, a2)


def test_welch_planar_matches_complex_big():
    rng = np.random.default_rng(7)
    F = 1 << 16
    x = _cplx(rng, 2 * F)
    _, want = spectrum.welch_psd(jnp.asarray(x), nperseg=F)
    _, got = spectrum.welch_psd_planar(
        jnp.asarray(x.real.copy()), jnp.asarray(x.imag.copy()), nperseg=F)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-6, atol=0)
