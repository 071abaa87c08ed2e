"""Demod/estimator parity: same synthetic-signal setups and tolerances
as the reference's statistical tests (frequency_estimator.rs:56-95 tol
0.01, phase_estimator.rs:76-125 tol 1e-6 / 0.01,
timing_estimator.rs:148-192 tol 0.01) plus an FM-demod oracle."""

import numpy as np
import jax.numpy as jnp

from comms_tpu.ops import demodulation as demod
from comms_tpu.ops import fir, pulse, resample, taps


def oracle_fm(x, prev):
    out = []
    for s in x:
        out.append(np.angle(s * np.conj(prev)))
        prev = s
    return np.array(out), prev


def test_fm_demod_matches_oracle_across_blocks():
    rng = np.random.default_rng(0)
    ph = np.cumsum(0.3 * rng.normal(size=400))
    x = np.exp(1j * ph).astype(np.complex128)
    expected, _ = oracle_fm(x, 0j)

    prev = demod.fm_demod_init(dtype=jnp.complex128)
    got = []
    for i in range(4):
        y, prev = demod.fm_demod_block(jnp.asarray(x[i*100:(i+1)*100]), prev)
        got.append(np.asarray(y))
    assert np.allclose(np.concatenate(got), expected, atol=1e-9)


def test_fm_demod_first_sample_zero_prev():
    y, _ = demod.fm_demod_block(jnp.array([1.0 + 1.0j]),
                                demod.fm_demod_init())
    # arg(x * conj(0)) = arg(0) = 0, as the reference's zero init.
    assert np.asarray(y)[0] == 0.0


def test_frequency_estimator_reference_setup():
    # frequency_estimator.rs:57-95: QPSK syms, 4x oversample,
    # rrc(16, 4, 0.75), offset 0.123456789, tol 0.01.
    rng = np.random.default_rng(0)
    sym = np.exp(1j * (2 * np.pi * rng.integers(0, 4, size=4096) / 4))
    ups = np.zeros(len(sym) * 4, dtype=np.complex128)
    ups[::4] = sym
    t = taps.rrc_taps(16, 4.0, 0.75)
    data = np.asarray(fir.fir_apply(jnp.asarray(ups), t))
    truth = 0.123456789
    data = data * np.exp(1j * truth * np.arange(len(data)))

    est = float(demod.frequency_offset_estimate(jnp.asarray(data)))
    assert abs(truth - est) < 0.01


def test_frequency_estimator_pure_tone_exact():
    w = 0.05
    x = np.exp(1j * w * np.arange(1000))
    est = float(demod.frequency_offset_estimate(jnp.asarray(x)))
    assert abs(est - w) < 1e-9


def test_psk_phase_estimator_reference_setup():
    rng = np.random.default_rng(0)
    truth = 0.123456
    sym = np.exp(1j * (2 * np.pi * rng.integers(0, 8, size=1000) / 8 + truth))
    est = float(demod.psk_phase_estimate(jnp.asarray(sym), 8))
    assert abs(truth - est) < 1e-6


def test_qam_phase_estimator_reference_setup():
    rng = np.random.default_rng(0)
    truth = 0.123456
    v = rng.integers(0, 16, size=1000)
    sym = ((v % 4) - 1.5 + 1j * (np.trunc(v / 4.0) - 1.5)) * 2.0
    sym = sym * np.exp(1j * truth)
    est = float(demod.qam_phase_estimate(jnp.asarray(sym)))
    assert abs(truth - est) < 0.01


def test_timing_estimator_reference_setup():
    # timing_estimator.rs:149-192: QPSK at 10 sps, rrc(101, 10, 0.5),
    # slice off `truth` samples, estimate ~ -truth, tol 0.01.
    rng = np.random.default_rng(0)
    sps, alpha, truth = 10, 0.5, 2
    sym = np.exp(1j * (2 * np.pi * rng.integers(0, 4, size=1000) / 4
                       + np.pi / 4))
    ups = np.zeros(len(sym) * sps, dtype=np.complex128)
    ups[::sps] = sym
    t = taps.rrc_taps(sps * 10 + 1, float(sps), alpha)
    samples = np.asarray(fir.fir_apply(jnp.asarray(ups), t))

    est = demod.TimingEstimator(n=sps, d=5, alpha=alpha)
    e = float(est.estimate(jnp.asarray(samples[truth:])))
    assert abs(truth + e) < 0.01


def test_fast_atan2_matches_numpy():
    rng = np.random.default_rng(0)
    y = rng.normal(size=20000).astype(np.float32)
    x = rng.normal(size=20000).astype(np.float32)
    got = np.asarray(demod.fast_atan2(jnp.asarray(y), jnp.asarray(x)))
    ref = np.arctan2(y, x)
    assert np.abs(got - ref).max() < 1e-6


def test_fast_atan2_branch_cuts_and_zeros():
    # IEEE signed-zero semantics on the x<0 cut, like f32::atan2
    ys = np.array([0.0, -0.0, 0.0, -0.0, 1.0, -1.0, 0.0],
                  dtype=np.float32)
    xs = np.array([-1.0, -1.0, 1.0, 1.0, 0.0, 0.0, 0.0],
                  dtype=np.float32)
    got = np.asarray(demod.fast_atan2(jnp.asarray(ys), jnp.asarray(xs)))
    ref = np.arctan2(ys, xs)
    assert np.abs(got - ref).max() < 1e-6


def test_fast_atan2_extreme_magnitudes():
    # review finding: the 1/x sign trick loses the sign for -inf and
    # for |x| > ~8.5e37 (1/x flushes subnormal to -0); signbit
    # is exact
    ys = np.array([1.0, 1.0, -1.0, 1.0, 3e38], dtype=np.float32)
    xs = np.array([-np.inf, -3e38, -3e38, np.inf, -1.0],
                  dtype=np.float32)
    got = np.asarray(demod.fast_atan2(jnp.asarray(ys), jnp.asarray(xs)))
    ref = np.arctan2(ys, xs)
    assert np.abs(got - ref).max() < 1e-6
