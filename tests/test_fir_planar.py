"""FIR ops (banded-GEMM ``fir_block``, planar ``fir_apply_planar``,
polyphase ``fir_decimate_poly``) vs a numpy direct-form oracle, and
the QPSK correlation-panel estimates vs direct lag sums."""

import numpy as np
import pytest

import jax.numpy as jnp

from comms_tpu.ops import fir


def _relmax(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _direct(x, taps, ctx=None):
    """y[n] = sum_k taps[k] x[n-k], with ``ctx`` the T-1 samples
    before x (oldest first; zeros when None)."""
    T = len(taps)
    ctx = np.zeros(T - 1, x.dtype) if ctx is None else ctx
    xe = np.concatenate([ctx, x]).astype(np.complex128)
    return np.convolve(xe, np.asarray(taps, np.complex128))[T - 1:T - 1 + len(x)]


def test_fir_block_matches_direct_form():
    rng = np.random.default_rng(0)
    T = 63
    t = (rng.normal(size=T) + 1j * rng.normal(size=T)).astype(np.complex64)
    x = (rng.normal(size=40000) + 1j * rng.normal(size=40000)).astype(
        np.complex64)
    ctx = (rng.normal(size=T - 1) + 1j * rng.normal(size=T - 1)).astype(
        np.complex64)
    y, new_ctx = fir.fir_block(jnp.asarray(x), t, jnp.asarray(ctx))
    assert _relmax(y, _direct(x, t, ctx)) < 5e-6
    assert np.array_equal(np.asarray(new_ctx), x[-(T - 1):])


def test_fir_block_ragged_length():
    # N not a multiple of the 128-phase row: padded, trimmed back.
    rng = np.random.default_rng(1)
    T = 33
    t = rng.normal(size=T).astype(np.complex64)
    x = rng.normal(size=5000).astype(np.complex64)
    y, _ = fir.fir_block(jnp.asarray(x), t, fir.init_ctx(T))
    assert y.shape == (5000,)
    assert _relmax(y, _direct(x, t)) < 5e-6


def test_fir_decimate_rejects_ragged_block():
    C = fir.decimating_branch_taps(np.ones(63, np.float32), 5)
    with pytest.raises(ValueError, match="multiple of rate"):
        fir.fir_decimate_poly(jnp.zeros(1001, jnp.float32), C,
                              jnp.zeros(C.size - 1, jnp.float32))


def test_fir_block_long_filter_257_taps():
    rng = np.random.default_rng(30)
    taps = (rng.normal(size=257) + 1j * rng.normal(size=257)
            ).astype(np.complex64)
    x = (rng.normal(size=4096) + 1j * rng.normal(size=4096)
         ).astype(np.complex64)
    ctx = (rng.normal(size=256) + 1j * rng.normal(size=256)
           ).astype(np.complex64)
    y, _ = fir.fir_block(jnp.asarray(x), fir.banded_tap_matrix(taps),
                         jnp.asarray(ctx))
    assert _relmax(y, _direct(x, taps, ctx)) < 1e-5


def test_fir_block_streaming_matches_one_shot():
    """Chopping the stream into blocks with carried context matches
    the one-shot output and the direct-form oracle."""
    rng = np.random.default_rng(7)
    T = 63
    taps = (rng.normal(size=T) + 1j * rng.normal(size=T)
            ).astype(np.complex64)
    N = 16 * 128 * 4
    z = (rng.normal(size=N) + 1j * rng.normal(size=N)).astype(np.complex64)
    y1, _ = fir.fir_block(jnp.asarray(z), taps, fir.init_ctx(T))
    h = N // 2
    ya, ctx = fir.fir_block(jnp.asarray(z[:h]), taps, fir.init_ctx(T))
    yb, _ = fir.fir_block(jnp.asarray(z[h:]), taps, ctx)
    got = np.concatenate([np.asarray(ya), np.asarray(yb)])
    assert _relmax(got, np.asarray(y1)) < 1e-6
    assert _relmax(got, _direct(z, taps)) < 5e-6


def test_fir_planar_real_taps_matches_direct_form():
    rng = np.random.default_rng(8)
    taps = rng.normal(size=63).astype(np.float32)
    N = 8 * 128 * 2
    xr = rng.normal(size=N).astype(np.float32)
    xi = rng.normal(size=N).astype(np.float32)
    yr, yi = fir.fir_apply_planar(jnp.asarray(xr), jnp.asarray(xi),
                                  fir.banded_tap_matrix(taps))
    got = np.asarray(yr) + 1j * np.asarray(yi)
    assert _relmax(got, _direct((xr + 1j * xi).astype(np.complex64),
                                taps)) < 5e-6


def test_fir_decimate_poly_matches_direct_form():
    rng = np.random.default_rng(9)
    taps = rng.normal(size=63).astype(np.float32)
    x = rng.normal(size=5 * 2000).astype(np.float32)
    C = fir.decimating_branch_taps(taps, 5)
    y, ctx = fir.fir_decimate_poly(jnp.asarray(x), C,
                                   jnp.zeros(C.size - 1, jnp.float32))
    assert y.shape == (2000,)
    assert _relmax(y, _direct(x, taps)[::5].real) < 5e-6
    assert np.array_equal(np.asarray(ctx), x[-(C.size - 1):])


def test_fir_planar_single_tap_gain():
    """T=1 (pure gain) scales exactly."""
    rng = np.random.default_rng(12)
    N = 8 * 128
    xr = rng.normal(size=N).astype(np.float32)
    xi = rng.normal(size=N).astype(np.float32)
    yr, yi = fir.fir_apply_planar(
        jnp.asarray(xr), jnp.asarray(xi),
        fir.banded_tap_matrix(np.array([2.0], np.float32)))
    assert np.array_equal(np.asarray(yr), 2.0 * xr)
    assert np.array_equal(np.asarray(yi), 2.0 * xi)


def test_panel_estimates_match_direct_lag_sums():
    """The correlation panels' v = -1 diagonal gives the coarse
    carrier estimate: the angle of sum x[k] conj(x[k-1])."""
    from comms_tpu.models import qpsk_rx

    cfg = qpsk_rx.QpskRxConfig()
    rng = np.random.default_rng(3)
    N = 1 << 14
    w = 0.013
    x = (np.exp(1j * w * np.arange(N))
         + 0.1 * (rng.standard_normal(N) + 1j * rng.standard_normal(N))
         ).astype(np.complex64)
    panels = cfg.timing.corr_panels(jnp.asarray(x.real.copy()),
                                    jnp.asarray(x.imag.copy()),
                                    halfwidth=cfg.panel_hw)
    f_est = float(qpsk_rx._estimates_from_panels(cfg, panels)[0])
    direct = float(np.angle(np.sum(x[1:] * np.conj(x[:-1]))))
    assert abs(f_est - direct) < 1e-3
    assert abs(f_est - w) < 2e-3
