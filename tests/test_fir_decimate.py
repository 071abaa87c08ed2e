"""Polyphase decimating FIR (``ops.fir.fir_decimate_poly``) vs a
numpy direct-form oracle: real and complex taps, short and long
filters, streaming context, and the planar/vmapped form the band
monitor's audio stage uses."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from comms_tpu.ops import fir


def _direct_dec(x, taps, dec, ctx=None):
    """y[m] = sum_k taps[k] x[m*dec - k], ``ctx`` the samples before x
    (oldest first, zeros when None)."""
    T = len(taps)
    ctx = np.zeros(T - 1, np.complex128) if ctx is None else ctx
    xe = np.concatenate([np.asarray(ctx, np.complex128),
                         np.asarray(x, np.complex128)])
    full = np.convolve(xe, np.asarray(taps, np.complex128))
    n0 = len(xe) - len(x)
    return full[n0:n0 + len(x)][::dec]


def _poly(x, taps, dec, ctx=None):
    C = fir.decimating_branch_taps(np.asarray(taps), dec)
    dt = jnp.result_type(jnp.asarray(x).dtype, C.dtype)
    c = (jnp.zeros(C.size - 1, dt) if ctx is None
         else jnp.asarray(ctx[-(C.size - 1):], dt))
    y, new_ctx = fir.fir_decimate_poly(jnp.asarray(x), C, c)
    return np.asarray(y), new_ctx


def _rel(got, ref):
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


@pytest.mark.parametrize("dec,taps_len", [(5, 63), (4, 12), (2, 33),
                                          (3, 1), (5, 640)])
def test_matches_direct_form(dec, taps_len):
    rng = np.random.default_rng(dec * 100 + taps_len)
    N = 16 * dec * 128 * 2
    x = (rng.normal(size=N) + 1j * rng.normal(size=N)).astype(np.complex64)
    taps = rng.normal(size=taps_len).astype(np.float32)
    got, _ = _poly(x, taps, dec)
    ref = _direct_dec(x, taps, dec)
    assert got.shape == ref.shape == (N // dec,)
    assert _rel(got, ref) < 5e-6


def test_complex_taps():
    rng = np.random.default_rng(7)
    dec = 5
    N = 16 * dec * 128 * 2
    x = (rng.normal(size=N) + 1j * rng.normal(size=N)).astype(np.complex64)
    taps = (rng.normal(size=63) + 1j * rng.normal(size=63)
            ).astype(np.complex64)
    got, _ = _poly(x, taps, dec)
    assert _rel(got, _direct_dec(x, taps, dec)) < 5e-6


def test_streaming_ctx_matches_one_shot():
    """Chopping the stream with the carried context reproduces the
    one-shot output."""
    rng = np.random.default_rng(3)
    dec, T = 5, 63
    N = 16 * dec * 128 * 2
    x = rng.normal(size=N).astype(np.float32)
    taps = rng.normal(size=T).astype(np.float32)
    one, _ = _poly(x, taps, dec)
    h = N // 2
    a, ctx = _poly(x[:h], taps, dec)
    b, _ = _poly(x[h:], taps, dec, np.asarray(ctx))
    assert _rel(np.concatenate([a, b]), one) < 1e-6


def test_validation_errors():
    C = fir.decimating_branch_taps(np.ones(63, np.float32), 5)
    with pytest.raises(ValueError, match="multiple of rate"):
        fir.fir_decimate_poly(jnp.zeros(1002, jnp.float32), C,
                              jnp.zeros(C.size - 1, jnp.float32))
    with pytest.raises(ValueError, match="multiple of rate"):
        fir.fir_decimate_poly(jnp.zeros(1001, jnp.float32), C,
                              jnp.zeros(C.size - 1, jnp.float32))


def test_long_filters_at_several_rates():
    """Filters as long as dec*128 taps, the longest the band layout
    packs into one previous row."""
    for dec in (1, 2, 5):
        T = dec * 128
        rng = np.random.default_rng(T)
        N = 16 * dec * 128
        x = (rng.normal(size=N) + 1j * rng.normal(size=N)
             ).astype(np.complex64)
        taps = rng.normal(size=T).astype(np.float32)
        got, _ = _poly(x, taps, dec)
        assert _rel(got, _direct_dec(x, taps, dec)) < 1e-5, dec


def test_real_taps_dec5():
    rng = np.random.default_rng(0)
    N = 5 * 128 * 64
    x = (rng.normal(size=N) + 1j * rng.normal(size=N)).astype(np.complex64)
    taps = rng.normal(size=63)
    got, _ = _poly(x, taps.astype(np.float32), 5)
    assert _rel(got, _direct_dec(x, taps, 5)) < 5e-6


def test_complex_taps_dec4():
    rng = np.random.default_rng(1)
    N = 4 * 128 * 64
    x = (rng.normal(size=N) + 1j * rng.normal(size=N)).astype(np.complex64)
    taps = rng.normal(size=48) + 1j * rng.normal(size=48)
    got, _ = _poly(x, taps.astype(np.complex64), 4)
    assert _rel(got, _direct_dec(x, taps, 4)) < 5e-6


def test_streaming_with_nonzero_context():
    rng = np.random.default_rng(2)
    N = 5 * 128 * 64
    x = (rng.normal(size=2 * N) + 1j * rng.normal(size=2 * N)
         ).astype(np.complex64)
    taps = rng.normal(size=63).astype(np.float32)
    y1, ctx = _poly(x[:N], taps, 5)
    y2, _ = _poly(x[N:], taps, 5, np.asarray(ctx))
    y = np.concatenate([y1, y2])
    assert _rel(y, _direct_dec(x, taps, 5)) < 5e-6


def test_long_filter_256_taps():
    # a 256-tap channel-select FIR (routine in SDR)
    rng = np.random.default_rng(20)
    taps = rng.normal(size=256)
    N = 5 * 128 * 64
    x = (rng.normal(size=N) + 1j * rng.normal(size=N)).astype(np.complex64)
    got, _ = _poly(x, taps.astype(np.float32), 5)
    assert _rel(got, _direct_dec(x, taps, 5)) < 1e-5


def test_long_filter_streaming_641_taps():
    rng = np.random.default_rng(21)
    taps = rng.normal(size=641).astype(np.float32)
    N = 5 * 128 * 64
    x = (rng.normal(size=2 * N) + 1j * rng.normal(size=2 * N)
         ).astype(np.complex64)
    y1, ctx = _poly(x[:N], taps, 5)
    y2, _ = _poly(x[N:], taps, 5, np.asarray(ctx))
    got = np.concatenate([y1, y2])
    assert _rel(got, _direct_dec(x, taps, 5)) < 1e-5


def test_vmapped_planar_channels():
    """The band monitor's audio stage: one decimator vmapped over the
    channel axis equals per-channel direct form."""
    rng = np.random.default_rng(22)
    K, N, dec = 4, 4 * 128 * 16, 4
    d = rng.normal(size=(K, N)).astype(np.float32)
    taps = rng.normal(size=33).astype(np.float32)
    C = fir.decimating_branch_taps(taps, dec)
    out, _ = jax.vmap(lambda dk, ak: fir.fir_decimate_poly(dk, C, ak))(
        jnp.asarray(d), jnp.zeros((K, C.size - 1), jnp.float32))
    for k in range(K):
        assert _rel(np.asarray(out[k]), _direct_dec(d[k], taps, dec).real
                    ) < 5e-6
