"""Channelizer op and model at serving sizes vs the direct
mix->FIR->decimate oracle (``ops.channelizer.channelize_oracle``),
plus the band monitor's staged channelize stage."""

import numpy as np
import jax.numpy as jnp

from comms_tpu.ops import channelizer as chan

_N = 16384


def _rel(got, ref):
    return np.max(np.abs(np.asarray(got) - ref)) / np.abs(ref).max()


def _noise(rng, n):
    return (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)


def test_channelizer_parity():
    rng = np.random.default_rng(0)
    x = _noise(rng, 2 * _N)
    h = chan.design_prototype(64, 8)
    Hb = chan.branch_taps(h.astype(np.float32), 64)
    y, _ = chan.channelize_block(jnp.asarray(x), Hb,
                                 chan.channelizer_init_ctx(len(h)))
    ref = chan.channelize_oracle(x, h, 64)
    assert np.asarray(y).shape == ref.shape
    assert _rel(y, ref) < 1e-5


def test_channelizer_streaming():
    rng = np.random.default_rng(1)
    x = _noise(rng, 2 * _N)
    h = chan.design_prototype(64, 8)
    Hb = chan.branch_taps(h.astype(np.float32), 64)
    ctx = chan.channelizer_init_ctx(len(h))
    y1, ctx = chan.channelize_block(jnp.asarray(x[:_N]), Hb, ctx)
    y2, _ = chan.channelize_block(jnp.asarray(x[_N:]), Hb, ctx)
    got = np.concatenate([np.asarray(y1), np.asarray(y2)])
    assert _rel(got, chan.channelize_oracle(x, h, 64)) < 1e-5


def test_channelizer_model_pairs_and_planar_interchange():
    # make_block_fn and make_planar_block_fn share the state layout:
    # a stream can switch between them mid-flight.
    from comms_tpu.models import channelizer as model

    rng = np.random.default_rng(3)
    cfg = model.ChannelizerConfig(block=_N)
    blk = model.make_block_fn(cfg)
    blk_p = model.make_planar_block_fn(cfg)
    x = _noise(rng, 2 * _N)
    s = model.init_state(cfg)
    pairs = np.stack([x[:_N].real, x[:_N].imag], -1)
    y1, s = blk(s, jnp.asarray(pairs))
    (yr, yi), _ = blk_p(s, jnp.asarray(x[_N:].real.copy()),
                        jnp.asarray(x[_N:].imag.copy()))
    got = np.concatenate([np.asarray(y1[..., 0]) + 1j * np.asarray(y1[..., 1]),
                          np.asarray(yr) + 1j * np.asarray(yi)])
    assert _rel(got, chan.channelize_oracle(x, cfg.prototype, 64)) < 1e-5


def test_channelizer_k16():
    rng = np.random.default_rng(5)
    x = _noise(rng, _N)
    h = chan.design_prototype(16, 8)
    Hb = chan.branch_taps(h.astype(np.float32), 16)
    y, _ = chan.channelize_block(jnp.asarray(x), Hb,
                                 chan.channelizer_init_ctx(len(h)))
    assert np.asarray(y).shape == (_N // 16, 16)
    assert _rel(y, chan.channelize_oracle(x, h, 16)) < 1e-5


def test_channelizer_k100_not_dividing_128():
    # a whole FM band (100 channels of 200 kHz): K need not divide 128
    rng = np.random.default_rng(6)
    x = _noise(rng, 100 * 160)
    h = chan.design_prototype(100, 8)
    Hb = chan.branch_taps(h.astype(np.float32), 100)
    y, _ = chan.channelize_block(jnp.asarray(x), Hb,
                                 chan.channelizer_init_ctx(len(h)))
    assert _rel(y, chan.channelize_oracle(x, h, 100)) < 1e-5


def test_long_prototype_matches_oracle():
    # K=64 x M=17 (1088 taps): carried context longer than one
    # 1024-sample row.
    from comms_tpu.models import channelizer as model

    rng = np.random.default_rng(7)
    cfg = model.ChannelizerConfig(taps_per_branch=17, block=_N)
    blk = model.make_block_fn(cfg)
    x = _noise(rng, 2 * _N)
    s = model.init_state(cfg)
    outs = []
    for b in range(2):
        seg = x[b * _N:(b + 1) * _N]
        y, s = blk(s, jnp.asarray(np.stack([seg.real, seg.imag], -1)))
        outs.append(np.asarray(y[..., 0]) + 1j * np.asarray(y[..., 1]))
    got = np.concatenate(outs)
    assert _rel(got, chan.channelize_oracle(x, cfg.prototype, 64)) < 1e-5


def test_planar_channelize_matches_complex():
    rng = np.random.default_rng(21)
    x = _noise(rng, _N)
    h = chan.design_prototype(2, 8)
    Hb = chan.branch_taps(h.astype(np.float32), 2)
    T = len(h)
    z = jnp.zeros(T - 1, jnp.float32)
    yr, yi, nre, nim = chan.channelize_block_planar(
        jnp.asarray(x.real.copy()), jnp.asarray(x.imag.copy()), Hb, z, z)
    y, ctx = chan.channelize_block(jnp.asarray(x), Hb,
                                   chan.channelizer_init_ctx(T))
    got = np.asarray(yr) + 1j * np.asarray(yi)
    assert _rel(got, np.asarray(y)) < 1e-6
    np.testing.assert_array_equal(np.asarray(nre), np.asarray(ctx).real)
    np.testing.assert_array_equal(np.asarray(nim), np.asarray(ctx).imag)


def test_planar_channelize_streaming_short_prototype():
    # a short non-designed prototype (Hann, 32 taps) streamed through
    # the carried T-1 planes
    rng = np.random.default_rng(23)
    K = 4
    h = np.hanning(32)
    Hb = chan.branch_taps(h.astype(np.float32), K)
    x = _noise(rng, 2 * _N)
    cre = cim = jnp.zeros(len(h) - 1, jnp.float32)
    outs = []
    for b in range(2):
        seg = x[b * _N:(b + 1) * _N]
        yr, yi, cre, cim = chan.channelize_block_planar(
            jnp.asarray(seg.real.copy()), jnp.asarray(seg.imag.copy()),
            Hb, cre, cim)
        outs.append(np.asarray(yr) + 1j * np.asarray(yi))
    got = np.concatenate(outs)
    assert _rel(got, chan.channelize_oracle(x, h, K)) < 1e-5
