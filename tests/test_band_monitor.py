"""FM band monitor (channelize -> per-channel FM demod -> audio FIR)
vs a numpy float64 oracle built from the channelizer's direct form,
plus semantic and state-layout checks."""

import numpy as np
import jax.numpy as jnp
import pytest

from comms_tpu.models import fm_band_monitor as model
from comms_tpu.ops import channelizer as chan


def _stations(K, n, seed):
    """A wideband capture with one FM station on every channel centre
    (small deviation: each channel's phase steps stay far from the
    atan2 branch cut, so f32 and f64 demods agree)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    x = np.zeros(n, np.complex128)
    for ch in range(K):
        fa = rng.uniform(0.005, 0.05)
        tone = np.sin(2 * np.pi * fa / K * t + rng.uniform(0, 6.28))
        phase = 2 * np.pi * (0.1 / K) * np.cumsum(tone)
        x += np.exp(1j * (2 * np.pi * ch * t / K + phase))
    return (x / np.abs(x).max()).astype(np.complex64)


def _oracle(cfg, x):
    """[K, audio] from zero state, float64."""
    y = chan.channelize_oracle(x, cfg.prototype, cfg.num_channels)
    taps = np.asarray(cfg.audio_taps, np.float64)
    out = []
    for k in range(cfg.num_channels):
        yk = y[:, k]
        d = np.angle(yk * np.conj(np.concatenate([[0], yk[:-1]])))
        a = np.convolve(d, taps)[:len(d)][::cfg.audio_dec]
        out.append(a)
    return np.stack(out)


def _skip(cfg):
    # audio samples whose FIR window reaches the stream's first demod
    # value (arg of a product with the zero initial state: its sign is
    # a signed-zero accident, not signal)
    return -(-cfg.audio_taps.shape[0] // cfg.audio_dec) + 1


def _run(cfg, x, nblocks, planar=False):
    blk = (model.make_planar_block_fn(cfg) if planar
           else model.make_block_fn(cfg))
    st = model.init_state(cfg)
    outs = []
    for b in range(nblocks):
        seg = x[b * cfg.block:(b + 1) * cfg.block]
        if planar:
            a, st = blk(st, jnp.asarray(seg.real.copy()),
                        jnp.asarray(seg.imag.copy()))
        else:
            a, st = blk(st, jnp.asarray(np.stack([seg.real, seg.imag], -1)))
        outs.append(np.asarray(a))
    return np.concatenate(outs, axis=1)


@pytest.mark.parametrize("k,m,dec", [(64, 8, 4), (16, 8, 4)])
def test_band_monitor_parity_streaming(k, m, dec):
    cfg = model.BandMonitorConfig(num_channels=k, taps_per_branch=m,
                                  block=16384, audio_dec=dec)
    x = _stations(k, 3 * cfg.block, 11 + k)
    got = _run(cfg, x, 3)
    ref = _oracle(cfg, x)
    assert got.shape == ref.shape
    s = _skip(cfg)
    err = np.max(np.abs(got[:, s:] - ref[:, s:]))
    assert err < 1e-4 * np.abs(ref).max(), err


def test_band_monitor_validation():
    with pytest.raises(ValueError, match="divide"):
        model.BandMonitorConfig(num_channels=16, block=16 * 4 * 3 + 16,
                                audio_dec=4)


def test_planar_path_matches_pairs_path():
    # the serving-ingest planar entry and the pairs entry, streamed
    cfg = model.BandMonitorConfig(block=16384)
    x = _stations(cfg.num_channels, 2 * cfg.block, 7)
    a = _run(cfg, x, 2)
    b = _run(cfg, x, 2, planar=True)
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-6 * np.abs(a).max())


def test_exact_demod_option_matches_oracle():
    # fast_demod=False: the exact atan2 gives the same audio
    cfg = model.BandMonitorConfig(block=16384)
    x = _stations(cfg.num_channels, cfg.block, 3)
    blk = model.make_block_fn(cfg, fast_demod=False)
    a, _ = blk(model.init_state(cfg),
               jnp.asarray(np.stack([x.real, x.imag], -1)))
    ref = _oracle(cfg, x)
    s = _skip(cfg)
    assert np.max(np.abs(np.asarray(a)[:, s:] - ref[:, s:])) \
        < 1e-4 * np.abs(ref).max()


def test_band_monitor_recovers_per_channel_tones():
    """Multi-channel SEMANTIC check: a wideband capture carrying
    three FM stations (distinct audio tones on distinct channel
    centers) demodulates so each station's tone appears in ITS
    channel's audio and nowhere dominant elsewhere."""
    K = 16
    n = 1 << 18
    cfg = model.BandMonitorConfig(num_channels=K, block=n, audio_dec=4)
    t = np.arange(n)
    stations = {3: 0.020, 7: 0.033, 12: 0.047}  # ch -> audio freq
    x = np.zeros(n, np.complex128)
    for ch, fa in stations.items():
        tone = np.sin(2 * np.pi * fa / K * t)     # audio at wideband rate
        phase = 2 * np.pi * (0.25 / K) * np.cumsum(tone)
        x += np.exp(1j * (2 * np.pi * ch * t / K + phase))
    x = (x / np.abs(x).max()).astype(np.complex64)

    blk = model.make_planar_block_fn(cfg, fast_demod=True)
    audio, _ = blk(model.init_state(cfg),
                   jnp.asarray(x.real), jnp.asarray(x.imag))
    audio = np.asarray(audio, np.float64)[:, 64:]   # skip transient

    for ch, fa in stations.items():
        a = audio[ch] - audio[ch].mean()
        X = np.abs(np.fft.rfft(a * np.hanning(len(a))))
        # audio rate = wideband / (K * audio_dec); tone at fa/K of
        # the wideband rate -> fa * audio_dec cycles/sample at audio
        f = np.fft.rfftfreq(len(a), 1.0)
        target = fa * cfg.audio_dec
        peak = X[np.abs(f - target).argmin()]
        ratio_t = peak / np.median(X)
        assert ratio_t > 10, (ch, ratio_t)
        # a quiet channel demods to broadband noise: the tone must
        # not stand out there the way it does in its own channel
        q = audio[(ch + 2) % K] - audio[(ch + 2) % K].mean()
        Xq = np.abs(np.fft.rfft(q * np.hanning(len(q))))
        ratio_q = Xq[np.abs(f - target).argmin()] / np.median(Xq)
        assert ratio_q < ratio_t / 3, (ch, ratio_q, ratio_t)


def test_ragged_audio_taps_streaming():
    # audio taps % dec != 0: the carried audio context is M*D-1
    # (= audio_C.size-1), not taps-1
    cfg = model.BandMonitorConfig(num_channels=2, block=2 * 16384,
                                  audio_dec=4, audio_taps=np.hanning(30))
    assert model.init_state(cfg)[2].shape == (2, cfg.audio_C.size - 1)
    x = _stations(2, 2 * cfg.block, 23)
    got = _run(cfg, x, 2)
    ref = _oracle(cfg, x)
    s = _skip(cfg)
    assert np.max(np.abs(got[:, s:] - ref[:, s:])) < 1e-4 * np.abs(ref).max()


def test_time_sharded_band_monitor_matches_sequential():
    # the 2-D mesh path (time x chan) on a 4 x 2 virtual mesh equals
    # the single-device stream, block after block
    from comms_tpu.parallel import wideband2d

    cfg = model.BandMonitorConfig(num_channels=16, block=8 * 2048,
                                  audio_dec=4)
    x = _stations(16, 2 * cfg.block, 31)
    step = wideband2d.make_sharded_band_monitor_2d(
        cfg, wideband2d.mesh_2d(4, 2))
    st = model.init_state(cfg)
    outs = []
    for b in range(2):
        seg = x[b * cfg.block:(b + 1) * cfg.block]
        (a, _), st = step(st, jnp.asarray(np.stack([seg.real, seg.imag], -1)))
        outs.append(np.asarray(a))
    got = np.concatenate(outs, axis=1)
    ref = _run(cfg, x, 2)
    assert np.max(np.abs(got - ref)) < 1e-5 * np.abs(ref).max()
