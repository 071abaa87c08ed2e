"""Multi-device correctness on the 8-device virtual CPU mesh: sharded
outputs must equal the single-device streaming ops exactly — the
multi-node test coverage the reference lacks (SURVEY.md section 4)."""

import pytest
import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from comms_tpu.ops import channelizer as chan
from comms_tpu.ops import demodulation, fir
from comms_tpu.parallel import sharding as sh
from comms_tpu.parallel import wideband


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8


def test_sharded_fir_halo_matches_single_device():
    rng = np.random.default_rng(0)
    T = 33
    t = (rng.normal(size=T) + 1j * rng.normal(size=T)).astype(np.complex64)
    B = fir.banded_tap_matrix(t)
    x = (rng.normal(size=2048) + 1j * rng.normal(size=2048)).astype(
        np.complex64)
    ctx = np.asarray(rng.normal(size=T - 1) + 1j * rng.normal(size=T - 1),
                     dtype=np.complex64)

    y_ref, ctx_ref = fir.fir_block(jnp.asarray(x), B, jnp.asarray(ctx))

    mesh = sh.time_mesh(8)

    def local(xl, ctxg):
        halo = sh.halo_exchange(xl, ctxg, T - 1)
        y, _ = fir.fir_block(xl, B, halo)
        new_ctx = sh.collect_ctx(xl, T - 1)
        return y, new_ctx

    fn = jax.jit(shard_map(local, mesh=mesh,
                           in_specs=(P("time"), P()),
                           out_specs=(P("time"), P())))
    y, new_ctx = fn(jnp.asarray(x), jnp.asarray(ctx))
    assert np.allclose(np.asarray(y), np.asarray(y_ref), atol=1e-5)
    assert np.allclose(np.asarray(new_ctx), np.asarray(ctx_ref), atol=0)


def test_sharded_estimator_psum():
    rng = np.random.default_rng(1)
    w = 0.123
    x = np.exp(1j * w * np.arange(4096)).astype(np.complex64)
    mesh = sh.time_mesh(8)

    def local(xl):
        lag = jnp.sum(xl[1:] * jnp.conj(xl[:-1]))
        yprev = sh.halo_exchange(xl, jnp.zeros((1,), xl.dtype), 1)
        idx = lax.axis_index("time")
        edge = jnp.where(idx == 0, 0j, xl[0] * jnp.conj(yprev[0]))
        s = sh.psum_estimate(lag + edge)
        return jnp.arctan2(jnp.imag(s), jnp.real(s))[None]

    fn = jax.jit(shard_map(local, mesh=mesh, in_specs=(P("time"),),
                           out_specs=P("time")))
    est = np.asarray(fn(jnp.asarray(x)))[0]
    ref = float(demodulation.frequency_offset_estimate(jnp.asarray(x)))
    assert abs(est - ref) < 1e-5


def test_corner_turn_layout():
    # 8 shards, 16 channels, 4 local frames: after the turn each shard
    # holds all 32 global frames for its 2 channels.
    mesh = sh.time_mesh(8)
    frames_local, K = 4, 16
    x = np.arange(8 * frames_local * K, dtype=np.float32).reshape(
        8 * frames_local, K)

    def local(xl):
        return sh.corner_turn(xl)

    fn = jax.jit(shard_map(local, mesh=mesh, in_specs=(P("time", None),),
                           out_specs=P(None, "time")))
    y = np.asarray(fn(jnp.asarray(x)))
    # Global semantics: y[f, k] == x[f, k] (pure re-sharding).
    assert y.shape == x.shape
    assert np.array_equal(y, x)


def test_wideband_chain_matches_local_oracle():
    rng = np.random.default_rng(2)
    from comms_tpu.models.fm_receiver import FM_LPF_TAPS
    n = 8 * 1000
    ph = np.cumsum(0.2 + 0.05 * np.sin(2 * np.pi * np.arange(n) / 400))
    z = (np.exp(1j * ph) * 0.9).astype(np.complex64)
    pairs = np.stack([z.real, z.imag], -1).astype(np.float32)

    cfg = wideband.WidebandConfig(FM_LPF_TAPS, block=n, dec1=5, dec2=5)
    mesh = sh.time_mesh(8)
    step = wideband.make_sharded_step(cfg, mesh)
    state = wideband.init_state(cfg)
    (audio, freq), state2 = step(state, jnp.asarray(pairs))

    # Single-device oracle with the same ops.
    T = cfg.num_taps
    y_ref, _ = fir.fir_block(jnp.asarray(z), cfg.B_iq,
                             fir.init_ctx(T, jnp.complex64))
    freq_ref = float(demodulation.frequency_offset_estimate(y_ref))
    y_ref = np.asarray(y_ref)[::5]
    d_ref, _ = demodulation.fm_demod_block(
        jnp.asarray(y_ref), demodulation.fm_demod_init())
    a_ref, _ = fir.fir_block(d_ref.astype(jnp.float32), cfg.B_audio,
                             jnp.zeros(T - 1, jnp.float32))
    audio_ref = np.asarray(a_ref)[::5]

    assert np.allclose(np.asarray(audio), audio_ref, atol=1e-4)
    assert abs(float(freq) - freq_ref) < 1e-4

    # Streaming: second block continues the stream.
    (audio2, _), _ = step(state2, jnp.asarray(pairs))
    assert np.isfinite(np.asarray(audio2)).all()


def test_sharded_channelizer_time_sharded():
    # Time-sharded channelizer: shard frames, halo via ppermute; same
    # output as single-device.
    rng = np.random.default_rng(3)
    K, M = 16, 4
    h = chan.design_prototype(K, M).astype(np.float64)
    Hb = chan.branch_taps(h, K)
    N = 8 * 32 * K
    x = (rng.normal(size=N) + 1j * rng.normal(size=N)).astype(np.complex64)

    ctx0 = chan.channelizer_init_ctx(len(h), dtype=jnp.complex64)
    y_ref, _ = chan.channelize_block(jnp.asarray(x), Hb, ctx0)

    mesh = sh.time_mesh(8)
    T = len(h)

    def local(xl, ctxg):
        halo = sh.halo_exchange(xl, ctxg, T - 1)
        y, _ = chan.channelize_block(xl, Hb, halo)
        return y

    fn = jax.jit(shard_map(local, mesh=mesh,
                           in_specs=(P("time"), P()),
                           out_specs=P("time", None)))
    y = fn(jnp.asarray(x), ctx0)
    assert np.allclose(np.asarray(y), np.asarray(y_ref), atol=1e-4)


def test_distributed_fft_matches_numpy():
    # Natural-order output directly from the second all_to_all.
    from comms_tpu.parallel import dfft as dfft_mod
    rng = np.random.default_rng(4)
    N = 1024
    x = (rng.normal(size=N) + 1j * rng.normal(size=N)).astype(np.complex64)
    mesh = sh.time_mesh(8)
    dfft = dfft_mod.make_dfft(N, mesh)
    got = np.asarray(dfft(jnp.asarray(x)))
    expected = np.fft.fft(x)
    scale = np.max(np.abs(expected))
    assert np.max(np.abs(got - expected)) / scale < 1e-5


def test_distributed_fft_large_2pow20():
    # Integer-mod twiddles: precision must NOT degrade with N
    # (round-1 version needed 2e-4 already at 2^16).
    from comms_tpu.parallel import dfft as dfft_mod
    rng = np.random.default_rng(5)
    N = 1 << 20
    x = (rng.normal(size=N) + 1j * rng.normal(size=N)).astype(np.complex64)
    mesh = sh.time_mesh(8)
    dfft = dfft_mod.make_dfft(N, mesh)
    got = np.asarray(dfft(jnp.asarray(x)))
    expected = np.fft.fft(x)
    scale = np.max(np.abs(expected))
    assert np.max(np.abs(got - expected)) / scale < 1e-5


def test_distributed_fft_batched():
    from comms_tpu.parallel import dfft as dfft_mod
    rng = np.random.default_rng(6)
    N = 1 << 12
    x = (rng.normal(size=(4, N)) + 1j * rng.normal(size=(4, N))
         ).astype(np.complex64)
    mesh = sh.time_mesh(8)
    dfft = dfft_mod.make_dfft(N, mesh)
    got = np.asarray(dfft(jnp.asarray(x)))
    expected = np.fft.fft(x, axis=-1)
    scale = np.max(np.abs(expected))
    assert np.max(np.abs(got - expected)) / scale < 1e-5


def test_host_feed_single_process():
    from comms_tpu.parallel import multihost
    mesh = sh.time_mesh(8)
    local = np.arange(64, dtype=np.float32).reshape(64)
    arr = multihost.host_feed(local, mesh)
    assert arr.shape == (64,)
    assert np.array_equal(np.asarray(arr), local)


def test_distributed_fft_nonpow2():
    # N = 320 = 64*5 on 8 shards: non-power-of-two, exercised with the
    # auto-picked factorization (r=1, R=8, C=40).
    from comms_tpu.parallel import dfft as dfft_mod
    rng = np.random.default_rng(7)
    N = 320
    x = (rng.normal(size=N) + 1j * rng.normal(size=N)).astype(np.complex64)
    mesh = sh.time_mesh(8)
    dfft = dfft_mod.make_dfft(N, mesh)
    got = np.asarray(dfft(jnp.asarray(x)))
    expected = np.fft.fft(x)
    scale = np.max(np.abs(expected))
    assert np.max(np.abs(got - expected)) / scale < 1e-5


def test_pick_local_radix_bounds_local_fft():
    # r rebalances R vs C: cap the per-shard FFT length for huge N.
    from comms_tpu.parallel import dfft as dfft_mod
    r = dfft_mod.pick_local_radix(1 << 20, 8, max_local_fft=1 << 14)
    assert r == 8 and (1 << 20) // (r * 8) == 1 << 14
    rng = np.random.default_rng(10)
    N = 1 << 16
    x = (rng.normal(size=N) + 1j * rng.normal(size=N)).astype(np.complex64)
    mesh = sh.time_mesh(8)
    dfft = dfft_mod.make_dfft(
        N, mesh,
        local_radix=dfft_mod.pick_local_radix(N, 8, max_local_fft=1 << 10))
    assert dfft.C <= 1 << 10
    got = np.asarray(dfft(jnp.asarray(x)))
    expected = np.fft.fft(x)
    scale = np.max(np.abs(expected))
    assert np.max(np.abs(got - expected)) / scale < 1e-5


def test_distributed_fft_explicit_local_radix_batched():
    # r > 1 on a well-factorable N, batched input.
    from comms_tpu.parallel import dfft as dfft_mod
    rng = np.random.default_rng(8)
    N = 1 << 14
    x = (rng.normal(size=(3, N)) + 1j * rng.normal(size=(3, N))
         ).astype(np.complex64)
    mesh = sh.time_mesh(8)
    dfft = dfft_mod.make_dfft(N, mesh, local_radix=4)
    assert dfft.R == 32
    got = np.asarray(dfft(jnp.asarray(x)))
    expected = np.fft.fft(x, axis=-1)
    scale = np.max(np.abs(expected))
    assert np.max(np.abs(got - expected)) / scale < 1e-5


def test_distributed_fft_interleaved_layout_r_gt_1():
    # natural_order=False documents the layout: shard s's local chunk
    # [pl*C + m] holds X[(s*r+pl) + R*m].
    from comms_tpu.parallel import dfft as dfft_mod
    rng = np.random.default_rng(9)
    N = 1 << 12
    x = (rng.normal(size=N) + 1j * rng.normal(size=N)).astype(np.complex64)
    mesh = sh.time_mesh(8)
    dfft = dfft_mod.make_dfft(N, mesh, natural_order=False, local_radix=2)
    R, C, r = dfft.R, dfft.C, dfft.r
    got = np.asarray(dfft(jnp.asarray(x)))     # [N] global gather
    expected = np.fft.fft(x)
    # reconstruct: global flat index s*(r*C) + pl*C + m  <-  k = p + R*m
    recon = np.empty(N, np.complex64)
    for s in range(8):
        for pl in range(r):
            p = s * r + pl
            recon[p + R * np.arange(C)] = got[s * r * C + pl * C
                                              + np.arange(C)]
    scale = np.max(np.abs(expected))
    assert np.max(np.abs(recon - expected)) / scale < 1e-5


def test_pick_local_radix_errors():
    # n | N but n^2 does not divide N: natural order is impossible
    # with two exchanges (see dfft.py docstring); the interleaved
    # spectrum is offered instead.
    import pytest
    from comms_tpu.parallel import dfft as dfft_mod
    with pytest.raises(ValueError, match="natural_order=False"):
        dfft_mod.pick_local_radix(8 * 3, 8)  # 24 = 8*3, no r works


def test_sharded_psd_matches_welch_oracle():
    # The dfft's consumer: wideband PSD over the mesh must equal the
    # single-device Welch estimate (nonoverlapping segments).
    from comms_tpu.ops import spectrum
    from comms_tpu.parallel import wideband

    rng = np.random.default_rng(11)
    F, B = 1 << 12, 4
    x = (rng.normal(size=B * F) + 1j * rng.normal(size=B * F)
         ).astype(np.complex64)
    mesh = sh.time_mesh(8)
    psd_fn = wideband.make_sharded_psd(F, mesh)
    pairs = np.stack([x.real, x.imag], -1).reshape(B, F, 2)
    got = np.asarray(psd_fn(jnp.asarray(pairs)))

    _, ref = spectrum.welch_psd(jnp.asarray(x), nperseg=F, noverlap=0)
    ref = np.asarray(ref)
    scale = np.max(ref)
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) / scale < 1e-5


def test_sharded_psd_large_2pow20_local_radix():
    # 2^20-bin spectrum across the mesh with the local radix bounding
    # the per-shard FFT to 2^14.
    from comms_tpu.parallel import dfft as dfft_mod
    from comms_tpu.parallel import wideband

    rng = np.random.default_rng(12)
    F = 1 << 20
    x = (rng.normal(size=F) + 1j * rng.normal(size=F)).astype(np.complex64)
    mesh = sh.time_mesh(8)
    r = dfft_mod.pick_local_radix(F, 8, max_local_fft=1 << 14)
    psd_fn = wideband.make_sharded_psd(F, mesh, local_radix=r)
    pairs = np.stack([x.real, x.imag], -1).reshape(1, F, 2)
    got = np.asarray(psd_fn(jnp.asarray(pairs)))

    from comms_tpu.ops import spectrum
    _, ref = spectrum.welch_psd(jnp.asarray(x), nperseg=F, noverlap=0)
    ref = np.asarray(ref)
    assert np.max(np.abs(got - ref)) / np.max(ref) < 1e-5


def test_sharded_planar_fir_matches_single_device():
    """The FIR op composes with time-block sharding: each shard filters
    its chunk with its T-1 context delivered by one ring ppermute of
    the left neighbor's tail (overlap-save).  Sharded == single device
    to f32 rounding."""
    rng = np.random.default_rng(42)
    n_dev = len(jax.devices())
    per = 16 * 128
    N = n_dev * per
    taps = (rng.normal(size=63) + 1j * rng.normal(size=63)
            ).astype(np.complex64)
    x = (rng.normal(size=N) + 1j * rng.normal(size=N)).astype(np.complex64)
    y1, _ = fir.fir_block(jnp.asarray(x), taps, fir.init_ctx(63))

    def local(xl):
        halo = sh.halo_exchange(xl, jnp.zeros(62, xl.dtype), 62)
        y, _ = fir.fir_block(xl, taps, halo)
        return y

    fn = jax.jit(shard_map(local, mesh=sh.time_mesh(n_dev),
                           in_specs=(P("time"),), out_specs=P("time")))
    y8 = np.asarray(fn(jnp.asarray(x)))
    ref = np.asarray(y1)
    assert np.max(np.abs(y8 - ref)) < 1e-6 * np.max(np.abs(ref))


def test_sharded_decim_matches_single_device():
    """Same composition for the polyphase decimator: the carried
    context is its M*D-1 input tail."""
    rng = np.random.default_rng(43)
    n_dev = len(jax.devices())
    D = 5
    per = 8 * D * 128
    N = n_dev * per
    taps = rng.normal(size=63).astype(np.float32)
    C = fir.decimating_branch_taps(taps, D)
    L = C.size - 1
    x = (rng.normal(size=N) + 1j * rng.normal(size=N)).astype(np.complex64)
    y1, _ = fir.fir_decimate_poly(jnp.asarray(x), C,
                                  jnp.zeros(L, jnp.complex64))

    def local(xl):
        halo = sh.halo_exchange(xl, jnp.zeros(L, xl.dtype), L)
        y, _ = fir.fir_decimate_poly(xl, C, halo)
        return y

    fn = jax.jit(shard_map(local, mesh=sh.time_mesh(n_dev),
                           in_specs=(P("time"),), out_specs=P("time")))
    y8 = np.asarray(fn(jnp.asarray(x)))
    ref = np.asarray(y1)
    assert np.max(np.abs(y8 - ref)) < 1e-6 * np.max(np.abs(ref))


def test_halo_exchange_delivers_left_neighbor_tail():
    """halo_exchange gives shard i the last ``halo`` samples of shard
    i-1 and shard 0 the carried context — real and complex streams."""
    rng = np.random.default_rng(5)
    mesh = sh.time_mesh(8)
    halo, per = 12, 64
    for dtype in (np.float32, np.complex64):
        x = rng.normal(size=8 * per).astype(dtype)
        ctx = rng.normal(size=halo).astype(dtype)
        if dtype is np.complex64:
            x = x + 1j * rng.normal(size=8 * per).astype(np.float32)
            ctx = ctx + 1j * rng.normal(size=halo).astype(np.float32)

        def via_ppermute(xl, c):
            return sh.halo_exchange(xl, c, halo)

        got = jax.jit(shard_map(via_ppermute, mesh=mesh,
                                in_specs=(P("time"), P()),
                                out_specs=P("time")))(
            jnp.asarray(x), jnp.asarray(ctx))
        want = np.concatenate(
            [ctx] + [x[(i + 1) * per - halo:(i + 1) * per]
                     for i in range(7)])
        np.testing.assert_array_equal(np.asarray(got), want)


def test_wideband_chain_streamed_matches_one_device():
    """make_sharded_step on 8 shards equals the same chain on one
    device, streamed over 2 blocks (carried state included)."""
    from comms_tpu.models.fm_receiver import FM_LPF_TAPS

    rng = np.random.default_rng(6)
    n = 8 * 1000
    z = np.exp(1j * np.cumsum(0.3 + 0.05 * rng.normal(size=n)))
    pairs = np.stack([z.real, z.imag], -1).astype(np.float32)

    cfg = wideband.WidebandConfig(FM_LPF_TAPS, block=n, dec1=5, dec2=5)
    step8 = wideband.make_sharded_step(cfg, sh.time_mesh(8))
    step1 = wideband.make_sharded_step(cfg, sh.time_mesh(1))
    st_a = wideband.init_state(cfg)
    st_b = wideband.init_state(cfg)
    for _ in range(2):
        (audio_a, freq_a), st_a = step8(st_a, jnp.asarray(pairs))
        (audio_b, freq_b), st_b = step1(st_b, jnp.asarray(pairs))
        np.testing.assert_allclose(np.asarray(audio_a), np.asarray(audio_b),
                                   rtol=0, atol=1e-5)
        assert abs(float(freq_a) - float(freq_b)) < 1e-6
    for a, b in zip(st_a, st_b):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=0, atol=1e-5)


def test_psd_planar_fallback_accepts_3d_serving_shape():
    # The planar PSD accepts the 3-D pre-factorized serving shape.
    rng = np.random.default_rng(7)
    F = 1 << 16
    n1 = n2 = 256
    mesh = sh.time_mesh(1)
    psd = wideband.make_sharded_psd_planar(F, mesh)
    re = rng.normal(size=(2, F)).astype(np.float32)
    im = rng.normal(size=(2, F)).astype(np.float32)
    a2 = np.asarray(psd(jnp.asarray(re), jnp.asarray(im)))
    a3 = np.asarray(psd(jnp.asarray(re.reshape(2, n1, n2)),
                        jnp.asarray(im.reshape(2, n1, n2))))
    np.testing.assert_allclose(a3, a2, atol=1e-5 * float(a2.max()))


def test_sharded_qpsk_rx_zero_ber_and_matches_single_chip():
    """Time-sharded QPSK receiver on the 8-device mesh: psum'd panel
    estimates equal the single-chip core's within edge terms, the
    symbol grid is gap-free across shards, and an impaired loopback
    decodes with zero bit errors."""
    from comms_tpu.models import qpsk_rx, qpsk_tx
    from comms_tpu.ops import random as crandom
    from comms_tpu.parallel import qpsk_rx_sharded

    nbits = 16384
    tcfg = qpsk_tx.QpskTxConfig(bits_per_block=nbits, dphase=0.0)
    blk = qpsk_tx.make_block_fn(tcfg)
    iq, _ = blk(qpsk_tx.init_state(tcfg, 2))
    z = np.asarray(iq).astype(np.float32) / tcfg.scale
    x = (z[:, 0] + 1j * z[:, 1]).astype(np.complex128)
    key = crandom.source_init(2)
    bits, _ = crandom.random_bits_block(key, nbits)
    bits = np.asarray(bits)
    nsmp = np.arange(len(x))
    xc = (x * np.exp(1j * (0.007 * nsmp + 0.5))).astype(np.complex64)

    cfg = qpsk_rx.QpskRxConfig()
    mesh = sh.time_mesh(8)
    step = qpsk_rx_sharded.make_sharded_rx_step(cfg, mesh)
    sym_sh, diag_sh = step(jnp.asarray(xc.real), jnp.asarray(xc.imag))

    rx1 = qpsk_rx.make_rx_fn_planar(cfg)
    sym_1, diag_1 = rx1(jnp.asarray(xc.real), jnp.asarray(xc.imag))

    # estimates agree within panel-edge terms (8 shard boundaries)
    assert abs(float(diag_sh["freq"]) - float(diag_1["freq"])) < 2e-3
    assert abs(float(diag_sh["timing"]) - float(diag_1["timing"])) < 2e-2
    assert int(diag_sh["sym_phase"]) == int(diag_1["sym_phase"])

    # zero BER on the sharded symbol stream
    best = qpsk_rx.resolve_ambiguity(np.asarray(sym_sh), bits,
                                     search=1500)
    assert best[1] == 0, best

    # gap-free grid: sharded and single-chip symbols agree closely
    # away from block edges (estimates differ by edge terms only)
    a = np.asarray(sym_sh)[0] + 1j * np.asarray(sym_sh)[1]
    b = np.asarray(sym_1)[0] + 1j * np.asarray(sym_1)[1]
    scale = np.abs(b).max()
    assert np.max(np.abs(a[16:-16] - b[16:-16])) < 0.05 * scale


# ---------------------------------------------------- 2-D (time x chan)

@pytest.mark.parametrize("nt,nc", [(2, 4), (4, 2), (1, 8), (8, 1)])
def test_band_monitor_2d_mesh_matches_single_device(nt, nc):
    """The (time x chan) mesh (VERDICT r4 #4): channelize over the
    flattened ring, corner-turn within rows, per-channel receivers
    with time-axis halos — audio and carried state must equal the
    single-device band monitor for EVERY mesh factorization."""
    from comms_tpu.models import fm_band_monitor as model
    from comms_tpu.parallel import wideband2d

    N = 16384
    cfg = model.BandMonitorConfig(num_channels=16, taps_per_branch=8,
                                  block=N, audio_dec=4)
    rng = np.random.default_rng(11)
    ph = np.cumsum(0.3 + 0.2 * rng.normal(size=N))
    z = (np.exp(1j * ph) + 0.1 * rng.normal(size=N)).astype(np.complex64)
    pairs = np.stack([z.real, z.imag], -1).astype(np.float32)

    ref_fn = model.make_block_fn(cfg)
    ref_state = model.init_state(cfg)
    audio_ref, state_ref = ref_fn(ref_state, jnp.asarray(pairs))
    audio_ref2, _ = ref_fn(state_ref, jnp.asarray(pairs))

    mesh = wideband2d.mesh_2d(nt, nc)
    step = wideband2d.make_sharded_band_monitor_2d(cfg, mesh)
    state = model.init_state(cfg)
    (audio, power), state2 = step(state, jnp.asarray(pairs))

    assert np.allclose(np.asarray(audio), np.asarray(audio_ref),
                       atol=1e-5)
    # carried state components match the single-device ones
    for a, b in zip(state2, state_ref):
        assert np.allclose(np.asarray(a), np.asarray(b), atol=1e-5)
    # streaming: the second block continues identically
    (audio2, _), _ = step(state2, jnp.asarray(pairs))
    assert np.allclose(np.asarray(audio2), np.asarray(audio_ref2),
                       atol=1e-5)
    # the power map is a per-channel mean |Y|^2 (replicated over time)
    y_ref = chan.channelize_oracle(z, cfg.prototype, cfg.num_channels)
    p_ref = np.mean(np.abs(y_ref) ** 2, axis=0)
    assert np.allclose(np.asarray(power), p_ref, rtol=0.02)


def test_band_monitor_2d_validations():
    from comms_tpu.models import fm_band_monitor as model
    from comms_tpu.parallel import wideband2d

    cfg = model.BandMonitorConfig(num_channels=16, taps_per_branch=8,
                                  block=16384, audio_dec=4)
    mesh = wideband2d.mesh_2d(2, 4)
    # K=6 not divisible by nc=4
    bad = model.BandMonitorConfig(num_channels=6, taps_per_branch=8,
                                  block=16 * 6 * 25, audio_dec=4)
    with pytest.raises(ValueError, match="divide over chan"):
        wideband2d.make_sharded_band_monitor_2d(bad, mesh)
    # per-device slice smaller than the T-1 channelizer halo
    bad2 = model.BandMonitorConfig(num_channels=16, taps_per_branch=8,
                                   block=512, audio_dec=4)
    with pytest.raises(ValueError, match="channelizer halo"):
        wideband2d.make_sharded_band_monitor_2d(bad2, mesh)
    del cfg
