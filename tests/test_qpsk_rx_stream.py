"""Streaming QPSK receiver: zero BER over a long continuous stream
with a mid-stream carrier-frequency step, driven through StreamRunner.
"""

import numpy as np
import jax.numpy as jnp

from comms_tpu.models import qpsk_rx_stream, qpsk_tx
from comms_tpu.ops import random as crandom
from comms_tpu.models.qpsk_rx import decide_bits
from comms_tpu.ops import taps
from comms_tpu.runtime.stream import StreamRunner

SPS, T, BETA = 4, 32, 0.25


def _tx(bits: np.ndarray) -> np.ndarray:
    """qpsk_tx waveform: consecutive bit pairs -> RRC-shaped samples."""
    rrc = np.asarray(taps.rrc_taps(T, float(SPS), BETA))
    rrc = rrc / np.sqrt(np.sum(np.abs(rrc) ** 2))
    pairs = bits.reshape(-1, 2)
    sym = ((2.0 * pairs[:, 0] - 1) + 1j * (2.0 * pairs[:, 1] - 1)
           ).astype(np.complex64)
    up = np.zeros(len(sym) * SPS, np.complex64)
    up[::SPS] = sym
    return np.convolve(up, rrc.astype(np.complex64))[: len(up)]


def _frac_delay(x: np.ndarray, d: float) -> np.ndarray:
    n = len(x)
    X = np.fft.fft(np.concatenate([x, np.zeros(256, x.dtype)]))
    k = np.fft.fftfreq(len(X))
    return np.fft.ifft(X * np.exp(-2j * np.pi * k * d))[:n].astype(
        np.complex64)


def _best_align(sym: np.ndarray, bits: np.ndarray, start_sym: int,
                max_lag: int = 24):
    """Best (errors, compared, rot, lag) over rotations x symbol lags,
    compared over the FULL overlap (not a prefix)."""
    best = None
    for rot in range(4):
        cand = decide_bits(sym * np.exp(1j * np.pi / 2 * rot))
        for lag in range(-max_lag, max_lag + 1):
            ref_start = 2 * (start_sym + lag)
            if ref_start < 0:
                continue
            ref = bits[ref_start:]
            m = min(len(cand), len(ref))
            errs = int(np.sum(cand[:m] != ref[:m]))
            if best is None or errs < best[0]:
                best = (errs, m, rot, lag)
    return best


def test_streaming_rx_zero_ber_with_freq_step():
    cfg = qpsk_rx_stream.QpskRxStreamConfig(block=8192)
    n_blocks = 34
    M = cfg.syms_per_block
    n_sym = n_blocks * M + 64
    rng = np.random.default_rng(11)
    bits = rng.integers(0, 2, size=2 * n_sym).astype(np.uint8)
    s = _tx(bits)

    # channel: fractional delay + carrier with a frequency STEP at the
    # stream midpoint + phase offset
    w1, w2, dstep = 0.01, 0.012, 17 * cfg.block
    n = np.arange(len(s))
    dph = np.where(n < dstep, w1, w2)
    phase = 0.9 + np.cumsum(dph)
    r = _frac_delay(s, 1.7) * np.exp(1j * phase).astype(np.complex64)

    blocks = [
        np.stack([r[b * cfg.block:(b + 1) * cfg.block].real,
                  r[b * cfg.block:(b + 1) * cfg.block].imag],
                 axis=-1).astype(np.float32)
        for b in range(n_blocks)
    ]

    step = qpsk_rx_stream.make_stream_fn(cfg)
    out = []
    runner = StreamRunner(step, qpsk_rx_stream.init_state(cfg),
                          iter(blocks), sink=out.append)
    runner.run()
    assert len(out) == n_blocks

    # discard 3 acquisition blocks; everything after must be perfect,
    # INCLUDING the frequency step at block 17.
    skip = 3
    sym = np.concatenate(out[skip:])
    sym = sym[:, 0] + 1j * sym[:, 1]
    start_sym = skip * M  # plus pipeline lag, absorbed by the search
    errs, compared, rot, lag = _best_align(sym, bits, start_sym)
    assert compared > 60000, compared
    assert errs == 0, (errs, compared, rot, lag)


def test_streaming_rx_block_size_invariance():
    # The same stream chopped into different block sizes must produce
    # the same symbol decisions (streaming state is seamless).
    rng = np.random.default_rng(5)
    n_sym = 16 * 1024 + 64
    bits = rng.integers(0, 2, size=2 * n_sym).astype(np.uint8)
    r = _frac_delay(_tx(bits), 0.6) * np.exp(
        1j * (0.4 + 0.005 * np.arange(n_sym * SPS))).astype(np.complex64)

    def run(block):
        cfg = qpsk_rx_stream.QpskRxStreamConfig(block=block)
        step = qpsk_rx_stream.make_stream_fn(cfg)
        st = qpsk_rx_stream.init_state(cfg)
        outs = []
        usable = (len(r) // block) * block
        for b in range(usable // block):
            x = r[b * block:(b + 1) * block]
            y, st = step(st, jnp.asarray(
                np.stack([x.real, x.imag], axis=-1).astype(np.float32)))
            outs.append(np.asarray(y))
        sym = np.concatenate(outs)
        return sym[:, 0] + 1j * sym[:, 1]

    a = run(4096)
    b = run(8192)
    m = min(len(a), len(b))
    # skip acquisition (estimator EMA warm-up sequences differ slightly
    # between choppings); decisions must agree exactly after warm-up
    skip = 4096
    da = decide_bits(a[skip:m])
    db = decide_bits(b[skip:m])
    assert np.mean(da != db) < 1e-3


def test_streaming_rx_large_sps_context():
    # sps > 5 needs a larger interpolator context (L_CTX scales with
    # sps); the cubic window must never index before the carried
    # context — outputs stay finite on arbitrary input.
    cfg = qpsk_rx_stream.QpskRxStreamConfig(block=4096, sps=8)
    assert cfg.L_CTX >= 2 * cfg.sps + 4
    step = qpsk_rx_stream.make_stream_fn(cfg)
    st = qpsk_rx_stream.init_state(cfg)
    rng = np.random.default_rng(7)
    for _ in range(2):
        x = rng.normal(size=(cfg.block, 2)).astype(np.float32)
        y, st = step(st, jnp.asarray(x))
        assert np.isfinite(np.asarray(y)).all()


def test_stream_fast_zero_ber_and_gap_free():
    """The estimate-pipelined fast stream receiver: continuous tx
    stream with CFO, chopped into blocks; blocks after the warm-up
    decode with zero bit errors on a gap-free symbol grid."""
    from comms_tpu.models import qpsk_rx

    nbits = 16384
    tcfg = qpsk_tx.QpskTxConfig(bits_per_block=nbits, dphase=0.0)
    blk = qpsk_tx.make_block_fn(tcfg)
    iq, _ = blk(qpsk_tx.init_state(tcfg, 3))
    z = np.asarray(iq).astype(np.float32) / tcfg.scale
    x = (z[:, 0] + 1j * z[:, 1]).astype(np.complex128)
    key = crandom.source_init(3)
    bits, _ = crandom.random_bits_block(key, nbits)
    bits = np.asarray(bits)

    n = np.arange(len(x))
    xc = (x * np.exp(1j * (0.006 * n + 0.8))).astype(np.complex64)

    cfg = qpsk_rx.QpskRxConfig()
    step = qpsk_rx_stream.make_stream_fast_fn(cfg)
    st = qpsk_rx_stream.init_state_fast(cfg)
    B = len(xc) // 4
    M = B // cfg.sps
    outs = []
    for b in range(4):
        seg = xc[b * B:(b + 1) * B]
        sym, st = step(st, jnp.asarray(seg.real), jnp.asarray(seg.imag))
        assert sym.shape == (2, M)
        outs.append(np.asarray(sym))
    # skip the warm-up block (zero estimates/context) + a margin into
    # block 1 while the carried ctx covers the previous block's taps
    sym_all = np.concatenate(outs[1:], axis=1)
    margin = 32
    cand = sym_all[:, margin:]
    # global symbol s maps to tx bit pair s - 8 (tx+rx group delay,
    # as the one-shot loopback asserts); blocks 1.. start at symbol M
    ref = bits[2 * (M + margin - 8):]
    best = qpsk_rx.resolve_ambiguity(cand, ref, search=1500,
                                     max_lag=16)
    (rot, lag), errs, m = best
    assert m >= 2048 and errs == 0, best


def test_stream_split_matches_fast():
    """The two-dispatch split receiver (make_stream_split_fns) is the
    SAME computation as make_stream_fast_fn cut into two programs:
    identical state evolution and symbol outputs on the same stream."""
    from comms_tpu.models import qpsk_rx

    cfg = qpsk_rx.QpskRxConfig()
    fast = qpsk_rx_stream.make_stream_fast_fn(cfg)
    sym_fn, est_fn = qpsk_rx_stream.make_stream_split_fns(cfg)
    st_f = qpsk_rx_stream.init_state_fast(cfg)
    st_s = qpsk_rx_stream.init_state_fast(cfg)

    rng = np.random.default_rng(11)
    B = 4096
    for b in range(3):
        x = rng.normal(size=(2, B)).astype(np.float32)
        re, im = jnp.asarray(x[0]), jnp.asarray(x[1])
        y_f, st_f = fast(st_f, re, im)
        y_s, st_s = sym_fn(st_s, re, im)
        om, lag, sh2 = est_fn(re, im)
        st_s = {**st_s, "omega": om, "lag": lag, "shift2": sh2}
        np.testing.assert_allclose(np.asarray(y_s), np.asarray(y_f),
                                   atol=1e-5, rtol=1e-5)
        for k in st_f:
            np.testing.assert_allclose(
                np.asarray(st_s[k]), np.asarray(st_f[k]),
                atol=1e-5, rtol=1e-5, err_msg=f"state key {k} (blk {b})")


def test_split_serving_step_through_streamrunner():
    """make_split_serving_step driven by StreamRunner (depth 2 — the
    two programs per block must be merge-safe while older blocks are
    still in flight) matches a hand loop of make_stream_fast_fn."""
    from comms_tpu.models import qpsk_rx

    cfg = qpsk_rx.QpskRxConfig()
    fast = qpsk_rx_stream.make_stream_fast_fn(cfg)
    step = qpsk_rx_stream.make_split_serving_step(cfg)

    rng = np.random.default_rng(23)
    B, S = 4096, 4
    blocks = [tuple(jnp.asarray(rng.normal(size=B).astype(np.float32))
                    for _ in range(2)) for _ in range(S)]

    st_f = qpsk_rx_stream.init_state_fast(cfg)
    want = []
    for re, im in blocks:
        y, st_f = fast(st_f, re, im)
        want.append(np.asarray(y))

    got = []
    runner = StreamRunner(step, qpsk_rx_stream.init_state_fast(cfg),
                          blocks, sink=got.append,
                          samples_of=lambda x: B, depth=2)
    runner.run()
    assert len(got) == S
    for b, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5,
                                   err_msg=f"block {b}")


def test_stream_fast_decodes_long_blocks():
    """make_stream_fast_fn over serving-sized blocks of a real
    waveform with CFO: its split two-dispatch form agrees block by
    block, and the stream decodes with zero bit errors after the
    warm-up block."""
    from comms_tpu.models import qpsk_rx

    xc, bits = _fused_stream_signal()
    cfg = qpsk_rx.QpskRxConfig()
    fast = qpsk_rx_stream.make_stream_fast_fn(cfg)
    sym_fn, est_fn = qpsk_rx_stream.make_stream_split_fns(cfg)
    st_a = qpsk_rx_stream.init_state_fast(cfg)
    st_b = qpsk_rx_stream.init_state_fast(cfg)

    B = _STREAM_BLOCK
    nblk = (len(xc) // B)
    assert nblk >= 2
    outs = []
    for b in range(nblk):
        seg = xc[b * B:(b + 1) * B]
        re = jnp.asarray(seg.real.astype(np.float32))
        im = jnp.asarray(seg.imag.astype(np.float32))
        y_a, st_a = fast(st_a, re, im)
        y_b, st_b = sym_fn(st_b, re, im)
        omega, lag, shift2 = est_fn(re, im)
        st_b = {**st_b, "omega": omega, "lag": lag, "shift2": shift2}
        np.testing.assert_allclose(np.asarray(y_b), np.asarray(y_a),
                                   atol=2e-3, rtol=2e-3,
                                   err_msg=f"block {b}")
        outs.append(np.asarray(y_a))
        for k in st_a:
            np.testing.assert_allclose(
                np.asarray(st_b[k]), np.asarray(st_a[k]),
                atol=1e-3, rtol=1e-3, err_msg=f"state {k} (block {b})")

    from comms_tpu.models.qpsk_rx import resolve_ambiguity

    M = B // cfg.sps
    sym_all = np.concatenate(outs[1:], axis=1)
    margin = 32
    ref = bits[2 * (M + margin - 8):]
    (rot, lag), errs, m = resolve_ambiguity(sym_all[:, margin:], ref,
                                            search=1500, max_lag=16)
    assert m >= 2048 and errs == 0, (rot, lag, errs, m)


# serving-sized stream block (2 x 128 x 128 symbols' worth of samples)
_STREAM_BLOCK = 32768


def _fused_stream_signal():
    """A continuous qpsk_tx waveform long enough for >= 2 stream
    blocks, with CFO + phase offset."""
    from comms_tpu.ops import random as crandom

    B = _STREAM_BLOCK
    nbits = 2 * (2 * B // SPS) + 256
    tcfg = qpsk_tx.QpskTxConfig(bits_per_block=nbits, dphase=0.0)
    iq, _ = qpsk_tx.make_block_fn(tcfg)(qpsk_tx.init_state(tcfg, 3))
    z = np.asarray(iq).astype(np.float32) / tcfg.scale
    x = (z[:, 0] + 1j * z[:, 1]).astype(np.complex128)
    bits, _ = crandom.random_bits_block(crandom.source_init(3), nbits)
    n = np.arange(len(x))
    xc = (x * np.exp(1j * (0.006 * n + 0.8))).astype(np.complex64)
    return xc, np.asarray(bits)
