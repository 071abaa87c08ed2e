"""End-to-end QPSK loopback: tx -> impaired channel -> full receiver
(coarse CFO -> matched filter -> NDA timing -> fine CFO -> phase) ->
zero bit errors.  Exercises the reference's three estimators jointly
in a closed loop (they are only ever unit-tested there)."""

import numpy as np
import jax
import jax.numpy as jnp

from comms_tpu.models import qpsk_rx, qpsk_tx
from comms_tpu.ops import demodulation, interp, random as crandom


def _tx(seed=1, nbits=4096):
    cfg = qpsk_tx.QpskTxConfig(bits_per_block=nbits, dphase=0.0)
    block = qpsk_tx.make_block_fn(cfg)
    iq, _ = block(qpsk_tx.init_state(cfg, seed))
    z = np.asarray(iq).astype(np.float32) / cfg.scale
    x = (z[:, 0] + 1j * z[:, 1]).astype(np.complex64)
    key = crandom.source_init(seed)
    bits, _ = crandom.random_bits_block(key, nbits)
    return x, np.asarray(bits)


def _rx_ber(x, bits):
    rx = qpsk_rx.make_rx_fn(qpsk_rx.QpskRxConfig())
    pairs = np.stack([x.real, x.imag], -1).astype(np.float32)
    sym, diag = rx(jnp.asarray(pairs))
    best = qpsk_rx.resolve_ambiguity(np.asarray(sym), bits, search=1500)
    return best, diag


def test_loopback_clean_zero_ber():
    x, bits = _tx()
    ((rot, lag), errs, m), diag = _rx_ber(x, bits)
    assert m == 3000 and errs == 0
    assert lag == 8  # tx+rx RRC group delay: (2*32-2)/2 / 4 symbols


def test_loopback_fractional_delay():
    x, bits = _tx()
    (_, errs0, _), diag0 = _rx_ber(x, bits)
    xc = np.asarray(interp.delay_signal(jnp.asarray(x), 2.3))
    (_, errs, m), diag = _rx_ber(xc, bits)
    assert errs0 == 0 and errs == 0
    # The estimate moves by +delay relative to the clean baseline
    # (mod sps; the chain's own group delay sets the baseline).
    delta = float(diag["timing"]) - float(diag0["timing"])
    assert abs((delta - 2.3 + 2) % 4 - 2) < 0.15


def test_loopback_full_impairment_zero_ber():
    x, bits = _tx()
    n = np.arange(len(x))
    xc = (x * np.exp(1j * (0.01 * n + 0.6))).astype(np.complex64)
    xc = np.asarray(interp.delay_signal(jnp.asarray(xc), 2.3))
    rng = np.random.default_rng(0)
    xc = (xc + 0.02 * (rng.normal(size=len(xc))
                       + 1j * rng.normal(size=len(xc)))).astype(np.complex64)
    (_, errs, m), diag = _rx_ber(xc, bits)
    assert errs == 0
    assert abs(float(diag["freq"]) - 0.01) < 0.01  # reference tol


def test_costas_loop_tracks_phase_step():
    # QPSK symbols with a static rotation + slow drift: the
    # decision-directed loop converges and the steady-state error is
    # small.
    rng = np.random.default_rng(2)
    v = rng.integers(0, 4, size=2000)
    sym = np.exp(1j * (np.pi / 4 + np.pi / 2 * v))
    drift = 0.002
    rx_in = sym * np.exp(1j * (0.4 + drift * np.arange(len(sym))))

    y, (ph, fr) = demodulation.costas_loop_block(
        jnp.asarray(rx_in.astype(np.complex64)),
        (jnp.float32(0.0), jnp.float32(0.0)),
        alpha=0.1, beta=0.02)
    # after convergence the loop's frequency register matches the drift
    assert abs(float(fr) - drift) < 5e-4
    # steady state: lock at the +-1+-1j-style constellation, where
    # c^4 = -|c|^4 (angle pi) — decisions and the loop agree.
    tail = np.asarray(y)[-500:]
    assert np.max(np.abs(np.abs(np.angle(tail ** 4)) - np.pi)) < 0.25
    # and bit decisions on the locked tail are self-consistent: every
    # symbol sits in an open quadrant, far from the axes.
    assert np.min(np.abs(tail.real)) > 0.3
    assert np.min(np.abs(tail.imag)) > 0.3


def test_lagrange_interp_exact_on_polynomials():
    # cubic Lagrange reproduces cubic signals exactly.
    n = np.arange(50, dtype=np.float64)
    x = 0.3 * n**3 - 2 * n**2 + n - 5
    mu = 0.37
    y = np.asarray(interp.fractional_delay(jnp.asarray(x), mu))
    expected = 0.3 * (n - 1 - mu)**3 - 2 * (n - 1 - mu)**2 + (n - 1 - mu) - 5
    assert np.allclose(y[4:], expected[4:], rtol=1e-6)


def test_planar_rx_matches_pairs_rx():
    # make_rx_fn_planar(re, im) is the production entry (io/raw_iq
    # unpacks to planes); it must be bit-identical to the pairs entry.
    x, bits = _tx()
    n = np.arange(len(x))
    xc = (x * np.exp(1j * (0.004 * n + 0.3))).astype(np.complex64)
    cfg = qpsk_rx.QpskRxConfig()
    pairs = np.stack([xc.real, xc.imag], -1).astype(np.float32)
    sym_p, diag_p = qpsk_rx.make_rx_fn(cfg)(jnp.asarray(pairs))
    sym_q, diag_q = qpsk_rx.make_rx_fn_planar(cfg)(
        jnp.asarray(xc.real), jnp.asarray(xc.imag))
    assert np.array_equal(np.asarray(sym_p), np.asarray(sym_q))
    for k in diag_p:
        assert np.array_equal(np.asarray(diag_p[k]), np.asarray(diag_q[k]))


def test_fused_core_matches_staged_core():
    # The round-4 fused core (panels on raw planes, MF folded into
    # host weights + the final decimating GEMM) against the staged
    # core: identical BER, estimates within the edge-term budget
    # (the folds are exact up to O((ND + T)/N) block-edge terms).
    x, bits = _tx()
    n = np.arange(len(x))
    xc = (x * np.exp(1j * (0.008 * n + 0.4))).astype(np.complex64)
    xc = np.asarray(interp.delay_signal(jnp.asarray(xc), 1.7))
    cfg = qpsk_rx.QpskRxConfig()
    re = jnp.asarray(xc.real)
    im = jnp.asarray(xc.imag)
    sym_f, diag_f = jax.jit(
        lambda a, b: qpsk_rx._rx_core_fused(cfg, a, b))(re, im)
    sym_s, diag_s = jax.jit(
        lambda a, b: qpsk_rx._rx_core_staged(cfg, a, b))(re, im)
    # Edge-term budget: the folds are exact up to O((ND + T)/N)
    # boundary terms (~3e-3 relative at this 16k-sample block;
    # they vanish at serving block sizes).  Reference tolerances
    # are 0.01 for both estimates.
    assert abs(float(diag_f["freq"]) - float(diag_s["freq"])) < 2e-3
    assert abs(float(diag_f["timing"]) - float(diag_s["timing"])) < 1e-2
    assert int(diag_f["sym_phase"]) == int(diag_s["sym_phase"])
    bf = qpsk_rx.resolve_ambiguity(np.asarray(sym_f), bits, search=1500)
    bs = qpsk_rx.resolve_ambiguity(np.asarray(sym_s), bits, search=1500)
    assert bf[1] == 0 and bs[1] == 0


def test_symbol_gemm_context_patch_is_exact():
    """The streaming form of _fused_symbol_gemm (carried raw tail +
    block-start phase) equals the one-shot over the concatenated
    stream, and a zero context equals no context."""
    rng = np.random.default_rng(5)
    N = 4096
    re = rng.normal(size=2 * N).astype(np.float32)
    im = rng.normal(size=2 * N).astype(np.float32)
    cfg = qpsk_rx.QpskRxConfig(gemm_precision=jax.lax.Precision.HIGHEST)
    C = qpsk_rx.fused_gemm_ctx_len(cfg)
    w = jnp.float32(0.011)
    lag = jnp.asarray([-0.05, 0.7, 0.4, -0.06], jnp.float32)
    for shift2 in (-4, 0, 3):
        args = (w, lag, jnp.int32(shift2))
        a_r, a_i = qpsk_rx._fused_symbol_gemm(
            cfg, jnp.asarray(re[N:]), jnp.asarray(im[N:]), *args,
            phase0=0.31)
        z = np.zeros(C, np.float32)
        b_r, b_i = qpsk_rx._fused_symbol_gemm(
            cfg, jnp.asarray(re[N:]), jnp.asarray(im[N:]), *args,
            ctx=(z, z), phase0=0.31)
        np.testing.assert_allclose(np.asarray(b_r), np.asarray(a_r),
                                   atol=1e-5, err_msg=f"shift2={shift2}")
        np.testing.assert_allclose(np.asarray(b_i), np.asarray(a_i),
                                   atol=1e-5)

        one_r, one_i = qpsk_rx._fused_symbol_gemm(
            cfg, jnp.asarray(re), jnp.asarray(im), *args, phase0=0.31)
        s_r, s_i = qpsk_rx._fused_symbol_gemm(
            cfg, jnp.asarray(re[N:]), jnp.asarray(im[N:]), *args,
            ctx=(re[N - C:N], im[N - C:N]),
            phase0=0.31 + float(w) * N)
        k = N // cfg.sps
        scale = float(np.abs(np.asarray(one_r)).max())
        # tolerance: the block-start phase is rounded once in f32
        np.testing.assert_allclose(np.asarray(s_r), np.asarray(one_r)[k:],
                                   atol=1e-4 * scale,
                                   err_msg=f"stream shift2={shift2}")
        np.testing.assert_allclose(np.asarray(s_i), np.asarray(one_i)[k:],
                                   atol=1e-4 * scale)
