"""Fused FM kernel (Pallas through Triton), run in the Pallas
interpreter on the CPU: parity with the XLA polyphase chain, streaming
state, run_file's ragged tail, rejected shapes and the routing that
picks it.  The compiled kernel is tested on the card by
tests/test_kernels_gpu.py."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from comms_tpu.kernels import fm_chain_pallas as K
from comms_tpu.models import fm_receiver

Q = fm_receiver.FUSED_BLOCK_QUANTUM
# kernel vs the XLA chain: f32 sums in another order and the same
# polynomial atan2 (measured ~1e-6 on these captures)
_TOL = 1e-4


def _fm_capture(n, seed=0):
    """Constant-envelope phase signal quantised to u8."""
    rng = np.random.default_rng(seed)
    ph = np.cumsum(0.3 * np.sin(2 * np.pi * np.arange(n) / 997.0)
                   + 0.05 * rng.standard_normal(n))
    iq = np.stack([127.5 + 100 * np.cos(ph), 127.5 + 100 * np.sin(ph)], 1)
    return np.clip(np.round(iq), 0, 255).astype(np.uint8)


def _xla(iq, block):
    cfg = fm_receiver.FmReceiverConfig(block=block)
    blk = fm_receiver.make_block_fn(cfg)
    st = fm_receiver.init_state(cfg)
    outs = []
    for b in range(iq.shape[0] // block):
        a, st = blk(st, jnp.asarray(iq[b * block:(b + 1) * block]))
        outs.append(np.asarray(a))
    return np.concatenate(outs), st


def test_centered_bytes_exact():
    # every u16 word -> (re - 127.5, im - 127.5), bit-exact
    w = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    re, im = K._centered(jnp.asarray(w))
    np.testing.assert_array_equal(np.asarray(re),
                                  (w & 0xFF).astype(np.float32) - 127.5)
    np.testing.assert_array_equal(np.asarray(im),
                                  (w >> 8).astype(np.float32) - 127.5)


@pytest.mark.parametrize("programs", [1, 2, 3])
def test_fused_chain_parity_interpret(programs):
    n = programs * Q
    iq = _fm_capture(n, seed=programs)
    audio = K.fm_chain_fused(jnp.asarray(iq), K.zero_ctx(),
                             fm_receiver.FM_LPF_TAPS,
                             fm_receiver.FM_LPF_TAPS, interpret=True)
    ref, _ = _xla(iq, n)
    assert np.asarray(audio).shape == ref.shape == (n // 25,)
    assert np.max(np.abs(np.asarray(audio) - ref)) < _TOL


def test_fused_chain_streaming_blocks():
    # Two chained blocks == the one-shot kernel over both, and the
    # XLA chain over the same stream.
    iq = _fm_capture(2 * Q, seed=5)
    blk = fm_receiver.make_fused_block_fn(
        fm_receiver.FmReceiverConfig(block=Q), interpret=True)
    st = fm_receiver.fused_init_state()
    outs = []
    for b in range(2):
        a, st = blk(st, jnp.asarray(iq[b * Q:(b + 1) * Q]))
        outs.append(np.asarray(a))
    chained = np.concatenate(outs)
    one = np.asarray(K.fm_chain_fused(
        jnp.asarray(iq), K.zero_ctx(), fm_receiver.FM_LPF_TAPS,
        fm_receiver.FM_LPF_TAPS, interpret=True))
    assert np.max(np.abs(chained - one)) < 1e-6
    ref, _ = _xla(iq, Q)
    assert np.max(np.abs(chained - ref)) < _TOL
    np.testing.assert_array_equal(
        np.asarray(st), iq[-K.CTX:].T.astype(np.float32) - 127.5)


def test_fused_chain_rejects_bad_block():
    with pytest.raises(ValueError, match=str(Q)):
        fm_receiver.make_fused_block_fn(
            fm_receiver.FmReceiverConfig(block=262144))
    with pytest.raises(ValueError, match="dec1 = dec2 = 5"):
        fm_receiver.make_fused_block_fn(
            fm_receiver.FmReceiverConfig(block=Q * 4, dec1=4, dec2=4))
    ctx = K.zero_ctx()
    taps = fm_receiver.FM_LPF_TAPS
    with pytest.raises(ValueError, match="uint8"):
        K.fm_chain_fused(jnp.zeros((Q, 2), jnp.int8), ctx, taps, taps)
    with pytest.raises(ValueError, match="uint8"):
        K.fm_chain_fused(jnp.zeros((Q,), jnp.uint8), ctx, taps, taps)
    with pytest.raises(ValueError, match="multiple"):
        K.fm_chain_fused(jnp.zeros((Q + 25, 2), jnp.uint8), ctx, taps, taps)
    with pytest.raises(ValueError, match="63-tap"):
        K.fm_chain_fused(jnp.zeros((Q, 2), jnp.uint8), ctx, taps[:31], taps)


def test_run_file_fused_matches_xla(tmp_path, monkeypatch):
    # run_file's fused path (kernel blocks + the XLA ragged tail from
    # the mapped state) must match the XLA path.
    B = 2 * Q
    iq = _fm_capture(2 * B + 3777, seed=4)
    p = tmp_path / "cap.iq"
    iq.tofile(p)
    cfg = fm_receiver.FmReceiverConfig(block=B)
    ref = fm_receiver.run_file(p, cfg, fused=False)
    real_make = fm_receiver.make_fused_block_fn
    monkeypatch.setattr(
        fm_receiver, "make_fused_block_fn",
        lambda c, interpret=False: real_make(c, interpret=True))
    got = fm_receiver.run_file(p, cfg, fused=True)
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) < _TOL


def test_fused_state_maps_onto_xla_state():
    # the ragged-tail handoff: the fused state mapped to make_block_fn's
    # state equals the state the XLA chain itself carries
    iq = _fm_capture(Q, seed=6)
    _, st_x = _xla(iq, Q)
    cfg = fm_receiver.FmReceiverConfig(block=Q)
    mapped = fm_receiver._fused_to_xla_state(
        cfg, fm_receiver.fused_ctx_from_raw_tail(jnp.asarray(iq)))
    for got, want in zip(mapped, st_x):
        assert np.max(np.abs(np.asarray(got) - np.asarray(want))) < 1e-5


def test_fused_routing(monkeypatch):
    ok = fm_receiver.FmReceiverConfig(block=512 * Q)
    assert not fm_receiver.fused_chain_ok(ok)          # CPU: XLA chain
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert fm_receiver.fused_chain_ok(ok)
    assert fm_receiver.fused_chain_ok(fm_receiver.FmReceiverConfig(block=Q))
    # the reference's own 2^18 block: dense path, not the kernel
    assert not fm_receiver.fused_chain_ok(fm_receiver.FmReceiverConfig())
    assert not fm_receiver.fused_chain_ok(
        fm_receiver.FmReceiverConfig(block=Q * 5 + 25 * 100))
    assert not fm_receiver.fused_chain_ok(
        fm_receiver.FmReceiverConfig(block=Q * 4, dec1=4, dec2=4))
