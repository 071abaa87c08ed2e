"""QPSK transmitter with mixer upconversion.

Chain parity with ``/root/reference/examples/single_thread_qpsk.rs:16-52``
(4096 bits -> 2048 QPSK syms -> zero-stuff x4 -> RRC(32, 4, 0.25)
-> scale 8192 -> i16 file) plus the BASELINE config's "mixer
upconvert" stage (a closed-form phase-ramp mixer after pulse shaping;
the reference's qpsk_zmq example mixes similarly before transmit).

One jitted block: bits -> symbols (consecutive-pair map) -> polyphase
RRC GEMM -> mixer (precomputed ramp x carried phasor) -> i16 pairs.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

from comms_tpu.ops import (
    mixer, modulation, pulse, random as crandom, taps, txshape,
)

__all__ = ["QpskTxConfig", "make_block_fn", "make_block_fn_fast",
           "make_pipeline", "init_state", "init_state_fast", "run_to_file"]


class QpskTxConfig:
    def __init__(self, bits_per_block: int = 4096, sps: int = 4,
                 num_taps: int = 32, beta: float = 0.25,
                 scale: float = 8192.0, dphase: float = 0.0,
                 phase0: float = 0.0):
        if bits_per_block % 2:
            raise ValueError("bits_per_block must be even")
        self.bits_per_block = int(bits_per_block)
        self.sps = int(sps)
        self.num_taps = int(num_taps)
        self.beta = float(beta)
        self.scale = float(scale)
        self.dphase = float(dphase)
        self.phase0 = float(phase0)
        t = taps.rrc_taps(num_taps, float(sps), beta).astype(np.complex64)
        self.phase_taps = pulse.polyphase_taps(t, sps)
        self._ramp = None
        self._advance_fix = None
        self._shape_mats = None
        self._mix_tables = None

    @property
    def samples_per_block(self) -> int:
        return (self.bits_per_block // 2) * self.sps

    @property
    def ramp(self):
        """N-sized complex mixer ramp for the pair-layout path (lazy —
        it is an O(N) host constant the fused path never needs)."""
        if self._ramp is None:
            self._ramp, _ = mixer.mixer_ramp(self.samples_per_block,
                                             self.dphase)
        return self._ramp

    @property
    def advance_fix(self):
        if self._advance_fix is None:
            self._advance_fix = mixer.advance_fix(self.samples_per_block,
                                                  self.dphase)
        return self._advance_fix

    @property
    def shape_mats(self) -> txshape.TxShapeMats:
        """Fused bits->samples GEMM operands (lazy, host f64->f32)."""
        if self._shape_mats is None:
            t = taps.rrc_taps(self.num_taps, float(self.sps), self.beta)
            self._shape_mats = txshape.tx_shape_matrices(
                t, self.sps, bits_per_sym=2)
        return self._shape_mats

    @property
    def mix_tables(self) -> txshape.MixerTables:
        """Planar mixer angle tables (lazy; O(N/128) host floats)."""
        if self._mix_tables is None:
            self._mix_tables = txshape.mixer_tables(
                self.samples_per_block, self.dphase,
                self.shape_mats.samples_per_row)
        return self._mix_tables


def init_state(cfg: QpskTxConfig, seed: int = 0):
    key = crandom.source_init(seed)
    ctx_len = max(-(-cfg.num_taps // cfg.sps) - 1, 0)
    ctx_pairs = jnp.zeros((ctx_len, 2), dtype=jnp.float32)
    phase = mixer.phase_fix_init(cfg.phase0)
    return key, ctx_pairs, phase


def make_block_fn(cfg: QpskTxConfig):
    """jitted ``state -> (iq_i16[N, 2], new_state)``."""
    # numpy closures: host constants baked into the program
    H = cfg.phase_taps
    ramp = cfg.ramp

    @jax.jit
    def block(state):
        key, ctx_pairs, phase = state
        bits, key = crandom.random_bits_block(key, cfg.bits_per_block)
        sym = modulation.qpsk_bits_mod_example(bits)
        ctx = jax.lax.complex(ctx_pairs[:, 0], ctx_pairs[:, 1])
        y, ctx = pulse.pulse_shape_block(sym, H, ctx)
        y, phase = mixer.mixer_block_fix(y, phase, ramp, cfg.advance_fix)
        new_ctx_pairs = jnp.stack([jnp.real(ctx), jnp.imag(ctx)], axis=-1)
        re = jnp.clip(jnp.trunc(jnp.real(y) * cfg.scale),
                      -32768.0, 32767.0).astype(jnp.int16)
        im = jnp.clip(jnp.trunc(jnp.imag(y) * cfg.scale),
                      -32768.0, 32767.0).astype(jnp.int16)
        return jnp.stack([re, im], axis=-1), (key, new_ctx_pairs, phase)

    return block


def init_state_fast(cfg: QpskTxConfig, seed: int = 0):
    """State for :func:`make_block_fn_fast`: (key, ctx_bits, phase_fix).

    Initial context bits are 0.5 — the bit value whose symbol map
    ``2b - 1`` is the zero symbol, matching the reference's zero FIR
    state."""
    key = crandom.source_init(seed)
    ctx = jnp.full((cfg.shape_mats.ctx_bits,), 0.5, dtype=jnp.float32)
    return key, ctx, mixer.phase_fix_init(cfg.phase0)


def make_block_fn_fast(cfg: QpskTxConfig):
    """Production tx path: jitted ``state -> (iq_packed_i32[N], state)``.

    PRNG -> QPSK map -> upsample -> RRC -> mixer -> quantize ->
    interleave as one planar banded GEMM + full-lane VPU epilogue
    (:mod:`comms_tpu.ops.txshape`).  The stride-2 re/im bit
    deinterleave of the symbol map and the [N, 2] i16 relayout — the
    two measured lane-collapse stages of the pair-layout path — do
    not exist here; the mixer uses host angle tables instead of an
    N-sized complex ramp constant.  Differs from
    :func:`make_block_fn` only by f32 summation order (<=1 i16 LSB)
    and PRNG stream (packed threefry words).
    """
    mats = cfg.shape_mats
    tables = cfg.mix_tables

    @jax.jit
    def block(state):
        key, ctx, pfix = state
        bits, key = crandom.random_bits_packed_block(key,
                                                     cfg.bits_per_block)
        yre, yim, ctx, n_valid = txshape.tx_shape_block(bits, ctx, mats)
        yre, yim, pfix = txshape.mix_planar(yre, yim, pfix, tables)
        packed = txshape.quantize_pack_iq(yre, yim, cfg.scale, n_valid)
        return packed, (key, ctx, pfix)

    return block


def make_pipeline(cfg: Optional[QpskTxConfig] = None, seed: int = 0):
    """The same tx chain on the generic runtime layer (source-headed
    Pipeline: bits -> QPSK -> pulse shape -> mixer -> i16 quantize).
    Bit-exact to :func:`make_block_fn` with the same seed."""
    from comms_tpu.runtime import (
        Lambda, Mixer, Pipeline, PulseShape, QpskMod, RandomBitSource,
    )

    cfg = cfg or QpskTxConfig()
    t = taps.rrc_taps(cfg.num_taps, float(cfg.sps),
                      cfg.beta).astype(np.complex64)

    def quantize(y):
        re = jnp.clip(jnp.trunc(jnp.real(y) * cfg.scale),
                      -32768.0, 32767.0).astype(jnp.int16)
        im = jnp.clip(jnp.trunc(jnp.imag(y) * cfg.scale),
                      -32768.0, 32767.0).astype(jnp.int16)
        return jnp.stack([re, im], axis=-1)

    return Pipeline([
        RandomBitSource(cfg.bits_per_block, seed),
        QpskMod(example_convention=True),
        PulseShape.make(t, cfg.sps),
        Mixer(cfg.dphase, cfg.phase0),
        Lambda(quantize, result_dtype=jnp.int16),
    ])


def run_to_file(path, num_blocks: int, cfg: Optional[QpskTxConfig] = None,
                seed: int = 0, fast: bool = False) -> int:
    cfg = cfg or QpskTxConfig()
    written = 0
    if fast:
        block = make_block_fn_fast(cfg)
        state = init_state_fast(cfg, seed)
        with open(path, "wb") as f:
            for _ in range(num_blocks):
                packed, state = block(state)
                arr = np.ascontiguousarray(np.asarray(packed), dtype="<i4")
                f.write(arr.tobytes())
                written += arr.shape[0]
        return written
    block = make_block_fn(cfg)
    state = init_state(cfg, seed)
    with open(path, "wb") as f:
        for _ in range(num_blocks):
            iq, state = block(state)
            arr = np.asarray(iq).astype(np.int16)
            f.write(arr.tobytes())
            written += arr.shape[0]
    return written
