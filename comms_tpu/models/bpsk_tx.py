"""BPSK transmitter: the reference's golden config.

Chain parity with ``/root/reference/examples/single_thread_bpsk.rs:16-52``
(and the threaded variant ``examples/bpsk_mod.rs``):

    random bits (4096/block) -> BPSK (2b-1) -> zero-stuff x4
    -> RRC(32 taps, sps=4, beta=0.25) -> scale 8192 -> i16 IQ file

The whole block is ONE jitted function — bits from the
counter-based PRNG, polyphase pulse shaping as a dense GEMM on the
symbol stream (no zero multiplication), truncating i16 quantization on
device.  Output crosses the boundary as int16 interleaved pairs =
bytes of the output file.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

from comms_tpu.ops import modulation, pulse, random as crandom, taps, txshape

__all__ = ["BpskTxConfig", "make_block_fn", "make_block_fn_fast",
           "make_pipeline", "init_state", "init_state_fast", "run_to_file"]

SYMS_PER_BLOCK = 4096
SPS = 4
NUM_TAPS = 32
BETA = 0.25
SCALE = 8192.0


class BpskTxConfig:
    """Static parameters, precomputed on host in float64."""

    def __init__(self, syms_per_block: int = SYMS_PER_BLOCK, sps: int = SPS,
                 num_taps: int = NUM_TAPS, beta: float = BETA,
                 scale: float = SCALE):
        self.syms_per_block = int(syms_per_block)
        self.sps = int(sps)
        self.num_taps = int(num_taps)
        self.beta = float(beta)
        self.scale = float(scale)
        t = taps.rrc_taps(num_taps, float(sps), beta).astype(np.complex64)
        self.phase_taps = pulse.polyphase_taps(t, sps)
        self._shape_mats = None

    @property
    def samples_per_block(self) -> int:
        return self.syms_per_block * self.sps

    @property
    def shape_mats(self) -> txshape.TxShapeMats:
        """Fused bits->samples GEMM operands (lazy, host f64->f32)."""
        if self._shape_mats is None:
            t = taps.rrc_taps(self.num_taps, float(self.sps), self.beta)
            self._shape_mats = txshape.tx_shape_matrices(
                t, self.sps, bits_per_sym=1)
        return self._shape_mats


def init_state(cfg: BpskTxConfig, seed: int = 0):
    """(prng_key, pulse_ctx_pairs) — boundary-safe (no complex leaves)."""
    key = crandom.source_init(seed)
    ctx_len = max(-(-cfg.num_taps // cfg.sps) - 1, 0)
    ctx_pairs = jnp.zeros((ctx_len, 2), dtype=jnp.float32)
    return key, ctx_pairs


def make_block_fn(cfg: BpskTxConfig):
    """Returns jitted ``(state) -> (iq_i16[N, 2], new_state)``.

    The int16 output rows are (re, im) — exactly the file bytes
    (raw_iq.rs:1-5 layout).
    """
    # Constants stay numpy closures: they lower to program constants
    # with no host->device transfer.
    H = cfg.phase_taps

    @jax.jit
    def block(state):
        key, ctx_pairs = state
        bits, key = crandom.random_bits_block(key, cfg.syms_per_block)
        sym = modulation.bpsk_bit_mod_example(bits)
        ctx = jax.lax.complex(ctx_pairs[:, 0], ctx_pairs[:, 1])
        y, ctx = pulse.pulse_shape_block(sym, H, ctx)
        new_ctx_pairs = jnp.stack([jnp.real(ctx), jnp.imag(ctx)], axis=-1)
        re = _trunc_i16(jnp.real(y) * cfg.scale)
        im = _trunc_i16(jnp.imag(y) * cfg.scale)
        iq = jnp.stack([re, im], axis=-1)
        return iq, (key, new_ctx_pairs)

    return block


def _trunc_i16(x):
    """Rust ``as i16``: truncate toward zero, saturate."""
    t = jnp.trunc(x)
    return jnp.clip(t, -32768.0, 32767.0).astype(jnp.int16)


def init_state_fast(cfg: BpskTxConfig, seed: int = 0):
    """State for :func:`make_block_fn_fast`: (prng_key, ctx_bits).

    Initial context bits are 0.5 — the bit value whose symbol map
    ``2b - 1`` is the zero symbol, so the warmup transient matches the
    reference's zero FIR state exactly.
    """
    key = crandom.source_init(seed)
    ctx = jnp.full((cfg.shape_mats.ctx_bits,), 0.5, dtype=jnp.float32)
    return key, ctx


def make_block_fn_fast(cfg: BpskTxConfig):
    """Production tx path: jitted ``state -> (iq_packed_i32[N], state)``.

    The whole chain (PRNG -> map -> upsample -> RRC -> quantize ->
    interleave) is one planar banded GEMM plus full-lane elementwise
    ops (:mod:`comms_tpu.ops.txshape`); the packed int32 stream's
    little-endian bytes are the i16 IQ file format.  It differs from
    the pair-layout path only by f32 summation order (<=1 i16 LSB)
    and by PRNG stream (:func:`comms_tpu.ops.random.random_bits_packed_block`).
    """
    mats = cfg.shape_mats

    @jax.jit
    def block(state):
        key, ctx = state
        bits, key = crandom.random_bits_packed_block(key, cfg.syms_per_block)
        yre, yim, ctx, n_valid = txshape.tx_shape_block(bits, ctx, mats)
        packed = txshape.quantize_pack_iq(yre, yim, cfg.scale, n_valid)
        return packed, (key, ctx)

    return block


def make_pipeline(cfg: Optional[BpskTxConfig] = None, seed: int = 0):
    """The same tx chain on the generic runtime layer (source-headed
    :class:`comms_tpu.runtime.Pipeline` — the reference's bpsk_mod
    graph, examples/bpsk_mod.rs:124-161, as a BlockOp program).

    ``pipe.run(pipe.init_state(), None, num_blocks=n)`` is bit-exact
    to driving :func:`make_block_fn` with the same seed.
    """
    from comms_tpu.runtime import (
        BpskMod, Lambda, Pipeline, PulseShape, RandomBitSource,
    )

    cfg = cfg or BpskTxConfig()
    t = taps.rrc_taps(cfg.num_taps, float(cfg.sps),
                      cfg.beta).astype(np.complex64)

    def quantize(y):
        re = _trunc_i16(jnp.real(y) * cfg.scale)
        im = _trunc_i16(jnp.imag(y) * cfg.scale)
        return jnp.stack([re, im], axis=-1)

    return Pipeline([
        RandomBitSource(cfg.syms_per_block, seed),
        BpskMod(example_convention=True),
        PulseShape.make(t, cfg.sps),
        Lambda(quantize, result_dtype=jnp.int16),
    ])


def run_to_file(path, num_blocks: int, cfg: Optional[BpskTxConfig] = None,
                seed: int = 0, fast: bool = False) -> int:
    """File-driven entry (bpsk_out.bin parity).  Returns samples written.

    ``fast=True`` uses :func:`make_block_fn_fast` (packed-i32 device
    layout, identical file bytes modulo its documented PRNG stream and
    <=1 LSB rounding difference — see its docstring)."""
    cfg = cfg or BpskTxConfig()
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
