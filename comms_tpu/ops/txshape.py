"""Fused transmit shaping: bits -> pulse-shaped IQ as ONE planar GEMM.

Functional parity with the reference tx chains
(``/root/reference/examples/single_thread_bpsk.rs:16-52`` and
``single_thread_qpsk.rs:16-52``: random bits -> symbol map ->
zero-stuff x sps -> RRC FIR -> scale 8192 -> interleaved i16 file),
re-derived as one GEMM instead of staged:

* The symbol map (``2b - 1``) and the polyphase pulse-shaping GEMM
  (:mod:`comms_tpu.ops.pulse`) are both **affine in the raw bit
  stream**, so map + upsample + FIR collapse into a single banded
  product ``Y[r, c] = (W @ G)[r, c] - off[c]`` where ``W`` holds
  overlapping windows of the bit stream (shifted reshapes, the
  :mod:`comms_tpu.ops.fir` pattern — no gather) and ``G`` is a
  host-precomputed banded matrix.  QPSK's stride-2 re/im bit
  deinterleave — measured as the chain's first lane-utilization
  collapse — disappears into ``G``'s band structure.
* Output rows carry 128 samples per plane (full 128-wide rows), re
  plane in columns ``[0, Pw)`` and im plane in ``[Pw, 2*Pw)`` of one
  GEMM, so every downstream elementwise op (mixer, quantize) runs at
  full lane utilization, unlike the ``[N, 2]``-pair layout whose
  2/128 lanes measured as the chain's slowest stage.
* The mixer ``y * exp(j*(phase0 + n*dphase))`` is applied on the
  planes via host-precomputed per-row / per-column angle tables and
  the angle-addition identity — ~18 VPU flops per sample, no
  device transcendentals, no N-sized complex ramp constant.
* i16 interleaving is a lane-parallel int32 pack ``(re & 0xffff) |
  (im << 16)``: the flat little-endian bytes of the packed word
  stream ARE the reference's file format (raw_iq.rs:1-5), so no
  ``[N, 2]`` relayout exists anywhere on device.

Streaming semantics: carried state is the last ``bits_per_sym*(M-1)``
raw bits (M = ceil(num_taps/sps)) plus the fixed-point mixer phase;
output is independent of block chopping (same property as
:func:`comms_tpu.ops.fir.fir_block`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

import jax.numpy as jnp
from jax import lax

from comms_tpu.ops import mixer as _mixer
from comms_tpu.ops.fir import _window_rows_strided

__all__ = [
    "TxShapeMats",
    "MixerTables",
    "tx_shape_matrices",
    "tx_shape_block",
    "mixer_tables",
    "mix_planar",
    "quantize_pack_iq",
    "unpack_iq",
]


class TxShapeMats(NamedTuple):
    """Host-precomputed shaping operands (numpy; safe to close over)."""

    G: np.ndarray          # [width, C] banded bit->sample matrix
    off: np.ndarray        # [C] constant offset (the "-1" of 2b-1)
    bits_per_sym: int      # 1 = BPSK (re only), 2 = QPSK interleaved
    sps: int
    ctx_bits: int          # carried raw bits = bits_per_sym * (M-1)
    stride: int            # window row stride in bits
    width: int             # window width in bits
    samples_per_row: int   # Pw (output samples per GEMM row per plane)
    planes: int            # 1 (BPSK, im = 0) or 2 (QPSK)


def tx_shape_matrices(taps, sps: int, bits_per_sym: int,
                      samples_per_row: int = 128) -> TxShapeMats:
    """Build the banded bit->sample GEMM operands on the host.

    ``taps`` is the 1-D pulse filter (real, or complex with zero
    imaginary part — the reference's RRC taps, math.rs:221-280).
    ``bits_per_sym`` = 1 maps bit b -> 2b-1 (single_thread_bpsk.rs:31);
    = 2 maps consecutive bit pairs (x, y) -> (2x-1) + j(2y-1)
    (single_thread_qpsk.rs:29-36).
    """
    t = np.asarray(taps)
    if np.iscomplexobj(t):
        if np.abs(t.imag).max() != 0.0:
            raise ValueError("tx_shape_matrices requires real taps")
        t = t.real
    t = t.astype(np.float64)
    sps = int(sps)
    B = int(bits_per_sym)
    if B not in (1, 2):
        raise ValueError("bits_per_sym must be 1 (BPSK) or 2 (QPSK)")
    Pw = int(samples_per_row)
    if Pw % sps:
        raise ValueError(f"samples_per_row {Pw} not a multiple of sps {sps}")
    S = Pw // sps                       # symbols per GEMM row
    T = t.shape[0]
    M = -(-T // sps)                    # symbols spanned by the filter
    # H[m, p] = taps[m*sps + p] (zero-padded), as ops.pulse.polyphase_taps
    Hf = np.zeros(M * sps)
    Hf[:T] = t
    H = Hf.reshape(M, sps)

    width = B * (S + M - 1)
    planes = 2 if B == 2 else 1
    C = planes * Pw
    G = np.zeros((width, C))
    off = np.zeros(C)
    for s in range(Pw):
        j, p = divmod(s, sps)
        col_sum = H[:, p].sum()
        for pl in range(planes):
            c = pl * Pw + s
            off[c] = col_sum
            for m in range(M):
                u = B * (j - m + M - 1) + pl
                G[u, c] += 2.0 * H[m, p]
    return TxShapeMats(
        G=G.astype(np.float32), off=off.astype(np.float32),
        bits_per_sym=B, sps=sps, ctx_bits=B * (M - 1), stride=B * S,
        width=width, samples_per_row=Pw, planes=planes)


def tx_shape_block(bits, ctx_bits, mats: TxShapeMats,
                   precision=None):
    """Shape one block of raw bits into sample planes.

    ``bits``: [Nbits] float32 in {0, 1} (``Nbits % bits_per_sym == 0``).
    ``ctx_bits``: carried [mats.ctx_bits] float32 raw-bit tail.
    Returns ``(yre[R, Pw], yim[R, Pw] | None, new_ctx, n_valid)`` where
    ``n_valid = (Nbits // B) * sps`` output samples live in the
    row-major flattening of the planes (trailing rows are padding when
    the symbol count is not a multiple of the row width).

    ``precision=None`` (default) runs the GEMM at
    ``lax.Precision.HIGH`` — XLA's single-op split-operand algorithm,
    cheaper than the f32 HIGHEST it replaces.  The data
    operand is raw {0,1} bits, EXACT in bfloat16, so only the tap
    matrix G carries split error (~2^-24 relative, ~6e-8 of sample
    scale — far inside the i16 LSB of 1.2e-4).  (A hand-rolled
    3-dot split was tried first and HALVED throughput: three dots
    traverse W three times and materialize three partials; HIGH keeps
    one operand read and on-chip passes.)  Pass an explicit
    ``lax.Precision`` to override.
    """
    bits = jnp.asarray(bits)
    B = mats.bits_per_sym
    S = mats.stride // B
    n_bits = bits.shape[0]
    if n_bits % B:
        raise ValueError(f"bit count {n_bits} not a multiple of {B}")
    syms = n_bits // B
    n_valid = syms * mats.sps
    R = -(-syms // S)                   # cdiv: GEMM rows

    ext = jnp.concatenate([jnp.asarray(ctx_bits, dtype=bits.dtype), bits])
    new_ctx = ext[-mats.ctx_bits:] if mats.ctx_bits else ctx_bits
    # Pad so every shifted-reshape piece is in range (fir.fir_block).
    last_off = mats.stride * ((mats.width - 1) // mats.stride)
    pad = last_off + R * mats.stride - ext.shape[0]
    xpad = jnp.pad(ext, (0, max(pad, 0)))
    W = _window_rows_strided(xpad, R, mats.stride, mats.width)
    prec = (lax.Precision.HIGH if precision is None
            and W.dtype == jnp.float32 else
            lax.Precision.HIGHEST if precision is None else precision)
    Y = jnp.dot(W, jnp.asarray(mats.G), preferred_element_type=W.dtype,
                precision=prec) - jnp.asarray(mats.off)[None, :]
    Pw = mats.samples_per_row
    if mats.planes == 1:
        return Y, None, new_ctx, n_valid
    return Y[:, :Pw], Y[:, Pw:], new_ctx, n_valid


class MixerTables(NamedTuple):
    """Host-precomputed planar mixer angle tables for one block shape."""

    cos_row: np.ndarray    # [R] cos(r*Pw*dphase mod 2pi)
    sin_row: np.ndarray
    cos_col: np.ndarray    # [Pw] cos(s*dphase mod 2pi)
    sin_col: np.ndarray
    adv: tuple             # fixed-point per-block phase advance


def mixer_tables(n_samples: int, dphase: float,
                 samples_per_row: int = 128) -> MixerTables:
    """Angle tables for mixing an ``[R, Pw]`` plane pair whose
    row-major flattening is the sample stream.  Host float64 (exact
    mod 2*pi at any block position), stored f32 — the error is the
    non-accumulating ~1e-7 rad of the final rounding."""
    d = np.float64(_mixer.normalize_dphase(dphase))
    Pw = int(samples_per_row)
    R = -(-int(n_samples) // Pw)
    ar = np.mod(np.arange(R, dtype=np.float64) * Pw * d, 2 * np.pi)
    bs = np.mod(np.arange(Pw, dtype=np.float64) * d, 2 * np.pi)
    return MixerTables(
        cos_row=np.cos(ar).astype(np.float32),
        sin_row=np.sin(ar).astype(np.float32),
        cos_col=np.cos(bs).astype(np.float32),
        sin_col=np.sin(bs).astype(np.float32),
        adv=_mixer.advance_fix(int(n_samples), dphase))


def mix_planar(yre, yim, pfix, tables: MixerTables):
    """Mix sample planes by ``exp(j*(phase0 + n*dphase))`` where n is
    the row-major sample index and ``phase0`` the carried fixed-point
    phase (:func:`comms_tpu.ops.mixer.phase_fix_init`).

    All trig comes from the host tables via angle addition:
    ``cos(p0 + ar + bs)`` from 2 device scalars and 4 outer products —
    full-lane VPU work, no transcendentals, no N-sized ramp constant.
    Returns ``(yre', yim', new_pfix)``.
    """
    phi0 = _mixer.phase_fix_to_angle(pfix)
    c0, s0 = jnp.cos(phi0), jnp.sin(phi0)
    car = jnp.asarray(tables.cos_row)[:, None]
    sar = jnp.asarray(tables.sin_row)[:, None]
    cbs = jnp.asarray(tables.cos_col)[None, :]
    sbs = jnp.asarray(tables.sin_col)[None, :]
    cab = car * cbs - sar * sbs         # cos(ar + bs)
    sab = sar * cbs + car * sbs         # sin(ar + bs)
    c = c0 * cab - s0 * sab             # cos(phi0 + ar + bs)
    s = s0 * cab + c0 * sab
    if yim is None:
        out_re, out_im = yre * c, yre * s
    else:
        out_re = yre * c - yim * s
        out_im = yre * s + yim * c
    return out_re, out_im, _mixer.add_fix(pfix, tables.adv)


def quantize_pack_iq(yre, yim, scale: float, n_valid: int):
    """Quantize planes to i16 (truncate toward zero, saturate — Rust
    ``as i16``) and pack each (re, im) pair into one int32 word
    ``(re & 0xffff) | (im << 16)``.

    The flat little-endian bytes of the result are interleaved i16
    re/im — the raw_iq.rs:1-5 file format — so the interleave costs
    one full-lane integer op instead of a [N, 2] relayout.  Use
    :func:`unpack_iq` on the host to view pairs.
    """
    scale = jnp.float32(scale)
    req = jnp.clip(jnp.trunc(yre * scale), -32768.0, 32767.0).astype(
        jnp.int32)
    if yim is None:
        imq = jnp.zeros_like(req)
    else:
        imq = jnp.clip(jnp.trunc(yim * scale), -32768.0, 32767.0).astype(
            jnp.int32)
    packed = (req & jnp.int32(0xFFFF)) | (imq << jnp.int32(16))
    return packed.reshape(-1)[:n_valid]


def unpack_iq(packed) -> np.ndarray:
    """Host view of packed int32 IQ as int16 pairs ``[N, 2]`` (re, im).
    Zero-copy reinterpretation; bytes match raw_iq.rs:1-5."""
    arr = np.ascontiguousarray(np.asarray(packed, dtype="<i4"))
    return arr.view("<i2").reshape(-1, 2)
