"""The whole FM receive chain in one Pallas kernel for NVIDIA GPUs
(Pallas through Triton).

    u8 IQ -> (x - 127.5) -> 63-tap FIR /5 -> quadrature demod
          -> 63-tap FIR /5 -> f32 audio

Functionally the polyphase path of ``models/fm_receiver.make_block_fn``
(the reference chain, fm_radio.rs:144-168).  The XLA chain writes and
re-reads the f32 complex input, the mid-rate stream and the demodulated
stream between its stages; here the interleaved u8 bytes are read once
and only the audio (1/25 of the input rate) is written.

Design:

* **Independent programs.**  Program ``p`` produces audio
  ``[p*BA, (p+1)*BA)``.  It recomputes its own halo from the raw
  bytes: 64 demod values before its first output, which need
  ``25*BA + 387`` input samples in all.  Nothing is carried between
  programs, so they run in any order on any SM.
* **Interleaved input.**  The u8 ``[N, 2]`` capture is viewed as u16
  words (re in the low byte), so one load feeds both planes; the
  bytes become floats by exponent-field arithmetic (:func:`_centered`).
* **Stage 1 on the tensor cores.**  Window rows of 256 inputs (160
  apart) times a banded tap matrix give 32 mids per row, plus a
  second band for each mid's lag, so the demod needs no shift of a
  register tensor (which Triton cannot express).  The window values
  ``raw - 127.5`` are exact in fp16, and the f32 taps ride as an fp16
  hi/lo pair (~2^-22 relative), accumulated in f32.  The conversion's
  ``/127.5`` is dropped: the demod's angle does not depend on scale.
* **Stage 2 on the CUDA cores** in f32 with the taps as constants: it
  reads the demod stream at stride 5, so each program writes its demod
  row to its own row of a scratch output, crosses a block barrier, and
  gathers it back.
* **Stream context** is the previous block's last ``CTX`` input
  samples as centred floats (``raw - 127.5``), so the stream start
  (all zero) is exact; program 0 alone reads it.

Tiles (``BA``, ``_CHUNK``, ``_WARPS``) are the fastest measured on an
H100 (PERF.md).
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from comms_tpu.ops import demodulation

__all__ = ["fm_chain_fused", "centered_ctx", "zero_ctx", "BLOCK_QUANTUM",
           "CTX"]

BA = 256                       # audio outputs per program
BLOCK_QUANTUM = 25 * BA        # input samples per program
CTX = 512                      # carried input samples (>= 5*_DHALO + 67)
_DHALO = 64                    # demod values before a program's first output
_NT = 63
_MC = 32                       # mids per window row (stage-1 dot columns)
_WIN = 256                     # window row width: 5*_MC + 67 <= _WIN
_WOFF = 72                     # window start before a row's first mid input
_SCALE = 4096.0                # tap scale for the fp16 hi/lo split
_CHUNK = 16                    # window rows per stage-1 dot
_WARPS = 4


def _centered(w):
    """u16 words (re | im << 8) -> (re - 127.5, im - 127.5) in f32,
    exactly.  A byte ``b`` placed at mantissa bits 15..22 under the
    exponent of 128.0 reads as ``128 + b/2``; one multiply-add then
    gives ``b - 127.5``."""
    w = w.astype(jnp.int32)
    one28 = jnp.int32(0x43000000)
    field = jnp.int32(0x7F8000)
    re = jax.lax.bitcast_convert_type(((w << 15) & field) | one28,
                                      jnp.float32)
    im = jax.lax.bitcast_convert_type(((w << 7) & field) | one28,
                                      jnp.float32)
    return re * 2.0 - 383.5, im * 2.0 - 383.5


def _band(taps, off):
    """Stage-1 band ``B[w, c] = taps[off + 5c - w]`` over a
    ``_WIN``-sample window and ``_MC`` mid columns (0 outside)."""
    w = np.arange(_WIN)[:, None]
    c = np.arange(_MC)[None, :]
    t = off + 5 * c - w
    ok = (t >= 0) & (t < _NT)
    return np.where(ok, np.asarray(taps, np.float64)[np.clip(t, 0, _NT - 1)],
                    0.0)


def _split_f16(band):
    """Scaled band as an fp16 (hi, lo) pair: hi + lo == band * 2^12 to
    ~2^-22 relative.  The 2^12 scale keeps the smallest taps' residuals
    out of fp16's subnormal range."""
    scaled = band * _SCALE
    hi = scaled.astype(np.float16)
    lo = (scaled - hi.astype(np.float64)).astype(np.float16)
    return hi, lo


def _window(x_ref, cre_ref, cim_ref, x0, n, rows, first):
    """``[rows, _WIN]`` fp16 window tiles (re, im) of ``raw - 127.5``:
    row ``r`` holds inputs ``x0 + 160 r + w``.  The values are
    half-integers, exact in fp16.  ``first`` (program 0's first rows
    only) takes indices < 0 from the carried context."""
    r = jax.lax.broadcasted_iota(jnp.int32, (rows, _WIN), 0)
    w = jax.lax.broadcasted_iota(jnp.int32, (rows, _WIN), 1)
    idx = x0 + 5 * _MC * r + w
    inside = (idx >= 0) & (idx < n)
    vre, vim = _centered(plgpu.load(x_ref.at[jnp.where(inside, idx, 0)],
                                    mask=inside, other=0))
    if first:
        before = idx < 0
        cidx = jnp.where(before, idx + CTX, 0)
        vre = jnp.where(before, plgpu.load(cre_ref.at[cidx], mask=before,
                                           other=0.0), vre)
        vim = jnp.where(before, plgpu.load(cim_ref.at[cidx], mask=before,
                                           other=0.0), vim)
    return vre.astype(jnp.float16), vim.astype(jnp.float16)


def _demod_rows(window, bands):
    """Demod values ``[rows, _MC]`` from window tiles: stage 1 (mid and
    its lag) as fp16 tensor-core dots with the taps as an fp16 hi/lo
    pair, then the quadrature demod."""
    are, aim = window

    def fir(a, hi, lo):
        return (jax.lax.dot(a, hi[...], preferred_element_type=jnp.float32)
                + jax.lax.dot(a, lo[...],
                              preferred_element_type=jnp.float32))

    bmh, bml, blh, bll = bands
    mre, mim = fir(are, bmh, bml), fir(aim, bmh, bml)
    lre, lim = fir(are, blh, bll), fir(aim, blh, bll)
    # d = arg(mid * conj(lag)), the same products and signed zeros as
    # demodulation.fm_demod_block (the common 2^12 * 127.5 scale of
    # mid and lag does not change the angle).
    zre = mre * lre + mim * lim
    zim = mim * lre - mre * lim
    return demodulation.fast_atan2(zim, zre)


def _rows():
    """Window rows each program computes: enough for its
    ``5*BA + _DHALO`` demod values, rounded up to whole chunks."""
    rows = -(-(5 * BA + _DHALO) // _MC)
    return -(-rows // _CHUNK) * _CHUNK


def _kernel(x_ref, cre_ref, cim_ref, bmh, bml, blh, bll, audio_ref, d_ref,
            *, h2, n, barrier):
    p = pl.program_id(0)
    ba, chunk = BA, _CHUNK
    bands = (bmh, bml, blh, bll)
    # window of mid row 0: mid m0 = 5*p*ba - _DHALO needs inputs from
    # 5*m0 - 67; _WOFF (>= 67, 8-aligned) leaves the window's start
    # 16-byte aligned.
    x0 = p * (25 * ba) - 5 * _DHALO - _WOFF
    r = jax.lax.broadcasted_iota(jnp.int32, (chunk, _MC), 0)
    c = jax.lax.broadcasted_iota(jnp.int32, (chunk, _MC), 1)
    for j in range(_rows() // chunk):
        xj = x0 + j * chunk * 5 * _MC

        def rows(first, xj=xj):
            return _demod_rows(
                _window(x_ref, cre_ref, cim_ref, xj, n, chunk, first), bands)

        if j == 0:     # only program 0's first rows reach before the block
            d = jax.lax.cond(p == 0, lambda: rows(True), lambda: rows(False))
        else:
            d = rows(False)
        d_ref[(j * chunk + r) * _MC + c] = d

    if barrier:   # the interpreter runs a program as one thread
        plgpu.debug_barrier()

    # stage 2: audio[k] = sum_t h2[t] d[5k - t]; slot of d[5k] is
    # 5a + _DHALO for a = k - p*ba.  Unrolled, so the 63 gathers are
    # independent and their latencies overlap.
    di = _DHALO + 5 * jax.lax.iota(jnp.int32, ba)
    acc = jnp.zeros((ba,), jnp.float32)
    for t in range(_NT):
        acc = acc + h2[t] * d_ref[di - t]
    audio_ref[...] = acc


def centered_ctx(iq_u8_tail):
    """Carried context from the last ``CTX`` raw ``[CTX, 2]`` u8
    samples: ``raw - 127.5`` as f32 planes ``[2, CTX]``."""
    return iq_u8_tail.astype(jnp.float32).T - 127.5


def zero_ctx():
    """Stream-start context: converted-domain zero."""
    return jnp.zeros((2, CTX), jnp.float32)


@functools.lru_cache(maxsize=None)
def _build(n: int, h1: tuple, h2: tuple, interpret: bool):
    """The jitted ``(words[n] u16, ctx[2, CTX]) -> audio[n/25]`` call
    for one block length and tap pair."""
    steps = n // BLOCK_QUANTUM
    lpad = 1 << (_rows() * _MC - 1).bit_length()
    bmh, bml = _split_f16(_band(h1, _WOFF))
    blh, bll = _split_f16(_band(h1, _WOFF - 5))
    bands = (bmh, bml, blh, bll)        # host constants of the program
    kernel = functools.partial(_kernel, h2=h2, n=n, barrier=not interpret)
    call = pl.pallas_call(
        kernel,
        grid=(steps,),
        in_specs=[pl.BlockSpec()] * 7,
        out_specs=[pl.BlockSpec((BA,), lambda p: (p,)),
                   pl.BlockSpec((None, lpad), lambda p: (p, 0))],
        out_shape=[jax.ShapeDtypeStruct((n // 25,), jnp.float32),
                   jax.ShapeDtypeStruct((steps, lpad), jnp.float32)],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="fm_chain",
    )

    @jax.jit
    def run(words, ctx):
        return call(words, ctx[0], ctx[1], *map(jnp.asarray, bands))[0]

    return run


def _taps63(taps):
    h = tuple(float(v) for v in np.asarray(taps, np.float32))
    if len(h) != _NT:
        raise ValueError(f"fused chain is specialized to {_NT}-tap filters")
    return h


def fm_chain_fused(iq_u8, ctx, taps1, taps2, interpret: bool = False):
    """Run the fused chain over one block.

    Args:
      iq_u8: ``[N, 2]`` uint8 interleaved IQ, ``N % BLOCK_QUANTUM == 0``.
      ctx: ``[2, CTX]`` f32 centred input tail preceding the block
        (:func:`centered_ctx`, or :func:`zero_ctx` at stream start).
      taps1, taps2: the two 63-tap low-pass filters (host arrays).
      interpret: run the Pallas interpreter (CPU tests).

    Returns audio ``[N/25]`` f32.
    """
    N = iq_u8.shape[0]
    if iq_u8.shape != (N, 2) or iq_u8.dtype != jnp.uint8:
        raise ValueError(f"need [N, 2] uint8 IQ, got {iq_u8.shape} "
                         f"{iq_u8.dtype}")
    if N == 0 or N % BLOCK_QUANTUM:
        raise ValueError(
            f"block {N} must be a positive multiple of {BLOCK_QUANTUM}")
    run = _build(N, _taps63(taps1), _taps63(taps2), bool(interpret))
    words = jax.lax.bitcast_convert_type(iq_u8, jnp.uint16)   # [N]
    return run(words, ctx)
