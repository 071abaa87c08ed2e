"""Critically-sampled polyphase DFT-filterbank channelizer.

The reference has no channelizer; this op fulfils the BASELINE config
"64-channel polyphase channelizer: FFT-based channelization, channels
sharded across chips" and is the EP-analogue of the framework
(SURVEY.md section 2.4): channel k's stream equals

    y_k[m] = decimate_K( FIR(h, x * exp(-j*2*pi*k*n/K)) )[m]
           = sum_n h[n] * x[m*K - n] * exp(+j*2*pi*k*n/K)

computed for ALL K channels at once via the polyphase decomposition:
branch filters v[m, p] = sum_j h[j*K+p] * x[(m-j)*K - p], then a
length-K DFT across the branch axis.

Formulation: BOTH stages are GEMMs (branch MACs run elementwise on
[frames, K] arrays would use K of every 128 lanes) —

* the branch stage is a banded GEMM over the FLATTENED output stream:
  with o = m*K + c,  V_flat[o] = sum_k C[k-1, o mod K] *
  xe[o + (M-k)*K], so 128 consecutive outputs (P = lcm-ish multiple
  of K near 128) come from one [., (M-1)*K + P] x [., P] product
  whose windows are shifted reshapes (no gather) — the same trick as
  :func:`comms_tpu.ops.fir.fir_decimate_poly`;
* the K-point DFT is a [frames, K] x [K, K] matmul against a host-
  precomputed DFT matrix with the branch-reversal fix-up phase folded
  in (for K <= 256; larger K falls back to the batched FFT).

The within-row tap reversal is folded into the host-side coefficient
matrix (a device-side flip materializes a copy), and the branch
reversal c = K-1-p folds into the DFT
direction plus a constant per-channel phase e^{-2i pi ch / K}:

    y[m, ch] = e^{-2i pi ch / K} * FFT_c(V[m, :])[ch]

Carried state: the last T-1 input samples (identical halo shape to
the streaming FIR, so time-sharding uses the same ppermute exchange).

Prototype filter: any lowpass with cutoff ~pi/K; :func:`design_prototype`
gives a windowed-sinc (Hamming), computed on host in float64.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp
from jax import lax

from comms_tpu.ops import fir as _fir

__all__ = [
    "design_prototype",
    "branch_taps",
    "channelizer_init_ctx",
    "channelize_block",
    "channelize_block_planar",
    "channelize_oracle",
]


def design_prototype(num_channels: int, taps_per_branch: int) -> np.ndarray:
    """Hamming-windowed sinc lowpass, cutoff 1/(2K), unit DC gain,
    length K * taps_per_branch (host, float64)."""
    K, M = int(num_channels), int(taps_per_branch)
    T = K * M
    n = np.arange(T, dtype=np.float64) - (T - 1) / 2.0
    h = np.sinc(n / K)
    h *= np.hamming(T)
    return h / h.sum()


def branch_taps(prototype, num_channels: int) -> np.ndarray:
    """h[T] -> coefficient matrix [M, K] for :func:`channelize_block`
    (tap reversal pre-applied; see module docstring).  T must be a
    multiple of K."""
    h = np.asarray(prototype)
    K = int(num_channels)
    if h.shape[0] % K:
        raise ValueError(f"prototype length {h.shape[0]} not a multiple "
                         f"of num_channels {K}")
    return _fir.decimating_branch_taps(h, K)


def channelizer_init_ctx(prototype_len: int, dtype=jnp.complex64):
    """Zero carried context of T-1 input samples."""
    return jnp.zeros((int(prototype_len) - 1,), dtype=dtype)


def _branch_phases(K: int) -> int:
    """Output phases per GEMM row: the multiple of K nearest 128 (the
    band construction needs K | P so the coefficient
    of output o depends only on o mod P)."""
    return K * max(1, 128 // K)


def _branch_banded_matrix(C: np.ndarray, phases: int) -> np.ndarray:
    """B[i, p] = C[k-1, p % K] at i = p + (M-k)*K (0 elsewhere): the
    channelizer analogue of :func:`comms_tpu.ops.fir.
    _decimating_banded_matrix` — one GEMM row of the flattened output
    stream covers P outputs, V_flat[r*P + p] = sum_i xe[r*P + i] *
    B[i, p].  Host-side."""
    C = np.asarray(C)
    M, K = C.shape
    P = int(phases)
    if P % K:
        raise ValueError(f"phases {P} must be a multiple of K={K}")
    width = (M - 1) * K + P
    i = np.arange(width)[:, None]
    p = np.arange(P)[None, :]
    j = i - p                       # = (M-k)*K for the valid band
    valid = (j >= 0) & (j % K == 0) & (j // K < M)
    krow = np.where(valid, M - 1 - np.minimum(j // K, M - 1), 0)
    return np.where(valid, np.asarray(C)[krow, p % K], 0).astype(C.dtype)


def _branch_gemm_plane(xpad, B, R: int, P: int, width: int, precision):
    """One real plane through the banded branch GEMM (the shared
    per-piece shifted-reshape core, :func:`comms_tpu.ops.fir.
    piece_dots_accum`).  Returns rows [R, P]."""
    return _fir.piece_dots_accum(xpad, [B], R, P, width, precision)[0]


def _dft_fix_matrix(K: int, dtype) -> np.ndarray:
    """[K, K] matrix F with y[m, ch] = (V @ F)[m, ch] — the K-point
    DFT across branches WITH the branch-reversal fix-up phase folded
    in: F[c, ch] = e^{-2i pi ch (c+1) / K}.  Host-side f64."""
    c = np.arange(K)[:, None]
    ch = np.arange(K)[None, :]
    return np.exp(-2j * np.pi * ch * (c + 1) / K).astype(dtype)


def _dft_blockdiag_matrix(K: int, P: int) -> np.ndarray:
    """[P, P] block-diagonal stack of P//K copies of the DFT+fix
    matrix: applies the branch DFT to every frame of a [R, P] GEMM
    row AT ONCE — full 128-wide rows and no [frames, K]
    relayout between the branch GEMM and the DFT (the separate
    [., K] x [K, K] matmul ran at K/128 lane utilization).
    Host-side f64."""
    F = _dft_fix_matrix(K, np.complex128)
    reps = P // K
    BD = np.zeros((P, P), np.complex128)
    for j in range(reps):
        BD[j * K:(j + 1) * K, j * K:(j + 1) * K] = F
    return BD


def _channelize_planar_core(re, im, C, ctx_re, ctx_im,
                            precision=lax.Precision.HIGHEST):
    """Both stages on re/im PLANES: banded branch GEMM -> block-
    diagonal DFT matmul on the SAME [R, P] row layout (reshaped to
    [frames, K] only at the very end).  Returns
    ``(yr[frames, K], yi[frames, K], new_ctx_re, new_ctx_im)``."""
    C = np.asarray(C)
    M, K = C.shape
    N = int(re.shape[0])
    if N % K:
        raise ValueError(f"block {N} not a multiple of channels {K}")
    frames = N // K
    if K > _DFT_MATMUL_MAX_K:
        # Large-K fallback: the banded branch GEMM executes ~M*K MACs
        # per sample (band density 1/K) — past the DFT cutover the
        # old M-MAC per-branch form + batched FFT is strictly
        # cheaper.
        x = lax.complex(re, im)
        ctx = lax.complex(ctx_re.astype(re.dtype),
                          ctx_im.astype(im.dtype))
        V, nctx = _fir.poly_mac_frames(x, C, ctx)
        y = jnp.fft.fft(V, axis=1)
        ch = np.arange(K)
        fix = np.exp(-2j * np.pi * ch / K)
        y = y * jnp.asarray(fix, dtype=y.dtype)
        return (jnp.real(y), jnp.imag(y),
                jnp.real(nctx), jnp.imag(nctx))
    P = _branch_phases(K)
    width = (M - 1) * K + P
    B = jnp.asarray(_branch_banded_matrix(C, P))
    R = -(-N // P)                   # cdiv over flattened outputs
    last_off = P * ((width - 1) // P)
    Tm1 = M * K - 1
    pad = max(last_off + R * P - (Tm1 + N), 0)
    rows = []
    for plane, ctx in ((re, ctx_re), (im, ctx_im)):
        xpad = jnp.concatenate(
            [ctx.astype(plane.dtype), plane,
             jnp.zeros((pad,), plane.dtype)])
        rows.append(_branch_gemm_plane(xpad, B, R, P, width, precision))
    Vr, Vi = rows
    nre = jnp.concatenate([ctx_re.astype(re.dtype), re])[-Tm1:]
    nim = jnp.concatenate([ctx_im.astype(im.dtype), im])[-Tm1:]

    if K <= _DFT_MATMUL_MAX_K:
        BD = _dft_blockdiag_matrix(K, P)
        BDr = jnp.asarray(BD.real.astype(Vr.dtype))
        BDi = jnp.asarray(BD.imag.astype(Vr.dtype))
        kw = dict(preferred_element_type=Vr.dtype, precision=precision)
        Yr = jnp.dot(Vr, BDr, **kw) - jnp.dot(Vi, BDi, **kw)
        Yi = jnp.dot(Vr, BDi, **kw) + jnp.dot(Vi, BDr, **kw)
    else:  # large K: batched FFT beats the K-MAC/sample DFT matmul
        V = lax.complex(Vr.reshape(R * P)[:N].reshape(frames, K),
                        Vi.reshape(R * P)[:N].reshape(frames, K))
        y = jnp.fft.fft(V, axis=1)
        ch = np.arange(K)
        fix = np.exp(-2j * np.pi * ch / K)
        y = y * jnp.asarray(fix, dtype=y.dtype)
        return jnp.real(y), jnp.imag(y), nre, nim
    yr = Yr.reshape(R * P)[:N].reshape(frames, K)
    yi = Yi.reshape(R * P)[:N].reshape(frames, K)
    return yr, yi, nre, nim


# DFT-by-matmul cutover: above this K the batched FFT wins (K MACs vs
# log K per sample).
_DFT_MATMUL_MAX_K = 256


def channelize_block(x, Hb, ctx):
    """Channelize one block.

    Args:
      x: [N] complex, N % K == 0.
      Hb: [M, K] branch-tap matrix from :func:`branch_taps`.
      ctx: carried [M*K - 1] input tail.

    Returns ``(y[N//K, K], new_ctx)`` — frame m, channel k.
    """
    x = jnp.asarray(x)
    C = np.asarray(Hb)
    M, K = C.shape
    out_dtype = jnp.result_type(x.dtype, jnp.complex64)
    real_dtype = jnp.real(jnp.zeros(0, out_dtype)).dtype
    if jnp.iscomplexobj(x):
        re, im = jnp.real(x), jnp.imag(x)
        cre, cim = jnp.real(ctx), jnp.imag(ctx)
    else:
        re, im = x, jnp.zeros_like(x)
        cre, cim = ctx, jnp.zeros_like(ctx)
    yr, yi, nre, nim = _channelize_planar_core(
        re.astype(real_dtype), im.astype(real_dtype),
        C, cre.astype(real_dtype), cim.astype(real_dtype))
    new_ctx = lax.complex(nre, nim).astype(ctx.dtype)
    return lax.complex(yr, yi).astype(out_dtype), new_ctx


def channelize_block_planar(re, im, Hb, ctx_re, ctx_im):
    """Plane-native :func:`channelize_block`: f32 re/im planes in,
    ``(yr[frames, K], yi[frames, K], new_ctx_re, new_ctx_im)`` out —
    no complex64 materialization anywhere (the serving-ingest layout;
    complex cannot cross the host<->device boundary on this runtime).
    """
    return _channelize_planar_core(re, im, np.asarray(Hb),
                                   ctx_re, ctx_im)


def channelize_oracle(x, prototype, num_channels: int) -> np.ndarray:
    """Direct per-channel mix->FIR->decimate oracle (float64 host).
    For tests: must equal :func:`channelize_block` from zero context."""
    x = np.asarray(x, dtype=np.complex128)
    h = np.asarray(prototype, dtype=np.float64)
    K = int(num_channels)
    N = len(x)
    out = np.zeros((N // K, K), dtype=np.complex128)
    n = np.arange(N)
    for k in range(K):
        z = x * np.exp(-2j * np.pi * k * n / K)
        w = np.convolve(z, h)[:N]  # causal FIR, zero initial state
        out[:, k] = w[::K][: N // K]
    return out
