"""Streaming FIR filtering as a banded-Toeplitz GEMM.

Functional parity with the reference's direct-form FIR
(``/root/reference/src/filter/fir.rs:43-102`` — per-sample
``state.rotate_right(1); state[0]=x; sum(taps*state)``) — but instead
of an O(T) memmove per sample, a block of N
samples is filtered as a single matrix product

    Y[r, p] = sum_k taps[k] * xext[r*P + p - k + (T-1)]
            = (W @ B)[r, p]

where ``W`` is the windowed input ([R, T+P-1], rows overlapping by
T-1 samples, built from two shifted reshapes — no gather) and ``B`` is
the banded tap matrix ([T+P-1, P]), P=128 output phases per row; XLA
hands the product to its GEMM library and fuses the window build into
the operand read; complex inputs use XLA's native complex-matmul
decomposition.

Streaming semantics: the carried state is the last ``T-1`` input
samples (time-ordered, oldest first).  Output is independent of how
the stream is chopped into blocks — the exact property that makes
time-block sharding across devices correct (SURVEY.md section 5).

State mapping from the reference: its ``state`` vector holds past
inputs most-recent-first and its *last* element is shifted out before
ever contributing (fir.rs:51-53), so a reference state ``s`` maps to
``ctx = flip(s[:T-1])``; use :func:`ctx_from_reference_state`.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp
from jax import lax

__all__ = [
    "init_ctx",
    "ctx_from_reference_state",
    "banded_tap_matrix",
    "fir_block",
    "fir_apply",
    "fir_decimate_block",
    "decimating_branch_taps",
    "fir_decimate_poly",
    "fir_decimate_traced",
    "fir_decimate_traced_planar",
    "fir_decimate_traced_planar_complex",
    "fir_apply_planar",
    "poly_mac_frames",
    "piece_dots_accum",
]

# Output phases per GEMM row.
_DEFAULT_PHASES = 128


def init_ctx(num_taps: int, dtype=jnp.complex64):
    """Zero carried context (the reference's default zero state)."""
    return jnp.zeros((max(num_taps - 1, 0),), dtype=dtype)


def ctx_from_reference_state(state, dtype=jnp.complex64):
    """Convert a reference-style state vector (most-recent-first, length
    T, last element unused) into carried context (oldest-first, T-1)."""
    state = np.asarray(state)
    return jnp.asarray(state[: len(state) - 1][::-1], dtype=dtype)


def banded_tap_matrix(taps, phases: int = _DEFAULT_PHASES):
    """Banded Toeplitz matrix B[i, p] = taps[T-1+p-i] (0 outside band).

    Host-side (numpy): taps are parameters, computed once.
    """
    taps = np.asarray(taps)
    T = taps.shape[0]
    P = int(phases)
    i = np.arange(T + P - 1)[:, None]
    p = np.arange(P)[None, :]
    k = T - 1 + p - i
    valid = (k >= 0) & (k < T)
    B = np.where(valid, taps[np.clip(k, 0, T - 1)], 0)
    return B.astype(taps.dtype)


def _window_rows_strided(xpad, rows: int, stride: int, width: int):
    """Build W[r, i] = xpad[r*stride + i] for i < width from shifted
    reshapes (ceil(width/stride) of them) instead of a gather, so XLA
    fuses the window build into the GEMM operand read.  Requires
    len(xpad) >= (rows - 1)*stride + ceil(width/stride)*stride."""
    pieces = []
    off = 0
    while off < width:
        w = min(stride, width - off)
        chunk = lax.dynamic_slice_in_dim(xpad, off, rows * stride)
        pieces.append(chunk.reshape(rows, stride)[:, :w])
        off += w
    return jnp.concatenate(pieces, axis=1)


def _window_rows(xext, rows: int, phases: int, taps_len: int):
    """W[r, :] = xext[r*P : r*P + T+P-1] (row stride == piece width)."""
    return _window_rows_strided(xext, rows, phases, taps_len + phases - 1)


def fir_block(x, taps, ctx, phases: int = _DEFAULT_PHASES,
              precision=lax.Precision.HIGHEST):
    """Filter one block. Returns (y, new_ctx); y.shape == x.shape.

    ``taps`` may be a 1-D tap vector or a precomputed
    ``banded_tap_matrix`` (2-D) whose band length implies T.

    ``precision`` defaults to HIGHEST: an accelerator's default f32
    matmul mode rounds operands (TF32 on the GPU, ~1e-3 relative),
    while HIGHEST keeps parity with the Rust reference's f32 output.
    Pass ``lax.Precision.DEFAULT`` to trade accuracy for throughput.
    """
    x = jnp.asarray(x)
    N = x.shape[0]
    if isinstance(taps, (np.ndarray, jnp.ndarray)) and taps.ndim == 2:
        B = jnp.asarray(taps)
        P = B.shape[1]
        T = B.shape[0] - P + 1
    else:
        taps = np.asarray(taps)
        T = taps.shape[0]
        P = int(phases)
        B = jnp.asarray(banded_tap_matrix(taps, P))

    out_dtype = jnp.result_type(x.dtype, B.dtype)
    if T == 1:
        y = (x.astype(out_dtype) * B[0, 0]).astype(out_dtype)
        return y, ctx

    xext = jnp.concatenate([ctx.astype(x.dtype), x])  # [T-1 + N]
    new_ctx = xext[-(T - 1):]

    R = -(-N // P)  # cdiv
    # Each shifted-reshape piece reads xpad[off : off + R*P] with off up
    # to P*floor((T+P-2)/P); pad so the last piece is in range (otherwise
    # dynamic_slice clamps the start and reads shifted data).
    width = T + P - 1
    last_off = P * ((width - 1) // P)
    pad = last_off + R * P - xext.shape[0]
    xpad = jnp.pad(xext, (0, max(pad, 0)))
    if jnp.iscomplexobj(x) and not jnp.iscomplexobj(B):
        # Real taps on complex data: two real GEMMs on the re/im
        # planes (B is shared) instead of a complex GEMM with a zero
        # imaginary operand — half the multiply work.
        Wr = _window_rows(jnp.real(xpad), R, P, T)
        Wi = _window_rows(jnp.imag(xpad), R, P, T)
        Br = B.astype(Wr.dtype)
        Y = lax.complex(
            jnp.dot(Wr, Br, preferred_element_type=Wr.dtype,
                    precision=precision),
            jnp.dot(Wi, Br, preferred_element_type=Wr.dtype,
                    precision=precision))
    else:
        W = _window_rows(xpad, R, P, T)  # [R, T+P-1]
        Y = jnp.dot(
            W.astype(out_dtype), B.astype(out_dtype),
            preferred_element_type=out_dtype, precision=precision,
        )  # [R, P]
    y = Y.reshape(R * P)[:N]
    return y, new_ctx


def fir_apply_planar(xr, xi, B, phases: int = _DEFAULT_PHASES,
                     precision=lax.Precision.HIGHEST):
    """Real-tap FIR on re/im PLANES with zero initial context:
    ``(yr, yi)`` planes out, never materializing complex64.  ``B`` is
    a real ``banded_tap_matrix`` (2-D).  The planar twin of
    ``fir_apply`` for pipelines that keep the signal planar
    end-to-end."""
    B = jnp.asarray(B)
    P = B.shape[1]
    T = B.shape[0] - P + 1
    N = xr.shape[0]
    if T == 1:
        return xr * B[0, 0], xi * B[0, 0]
    R = -(-N // P)
    width = T + P - 1
    last_off = P * ((width - 1) // P)
    pad_tail = max(last_off + R * P - (T - 1 + N), 0)
    Br = B.astype(xr.dtype)
    outs = []
    for plane in (xr, xi):
        xpad = jnp.pad(plane, (T - 1, pad_tail))
        W = _window_rows(xpad, R, P, T)
        Y = jnp.dot(W, Br, preferred_element_type=plane.dtype,
                    precision=precision)
        outs.append(Y.reshape(R * P)[:N])
    return outs[0], outs[1]


def fir_apply(x, taps, phases: int = _DEFAULT_PHASES):
    """Stateless FIR with zero initial context (one-shot convenience)."""
    taps_arr = np.asarray(taps) if not hasattr(taps, "ndim") else taps
    T = taps_arr.shape[0] if taps_arr.ndim == 1 else taps_arr.shape[0] - taps_arr.shape[1] + 1
    ctx = init_ctx(T, dtype=jnp.result_type(jnp.asarray(x).dtype))
    y, _ = fir_block(x, taps, ctx, phases=phases)
    return y


def fir_decimate_block(x, taps, ctx, rate: int, phases: int = _DEFAULT_PHASES):
    """Fused FIR + keep-every-``rate``-th-sample (per-block phase reset,
    matching DecimateNode semantics, resample_node.rs:53-65).

    Reference convenience form; :func:`fir_decimate_poly` is the
    efficient polyphase version for the hot path.
    """
    y, new_ctx = fir_block(x, taps, ctx, phases=phases)
    if rate in (0, 1):
        return y, new_ctx
    return y[::rate], new_ctx


def decimating_branch_taps(taps, rate: int) -> np.ndarray:
    """taps[T] -> C[M, rate] with C[k-1, c] = taps[k*rate - 1 - c]
    (zero where out of range), M = ceil(T/rate).  Host-side.

    The within-row reversal lives HERE (free, on taps) instead of as a
    device-side ``reverse`` of the data — XLA materializes flips of
    big arrays, which measured as the FM chain's dominant temp cost.
    """
    taps = np.asarray(taps)
    D = int(rate)
    M = -(-taps.shape[0] // D)
    flat = np.zeros(M * D, dtype=taps.dtype)
    flat[: taps.shape[0]] = taps
    C = np.zeros((M, D), dtype=taps.dtype)
    for k in range(1, M + 1):
        for c in range(D):
            C[k - 1, c] = flat[k * D - 1 - c]
    return C


def _decimating_banded_matrix(flat_taps: np.ndarray, rate: int,
                              phases: int) -> np.ndarray:
    """B2[i, p] = flat[p*D + M*D-1 - i] (0 outside the band): the
    decimating analogue of :func:`banded_tap_matrix`, columns strided
    by D so the GEMM produces ONLY the kept outputs.  Host-side."""
    D, P = int(rate), int(phases)
    MD = flat_taps.shape[0]
    width = (P - 1) * D + MD
    i = np.arange(width)[:, None]
    p = np.arange(P)[None, :]
    t = p * D + MD - 1 - i
    valid = (t >= 0) & (t < MD)
    return np.where(valid, flat_taps[np.clip(t, 0, MD - 1)],
                    0).astype(flat_taps.dtype)


def fir_decimate_poly(x, Hb, ctx, phases: int = _DEFAULT_PHASES,
                      precision=lax.Precision.HIGHEST):
    """Polyphase decimating FIR: computes ONLY the kept outputs.

        y[m] = sum_t taps[t] * x[m*D - t]

    ``Hb = C`` is the host-prepared [M, D] coefficient matrix from
    :func:`decimating_branch_taps`; ``ctx`` is the carried input tail
    of M*D - 1 samples.  len(x) % D == 0.  Returns ``(y[N//D],
    new_ctx)``.

    Implementation: a banded GEMM whose output phases stride by D —
    W[r, i] = xe[r*P*D + i] (shifted reshapes, no gather) against
    B2[i, p] = flat_taps[p*D + M*D-1 - i], so 128 kept outputs come
    from one [., (P-1)*D + M*D] x [., P] matrix product.  The
    per-branch elementwise formulation (:func:`poly_mac_frames`) keeps
    the minor dimension at D elements.  Real taps with complex input run as two
    real GEMMs (re/im planes share the B2 operand).

    Output parity: identical to ``fir_block`` + ``[::D]`` when the
    block length divides D (both implement DecimateNode's keep-index-0
    convention, resample_node.rs:53-65).
    """
    x = jnp.asarray(x)
    C = np.asarray(Hb)               # host-side coefficients
    M, D = C.shape
    N = x.shape[0]
    if N % D:
        raise ValueError(f"block {N} not a multiple of rate {D}")
    frames = N // D
    T_pad = M * D
    # Invert decimating_branch_taps: C[k-1, c] = flat[k*D - 1 - c].
    flat = np.zeros(T_pad, dtype=C.dtype)
    for k in range(1, M + 1):
        for c in range(D):
            flat[k * D - 1 - c] = C[k - 1, c]
    P = int(phases)
    B2 = jnp.asarray(_decimating_banded_matrix(flat, D, P))
    width = (P - 1) * D + T_pad

    xe = jnp.concatenate([ctx.astype(x.dtype), x])   # [T_pad - 1 + N]
    new_ctx = xe[-(T_pad - 1):] if T_pad > 1 else ctx
    y = _decimate_gemm_core(xe, B2, D, P, frames, width, precision)
    return y, new_ctx


def _decimate_gemm_core(xe, B2, D: int, P: int, frames: int,
                        width: int, precision):
    """Strided-window banded GEMM shared by the host-taps and
    traced-taps decimators: returns ``y[frames]`` with
    ``y[m] = sum_i xe[m*D + i] * B2_column_phase(m % P)`` (see
    :func:`_decimating_banded_matrix` for the band layout)."""
    R = -(-frames // P)  # cdiv
    stride = P * D
    last_off = stride * ((width - 1) // stride)
    pad = last_off + R * stride - xe.shape[0]
    xpad = jnp.pad(xe, (0, max(pad, 0)))

    out_dtype = jnp.result_type(xe.dtype, B2.dtype)
    if jnp.iscomplexobj(xe) and not jnp.iscomplexobj(B2):
        Wr = _window_rows_strided(jnp.real(xpad), R, stride, width)
        Wi = _window_rows_strided(jnp.imag(xpad), R, stride, width)
        B2r = B2.astype(Wr.dtype)
        Y = lax.complex(
            jnp.dot(Wr, B2r, preferred_element_type=Wr.dtype,
                    precision=precision),
            jnp.dot(Wi, B2r, preferred_element_type=Wr.dtype,
                    precision=precision))
    else:
        W = _window_rows_strided(xpad, R, stride, width)
        Y = jnp.dot(W.astype(out_dtype), B2.astype(out_dtype),
                    preferred_element_type=out_dtype, precision=precision)
    return Y.reshape(R * P)[:frames]


def fir_decimate_traced(x, flat_taps, rate: int, tail_zeros: int = 0,
                        phases: int = _DEFAULT_PHASES,
                        precision=lax.Precision.HIGHEST):
    """Polyphase decimating FIR whose taps are a TRACED device vector:

        y[m] = sum_t flat_taps[t] * x[m*D - t],  m in [0, (N+Z)//D)

    with ``x`` zero-extended at both ends (head: ``flat`` reaching
    before sample 0; tail: ``tail_zeros`` extra zero samples so late
    output frames exist).  The only traced-shape work is one tiny
    gather building the [width, P] banded matrix from ``flat_taps``
    (everything downstream is the same strided-window GEMM as
    :func:`fir_decimate_poly`).

    Exists for receivers whose tap vector depends on traced estimates
    — e.g. qpsk_rx folds its cubic-Lagrange interpolator, the traced
    integer timing shift AND the symbol-phase pick into one such
    decimating GEMM (a traced ``jnp.roll`` of the full-rate block
    would be a whole extra full-rate pass).
    """
    x = jnp.asarray(x)
    B2, D, P, frames, width = _traced_band_setup(
        flat_taps, int(x.shape[0]), rate, tail_zeros, phases)
    MD = int(jnp.asarray(flat_taps).shape[0])
    xe = jnp.concatenate(
        [jnp.zeros((MD - 1,), x.dtype), x])  # zero head context
    return _decimate_gemm_core(xe, B2, D, P, frames, width, precision)


def _traced_band_setup(flat_taps, N: int, rate: int, tail_zeros: int,
                       phases: int):
    """Shared validation + traced banded matrix for the traced-tap
    decimators.  B2[i, p] = flat[p*D + MD-1 - i] (0 outside the band)
    via one small gather against a host index matrix (out-of-band ->
    the appended zero)."""
    flat_taps = jnp.asarray(flat_taps)
    D, P = int(rate), int(phases)
    MD = int(flat_taps.shape[0])
    if MD % D:
        raise ValueError(f"flat_taps length {MD} must be a multiple of "
                         f"rate {D}")
    Z = int(tail_zeros)
    if (N + Z) % D:
        raise ValueError(f"block {N} + tail_zeros {Z} not a multiple "
                         f"of rate {D}")
    frames = (N + Z) // D
    width = (P - 1) * D + MD
    i = np.arange(width)[:, None]
    p = np.arange(P)[None, :]
    t = p * D + MD - 1 - i
    idx = np.where((t >= 0) & (t < MD), t, MD)
    flat_e = jnp.concatenate(
        [flat_taps, jnp.zeros((1,), flat_taps.dtype)])
    B2 = flat_e[jnp.asarray(idx)]
    return B2, D, P, frames, width


def fir_decimate_traced_planar(xr, xi, flat_taps, rate: int,
                               tail_zeros: int = 0,
                               phases: int = _DEFAULT_PHASES,
                               precision=lax.Precision.HIGHEST):
    """Planar twin of :func:`fir_decimate_traced` (real traced taps on
    re/im planes): returns ``(yr, yi)`` frame planes, never
    materializing complex64."""
    (yr,), (yi,) = _dec_traced_planar_core(
        xr, xi, (flat_taps,), rate, tail_zeros, phases, precision)
    return yr, yi


def fir_decimate_traced_planar_complex(xr, xi, flat_re, flat_im,
                                       rate: int, tail_zeros: int = 0,
                                       phases: int = _DEFAULT_PHASES,
                                       precision=lax.Precision.HIGHEST,
                                       ctx=None):
    """Complex traced taps on re/im planes:

        y[m] = sum_t (flat_re + j*flat_im)[t] * (xr + j*xi)[m*D - t]

    Four real decimating GEMMs sharing the same window operands (the
    windows — the expensive part, pure-reshape reads of the planes —
    are built once per plane per piece).  Exists so a traced carrier
    de-rotation can fold INTO the tap vector (x*e^{-jwk} filtered by
    flat == e^{-jw m D} * (flat*e^{jwt} applied to raw x)): qpsk_rx's
    full-rate stages then depend only on the RAW planes, and the
    panel->scalar->full-rate scheduling stall (measured +1.8 ms per
    coupled full-rate stage at 33.5M samples) disappears.

    ``ctx``: optional carried ``(ctx_re, ctx_im)`` planes of MD-1
    samples replacing the zero head extension — the streaming form
    (negative-index reads see the previous block's tail, so block
    seams are exact).  NOTE: a zero pad fuses into the window reads
    but concatenating real context materializes a full plane copy
    (measured 1.1 -> 3.0 ms at 33.5M samples); hot streaming callers
    should instead run with the zero head and PATCH the few affected
    head outputs from a small recompute (see
    qpsk_rx._fused_symbol_gemm).  Returns ``(yr, yi)``."""
    (rr, ri), (ir_, ii) = _dec_traced_planar_core(
        xr, xi, (flat_re, flat_im), rate, tail_zeros, phases, precision,
        ctx=ctx)
    # (xr + j xi)(cr + j ci): re = xr*cr - xi*ci, im = xr*ci + xi*cr
    return rr - ii, ri + ir_


def piece_dots_accum(xpad, Bs, R: int, stride: int, width: int,
                     precision):
    """Shared banded-GEMM core: per-piece dots on shifted reshapes of
    ``xpad`` (each full-stride piece is a PURE reshape XLA fuses into
    the GEMM operand read — a concatenated [R, width] window
    materializes, PERF lesson 9 at the XLA level), against one or
    more band matrices sharing the window.  Returns one [R, P]
    accumulator per matrix in ``Bs``.  Used by the traced decimators
    here and the channelizer's branch GEMM."""
    dtype = xpad.dtype
    Ys = [None] * len(Bs)
    off = 0
    while off < width:
        w = min(stride, width - off)
        chunk = lax.dynamic_slice_in_dim(xpad, off, R * stride)
        Wp = chunk.reshape(R, stride)[:, :w]
        for i, B in enumerate(Bs):
            t = jnp.dot(Wp, B[off:off + w].astype(dtype),
                        preferred_element_type=dtype,
                        precision=precision)
            Ys[i] = t if Ys[i] is None else Ys[i] + t
        off += w
    return Ys


def _dec_traced_planar_core(xr, xi, flats, rate, tail_zeros, phases,
                            precision, ctx=None):
    """Shared window machinery: for each plane p and tap vector f,
    compute the decimating GEMM Y[p][f], reading each plane's windows
    ONCE per piece.  Returns ``tuple_per_plane(tuple_per_flat)``.

    Per-piece dots instead of concat-then-dot: the full-stride piece
    is a PURE reshape XLA fuses into the GEMM operand read, while the
    concatenated [R, width] window materializes (measured 5.5 ->
    4.1 ms at 33M samples, D=4, HIGH)."""
    setups = [_traced_band_setup(f, int(xr.shape[0]), rate, tail_zeros,
                                 phases) for f in flats]
    B2s = [s[0] for s in setups]
    _, D, P, frames, width = setups[0]
    MD = int(jnp.asarray(flats[0]).shape[0])
    R = -(-frames // P)
    stride = P * D
    last_off = stride * ((width - 1) // stride)
    pad = max(last_off + R * stride - (MD - 1 + xr.shape[0]), 0)
    if ctx is not None and int(jnp.asarray(ctx[0]).shape[0]) != MD - 1:
        raise ValueError(f"ctx must be MD-1 = {MD - 1} samples, got "
                         f"{jnp.asarray(ctx[0]).shape[0]}")
    outs = []
    for pi, plane in enumerate((xr, xi)):
        if ctx is None:
            xpad = jnp.pad(plane, (MD - 1, pad))
        else:
            xpad = jnp.concatenate(
                [jnp.asarray(ctx[pi], plane.dtype), plane,
                 jnp.zeros((pad,), plane.dtype)])
        # One window per piece, one [.., P] dot per tap matrix on it
        # (a [width, n*P] concatenated-B2 dot reads the window once
        # too, but measured 2.4x SLOWER — 2.50 vs 1.03 ms at 33.5M
        # samples, D=4 — the 256-wide output tiles worse).
        Ys = piece_dots_accum(xpad, B2s, R, stride, width, precision)
        outs.append(tuple(Y.reshape(R * P)[:frames] for Y in Ys))
    return outs[0], outs[1]


def poly_mac_frames(x, C, ctx):
    """Shared polyphase MAC core: returns the per-column accumulator
    ``V[frames, D] = sum_k C[k-1, :] * G[m + M - k, :]`` (the
    decimating FIR sums it over columns; the channelizer FFTs it).
    Returns ``(V, new_ctx)``."""
    x = jnp.asarray(x)
    C = jnp.asarray(C)
    M, D = C.shape
    N = x.shape[0]
    if N % D:
        raise ValueError(f"block {N} not a multiple of rate {D}")
    frames = N // D
    T_pad = M * D

    xe = jnp.concatenate([ctx.astype(x.dtype), x])  # [T_pad - 1 + N]
    new_ctx = xe[-(T_pad - 1):] if T_pad > 1 else ctx
    # G[i, c] = xe[i*D + c], rows i in [0, frames + M - 1).
    R = frames + M - 1
    G = xe[: R * D].reshape(R, D)
    acc = jnp.zeros((frames, D), dtype=jnp.result_type(x.dtype, C.dtype))
    for k in range(1, M + 1):
        acc = acc + C[k - 1][None, :] * G[M - k: M - k + frames]
    return acc, new_ctx
