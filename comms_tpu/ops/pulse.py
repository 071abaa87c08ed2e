"""Pulse shaping: fused zero-stuff upsample + FIR, as a polyphase GEMM.

Functional parity with ``PulseNode`` (``/root/reference/src/pulse.rs:36-93``):
per input symbol, emit ``sps`` samples = FIR(symbol) then FIR(0) x
(sps-1), with FIR state persisting across symbols and blocks.

Design: filtering the zero-stuffed stream wastes (sps-1)/sps
of the multiply work on zeros.  The polyphase identity

    y[k*sps + p] = sum_m taps[m*sps + p] * sym[k - m]

turns the op into ONE dense GEMM on the *symbol-rate* stream:
``Y[k, p] = (W @ H)[k, p]`` with ``W`` the symbol window matrix
([K, M] rows of M = ceil(T/sps) past symbols, built with the same
shifted-reshape trick as :mod:`comms_tpu.ops.fir`) and ``H`` the
[M, sps] phase-major tap matrix.  Carried state = last M-1 symbols.
Output is identical to upsample+FIR whenever blocks hold whole
symbols (the reference's chains always do: bpsk example blocks are
4096 symbols, single_thread_bpsk.rs:26-40).
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp
from jax import lax

__all__ = [
    "polyphase_taps",
    "pulse_init_ctx",
    "pulse_shape_block",
    "pulse_shape_apply",
]


def polyphase_taps(taps, sps: int) -> np.ndarray:
    """1-D taps[T] -> phase matrix H[M, sps], H[m, p] = taps[m*sps+p]
    (zero-padded so M = ceil(T/sps))."""
    taps = np.asarray(taps)
    sps = int(sps)
    T = taps.shape[0]
    M = -(-T // sps)
    H = np.zeros((M, sps), dtype=taps.dtype)
    flat = np.zeros(M * sps, dtype=taps.dtype)
    flat[:T] = taps
    H[:, :] = flat.reshape(M, sps)
    return H


def pulse_init_ctx(num_taps: int, sps: int, dtype=jnp.complex64):
    """Zero symbol context of length M-1 (M = ceil(T/sps))."""
    M = -(-int(num_taps) // int(sps))
    return jnp.zeros((max(M - 1, 0),), dtype=dtype)


def _symbol_windows(sym_ext, rows: int, m: int):
    """W[r, j] = sym_ext[r + j] for j in [0, M) via shifted slices."""
    cols = [lax.dynamic_slice_in_dim(sym_ext, j, rows) for j in range(m)]
    return jnp.stack(cols, axis=1)


def pulse_shape_block(symbols, phase_taps, ctx):
    """Shape one block of symbols.  Returns ``(samples, new_ctx)`` with
    ``len(samples) == len(symbols) * sps``.

    ``phase_taps`` is the [M, sps] matrix from :func:`polyphase_taps`
    (flipped internally so the GEMM reads a causal window).
    """
    sym = jnp.asarray(symbols)
    H = jnp.asarray(phase_taps)
    M, sps = H.shape
    K = sym.shape[0]
    out_dtype = jnp.result_type(sym.dtype, H.dtype)
    if M == 1:
        y = (sym[:, None].astype(out_dtype) * H[0][None, :].astype(out_dtype))
        return y.reshape(K * sps), ctx

    sym_ext = jnp.concatenate([ctx.astype(sym.dtype), sym])  # [M-1 + K]
    new_ctx = sym_ext[-(M - 1):]
    # W[k, j] = sym_ext[k + j] = sym[k - (M-1-j)] -> pair with taps
    # H[M-1-j]: flip H's phase axis so Y = W @ flip(H).
    W = _symbol_windows(sym_ext, K, M)
    Y = jnp.dot(
        W.astype(out_dtype),
        jnp.flip(H, axis=0).astype(out_dtype),
        preferred_element_type=out_dtype,
        precision=lax.Precision.HIGHEST,
    )  # [K, sps]
    return Y.reshape(K * sps), new_ctx


def pulse_shape_apply(symbols, taps, sps: int):
    """One-shot convenience: zero initial context."""
    H = polyphase_taps(np.asarray(taps), sps)
    ctx = pulse_init_ctx(np.asarray(taps).shape[0], sps,
                         dtype=jnp.asarray(symbols).dtype)
    y, _ = pulse_shape_block(symbols, H, ctx)
    return y
