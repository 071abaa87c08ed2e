"""Fractional-delay interpolation and symbol-timing correction.

The reference stops at *estimating* timing (timing_estimator.rs) and
leaves correction to the user; a complete receiver needs to apply the
estimate.  ``fractional_delay`` implements a cubic-Lagrange
interpolating FIR — four taps computed from the fractional shift mu,
applied with the same banded machinery as every other FIR, so it runs
dense arithmetic and carries streaming state like any op.

``delay_signal(x, d)`` applies a total delay d = integer + fractional
(d >= 0 advances the estimator convention where estimate = -delay).
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

__all__ = ["lagrange_taps", "fractional_delay", "delay_signal"]


def lagrange_taps(mu: float) -> np.ndarray:
    """4-tap cubic Lagrange fractional-delay filter.

    Output y[n] = x interpolated at n - 1 - mu for mu in [0, 1): the
    filter's group delay is 1 + mu samples (the unavoidable +1 basepoint
    delay of a causal cubic).  Host-side float64.
    """
    mu = float(mu)
    if not 0.0 <= mu < 1.0:
        raise ValueError(f"mu must be in [0, 1), got {mu}")
    # Taps for basepoints x[n], x[n-1], x[n-2], x[n-3], interpolating
    # at delay 1 + mu from x[n] (i.e. between x[n-1] and x[n-2]).
    t = 1.0 + mu
    taps = np.empty(4, dtype=np.float64)
    pts = [0.0, 1.0, 2.0, 3.0]
    for k in range(4):
        num = 1.0
        den = 1.0
        for j in range(4):
            if j != k:
                num *= t - pts[j]
                den *= pts[k] - pts[j]
        taps[k] = num / den
    return taps


def fractional_delay(x, mu: float):
    """Delay ``x`` by 1 + mu samples (cubic Lagrange), zero-state.
    Output has the same length (tail truncated)."""
    from comms_tpu.ops import fir as _fir

    taps = lagrange_taps(mu)
    x = jnp.asarray(x)
    tp = taps.astype(np.complex64 if jnp.issubdtype(x.dtype,
                                                    jnp.complexfloating)
                     else np.float32)
    return _fir.fir_apply(x, tp)


def delay_signal(x, delay: float):
    """Apply a (possibly fractional) delay >= 0: integer part by
    shifting in zeros, fractional part by cubic interpolation (which
    itself adds 1 sample; accounted for here).  Zero-state, same
    length."""
    delay = float(delay)
    if delay < 0:
        raise ValueError("delay must be >= 0 (advance by slicing instead)")
    x = jnp.asarray(x)
    d_int = int(np.floor(delay))
    mu = delay - d_int
    if mu == 0.0:
        if d_int == 0:
            return x
        return jnp.concatenate([jnp.zeros(d_int, x.dtype), x[:-d_int]])
    # fractional_delay contributes 1 + mu; shift the remaining integer.
    y = fractional_delay(x, mu)
    rem = d_int - 1
    if rem > 0:
        y = jnp.concatenate([jnp.zeros(rem, x.dtype), y[:-rem]])
    elif rem < 0:  # delay < 1: advance by one sample
        y = jnp.concatenate([y[1:], jnp.zeros(1, x.dtype)])
    return y
