"""Automatic gain control.

Beyond the reference (real receivers need amplitude normalization
before QAM decisions; the reference's only AGC is the rtl-sdr
hardware flag, rtlsdr_radio.rs:31-34).  Two forms:

* ``agc_block`` — feedforward block AGC: one gain per block from the
  block's RMS, smoothed across blocks with a one-pole carried state.
  Fully parallel (two reductions), the right shape for block streaming.
* ``agc_scan`` — classic per-sample loop AGC (log-domain error,
  ``lax.scan``) for parity with textbook tracking behavior when
  per-sample adaptation matters; keep off the hot path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["agc_init", "agc_block", "agc_scan"]


def agc_init(gain: float = 1.0):
    """Carried smoothed gain (f32 scalar)."""
    return jnp.float32(gain)


def agc_block(x, gain, target_rms: float = 1.0, alpha: float = 0.5,
              eps: float = 1e-12):
    """Feedforward AGC over one block.

    g_block = target / rms(x); carried gain is the one-pole smoothing
    ``g' = (1-alpha) * g + alpha * g_block``; the block is scaled by
    the smoothed gain.  Returns ``(y, g')``.
    """
    x = jnp.asarray(x)
    rms = jnp.sqrt(jnp.mean(jnp.abs(x) ** 2) + eps)
    g_blk = jnp.float32(target_rms) / rms.astype(jnp.float32)
    g = (1.0 - alpha) * gain + alpha * g_blk
    return x * g.astype(x.real.dtype), g


def agc_scan(x, gain, target_rms: float = 1.0, rate: float = 1e-2):
    """Per-sample log-domain AGC: ``g *= exp(rate * log(target/|y|))``.

    Irreducibly sequential -> ``lax.scan`` (SURVEY.md section 7's
    recurrence class).  Returns ``(y, final_gain)``.
    """
    x = jnp.asarray(x)

    def step(g, s):
        y = s * g.astype(s.dtype)
        err = jnp.log(jnp.float32(target_rms)
                      / (jnp.abs(y).astype(jnp.float32) + 1e-12))
        g = g * jnp.exp(jnp.float32(rate) * err)
        return g, y

    g, y = jax.lax.scan(step, gain, x)
    return y, g
