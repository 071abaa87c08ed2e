"""Complex mixer and NCO as closed-form phase ramps.

Functional parity with the reference's per-sample recurrences:

* ``Mixer`` (``/root/reference/src/mixer.rs:17-85``):
  ``y[n] = x[n] * exp(j*phase); phase += dphase`` (wrap to [0, 2*pi)).
* ``Nco``  (``/root/reference/src/demodulation/nco.rs:15-78``):
  ``push(perr): phase += dphase + perr; emit exp(j*phase)``.

Design: the mixer's phase recurrence has the closed form
``phase[n] = phase0 + n*dphase`` — a precomputed complex ramp times a
carried scalar phasor, so the whole block is one fused elementwise
multiply on the VPU instead of a sequential loop.  The NCO's phase
error feedback is a *cumulative sum* (associative), so a block of
phase errors becomes ``cumsum`` + elementwise ``exp`` — parallel, not
a scan.

Precision: ``n*dphase mod 2*pi`` is precomputed **on the host in
float64** for the block ramp (n up to ~1e6 would lose ~0.5 rad in
f32); the carried phase stays wrapped in [0, 2*pi) where f32 holds
~1e-7 relative error per block, so error does not accumulate over
stream length.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

__all__ = [
    "normalize_dphase",
    "mixer_ramp",
    "mixer_block",
    "nco_block",
    "phase_fix_init",
    "advance_fix",
    "add_fix",
    "phase_fix_to_angle",
    "mixer_block_fix",
    "derotate_traced",
    "derotate_traced_planar",
]

_TWO_PI = 2.0 * np.pi


def normalize_dphase(dphase: float) -> float:
    """Wrap dphase to [0, 2*pi) in float64, as Mixer::new (mixer.rs:43-51)."""
    return float(np.mod(np.float64(dphase), _TWO_PI))


def mixer_ramp(n: int, dphase: float, dtype=np.complex64):
    """Host-precomputed unit ramp ``exp(j * (k*dphase mod 2*pi))`` for
    k in [0, n) plus the per-block phase advance ``n*dphase mod 2*pi``.

    Returns ``(ramp[n] ndarray, block_advance float)``.  Computed in
    float64 so block position never degrades the ramp.
    """
    dphase = np.float64(normalize_dphase(dphase))
    k = np.arange(n, dtype=np.float64)
    ph = np.mod(k * dphase, _TWO_PI)
    ramp = np.exp(1j * ph).astype(dtype)
    advance = float(np.mod(np.float64(n) * dphase, _TWO_PI))
    return ramp, advance


def mixer_block(x, phase, ramp, advance):
    """Mix one block: ``y[k] = x[k] * exp(j*(phase + k*dphase))``.

    ``phase`` is the carried scalar (float32 array, wrapped); ``ramp``/
    ``advance`` come from :func:`mixer_ramp` for ``len(x)``.  Returns
    ``(y, new_phase)``.

    Matches Mixer::mix (mixer.rs:73-84): the sample is multiplied by
    ``exp(j*phase)`` *before* the phase step, so sample k sees
    ``phase0 + k*dphase``.
    """
    x = jnp.asarray(x)
    phasor = jnp.exp(1j * phase.astype(jnp.float32)).astype(x.dtype)
    y = x * (phasor * jnp.asarray(ramp))
    new_phase = jnp.mod(phase + jnp.float32(advance), jnp.float32(_TWO_PI))
    return y, new_phase


# ------------------------- fixed-point carried phase -------------------
# The f32 carried phase above accrues ~1e-7 rad of rounding per BLOCK
# (not per sample) — bounded for hours, not for unbounded serving.
# For production streams the phase is carried as a 64-bit fixed-point
# fraction of 2*pi in two uint32 lanes: per-block accumulation is
# EXACT (wrap-free modular addition), and the only error is the
# non-accumulating f32 rounding when converting to an angle.

_C_16 = np.float32(2.0 * np.pi / 2.0 ** 16)
_C_32 = np.float32(2.0 * np.pi / 2.0 ** 32)
_C_LO = np.float32(2.0 * np.pi / 2.0 ** 64)


def phase_fix_init(phase0: float = 0.0):
    """Initial (hi, lo) uint32 fixed-point phase state."""
    frac = float(np.mod(np.float64(phase0), _TWO_PI)) / _TWO_PI
    q = int(round(frac * 2.0 ** 64)) % (1 << 64)
    return (jnp.uint32(q >> 32), jnp.uint32(q & 0xFFFFFFFF))


def advance_fix(n: int, dphase: float):
    """Host-exact per-block phase advance ``n*dphase mod 2*pi`` as a
    (hi, lo) uint32 pair (numpy scalars, safe to close over)."""
    dphase = np.float64(normalize_dphase(dphase))
    # high-precision mod via Python ints of scaled f64 pieces
    frac = (float(np.mod(np.float64(n) * dphase, _TWO_PI)) / _TWO_PI)
    q = int(round(frac * 2.0 ** 64)) % (1 << 64)
    return (np.uint32(q >> 32), np.uint32(q & 0xFFFFFFFF))


def add_fix(p, a):
    """(hi, lo) + (hi, lo) with exact 64-bit wraparound (uint32 ops)."""
    lo = p[1] + jnp.uint32(a[1])
    carry = (lo < p[1]).astype(jnp.uint32)
    hi = p[0] + jnp.uint32(a[0]) + carry
    return (hi, lo)


def phase_fix_to_angle(p):
    """Fixed-point phase -> f32 radians in [0, 2*pi).

    The hi word is split into 16-bit halves so every integer is exact
    in f32; total conversion error ~1e-7 rad, non-accumulating."""
    hi_t = (p[0] >> jnp.uint32(16)).astype(jnp.float32)
    hi_b = (p[0] & jnp.uint32(0xFFFF)).astype(jnp.float32)
    return (hi_t * _C_16 + hi_b * _C_32
            + p[1].astype(jnp.float32) * _C_LO)


def mixer_block_fix(x, pfix, ramp, adv_fix):
    """Drift-free mixer block: like :func:`mixer_block` but the
    carried phase is the fixed-point pair from
    :func:`phase_fix_init` / advanced by ``adv_fix`` from
    :func:`advance_fix`.  Returns ``(y, new_pfix)``."""
    x = jnp.asarray(x)
    phi0 = phase_fix_to_angle(pfix)
    phasor = jnp.exp(1j * phi0).astype(x.dtype)
    y = x * (phasor * jnp.asarray(ramp))
    return y, add_fix(pfix, adv_fix)


def derotate_traced(x, freq, phase0=0.0):
    """``y[k] = x[k] * exp(-j*(phase0 + freq*k))`` for a TRACED
    frequency (estimator output — host precompute impossible).

    Instead of a transcendental pair per sample, cos/sin are computed
    on two small vectors (row angle ``freq*128*r`` for r < ceil(N/128)
    and column angle ``freq*s`` for s < 128) and combined on the [R,
    128] planes by the angle-addition identity — N/64-ish
    transcendentals plus a few full-lane multiplies.  f32 angle
    precision matches the naive ``exp(-1j*freq*k)`` formulation (both
    compute freq*k at f32 ulp of the full product).
    """
    x = jnp.asarray(x)
    yr, yi = derotate_traced_planar(jnp.real(x), jnp.imag(x), freq,
                                    phase0)
    return jax.lax.complex(yr, yi)


def derotate_traced_planar(xr, xi, freq, phase0=0.0):
    """Planar twin of :func:`derotate_traced`: re/im planes in,
    ``(yr, yi)`` planes out — for pipelines that keep the signal
    planar end-to-end (complex64 is never materialized)."""
    n = xr.shape[0]
    R = -(-n // 128)
    pad = R * 128 - n
    freq = jnp.asarray(freq, jnp.float32)
    a = freq * jnp.float32(128.0) * jnp.arange(R, dtype=jnp.float32) \
        + jnp.float32(phase0)
    b = freq * jnp.arange(128, dtype=jnp.float32)
    ca, sa = jnp.cos(a)[:, None], jnp.sin(a)[:, None]
    cb, sb = jnp.cos(b)[None, :], jnp.sin(b)[None, :]
    c = ca * cb - sa * sb               # cos(phase0 + freq*k)
    s = sa * cb + ca * sb               # sin(phase0 + freq*k)
    x2r = jnp.pad(xr, (0, pad)).reshape(R, 128)
    x2i = jnp.pad(xi, (0, pad)).reshape(R, 128)
    yr = x2r * c + x2i * s              # x * (c - j*s)
    yi = x2i * c - x2r * s
    return yr.reshape(-1)[:n], yi.reshape(-1)[:n]


def nco_block(perr, phase, dphase: float):
    """Run a block of phase errors through the NCO.

    Reference semantics (nco.rs:71-78): for each input
    ``phase += dphase + perr[k]`` *then* emit ``exp(j*phase)`` — i.e.
    output k carries ``phase0 + (k+1)*dphase + cumsum(perr)[k]``.

    ``cumsum`` is associative so the whole block is parallel on the
    VPU.  Returns ``(iq, new_phase)`` with ``new_phase`` wrapped.
    """
    perr = jnp.asarray(perr)
    dphase = normalize_dphase(dphase)
    n = perr.shape[0]
    # k*dphase precomputed exactly like the mixer ramp (host f64).
    k_dph = np.mod(
        (np.arange(1, n + 1, dtype=np.float64)) * np.float64(dphase), _TWO_PI
    ).astype(np.float32)
    ph = phase.astype(perr.dtype) + jnp.asarray(k_dph).astype(perr.dtype) \
        + jnp.cumsum(perr)
    iq = jnp.exp(1j * ph)
    new_phase = jnp.mod(ph[-1], jnp.float32(_TWO_PI)).astype(phase.dtype)
    return iq, new_phase
