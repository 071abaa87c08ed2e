"""Wideband FM band monitor: channelize -> demodulate EVERY channel.

Capstone integration of the framework's pieces (no reference
counterpart; the composition the BASELINE's channelizer config
exists for): a wideband capture covering K FM stations is split by
the polyphase channelizer, then every channel is FM-demodulated and
audio-filtered IN PARALLEL — the per-channel chain is the fm_receiver
math vmapped over the channel axis, so K receivers cost one.

    wideband IQ [N, 2] ─ channelizer ─► [frames, K]
      └─ per-channel (vmapped): FM demod ─ audio FIR ÷D ─► [K, audio]

Under time-sharding the channelizer rides the standard halo protocol
and the per-channel chains are local; channel-sharding (EP-style) uses
``parallel.sharding.corner_turn`` between the two stages.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from comms_tpu.ops import channelizer as chan
from comms_tpu.ops import demodulation as demod
from comms_tpu.ops import fir

__all__ = ["BandMonitorConfig", "make_block_fn",
           "make_planar_block_fn", "init_state"]


class BandMonitorConfig:
    def __init__(self, num_channels: int = 16, taps_per_branch: int = 8,
                 block: int = 1 << 18, audio_dec: int = 4,
                 audio_taps=None):
        self.num_channels = int(num_channels)
        self.taps_per_branch = int(taps_per_branch)
        self.block = int(block)
        self.audio_dec = int(audio_dec)
        if self.block % (self.num_channels * self.audio_dec):
            raise ValueError("block must divide by channels * audio_dec")
        h = chan.design_prototype(self.num_channels, self.taps_per_branch)
        self.prototype = h
        self.Hb = chan.branch_taps(h.astype(np.float32), self.num_channels)
        at = (np.asarray(audio_taps) if audio_taps is not None
              else chan.design_prototype(self.audio_dec, 8))
        self.audio_taps = at.astype(np.float32)
        self.audio_C = fir.decimating_branch_taps(
            self.audio_taps, self.audio_dec)

    @property
    def frames_per_block(self) -> int:
        return self.block // self.num_channels

    @property
    def audio_per_channel(self) -> int:
        return self.frames_per_block // self.audio_dec


def init_state(cfg: BandMonitorConfig):
    """(channelizer tail pairs, per-channel FM prev pairs,
    per-channel audio-FIR tails) — boundary-safe."""
    T = cfg.num_channels * cfg.taps_per_branch
    K = cfg.num_channels
    return (
        jnp.zeros((T - 1, 2), dtype=jnp.float32),
        jnp.zeros((K, 2), dtype=jnp.float32),
        jnp.zeros((K, cfg.audio_C.size - 1), dtype=jnp.float32),
    )


def _planar_core(cfg: BandMonitorConfig, fast_demod: bool = True):
    """The shared block body on planes.  ``fast_demod`` selects the
    polynomial atan2 (5e-7 rad) over the exact one."""
    audio_C = cfg.audio_C
    Hb = cfg.Hb
    at2 = demod.fast_atan2 if fast_demod else jnp.arctan2

    def audio_fir(d, actxs):
        return jax.vmap(
            lambda dk, ak: fir.fir_decimate_poly(dk, audio_C, ak)
        )(d, actxs)

    def core(state, re, im):
        ctx_pairs, prev_pairs, actxs = state
        yr, yi, nre, nim = chan.channelize_block_planar(
            re, im, Hb, ctx_pairs[:, 0], ctx_pairs[:, 1])
        # Per-channel stage in CHANNEL-MAJOR PLANES: [frames, K] has a
        # K-lane minor dimension, so elementwise demod ran on K/128
        # lanes (measured ~85% of the block at K=16).  Transpose the
        # f32 planes once, demod via offset VIEWS of the same buffers
        # (no shifted-copy materialization), and use the polynomial
        # fast_atan2 (XLA's atan2 alone measured 2.1 Gsps standalone;
        # the polynomial runs 9.3 — ops/demodulation.fast_atan2).
        rt = yr.T                                    # [K, frames]
        it = yi.T
        a, b = rt[:, 1:], rt[:, :-1]
        c, d_ = it[:, 1:], it[:, :-1]
        d_int = at2(c * b - a * d_, a * b + c * d_)
        d0 = at2(
            it[:, 0] * prev_pairs[:, 0] - rt[:, 0] * prev_pairs[:, 1],
            rt[:, 0] * prev_pairs[:, 0] + it[:, 0] * prev_pairs[:, 1])
        d = jnp.concatenate([d0[:, None], d_int], axis=1)
        audio, new_actx = audio_fir(d, actxs)
        new_prev = jnp.stack([rt[:, -1], it[:, -1]], axis=-1)
        new_state = (
            jnp.stack([nre, nim], axis=-1),
            new_prev,
            new_actx,
        )
        return audio, new_state

    return core


def make_block_fn(cfg: BandMonitorConfig, fast_demod: bool = True):
    """jitted ``(state, iq_pairs[N, 2]) -> (audio[K, M], state)``.

    ``fast_demod`` (default True) demodulates with the polynomial
    :func:`comms_tpu.ops.demodulation.fast_atan2` (5e-7 rad); pass
    False for the exact op.
    """
    core = _planar_core(cfg, fast_demod=fast_demod)

    @jax.jit
    def block(state, iq_pairs):
        return core(state, iq_pairs[:, 0], iq_pairs[:, 1])

    return block


def make_planar_block_fn(cfg: BandMonitorConfig, fast_demod: bool = True):
    """Plane-native variant: jitted ``(state, re[N], im[N]) ->
    (audio[K, M], state)`` — the serving-ingest layout (io/raw_iq
    unpacks interleaved files to planes).  State is interchangeable
    with :func:`make_block_fn` mid-stream; ``fast_demod`` as there.
    """
    return jax.jit(_planar_core(cfg, fast_demod=fast_demod))
