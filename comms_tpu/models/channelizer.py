"""64-channel polyphase channelizer model (BASELINE config 4).

Wideband IQ in -> K channel streams out, as one jitted block:
polyphase branch MACs + batched K-point IFFT
(:mod:`comms_tpu.ops.channelizer`).  The sharded variant
(channels/time over a mesh) lives in :mod:`comms_tpu.parallel`.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from comms_tpu.ops import channelizer as chan

__all__ = ["ChannelizerConfig", "make_block_fn", "make_planar_block_fn",
           "init_state"]


class ChannelizerConfig:
    def __init__(self, num_channels: int = 64, taps_per_branch: int = 8,
                 block: int = 1 << 18, prototype=None):
        self.num_channels = int(num_channels)
        self.taps_per_branch = int(taps_per_branch)
        self.block = int(block)
        if self.block % self.num_channels:
            raise ValueError("block must be a multiple of num_channels")
        h = (np.asarray(prototype) if prototype is not None
             else chan.design_prototype(num_channels, taps_per_branch))
        self.prototype = h
        self.Hb = chan.branch_taps(h.astype(np.float32), self.num_channels)

    @property
    def frames_per_block(self) -> int:
        return self.block // self.num_channels


def init_state(cfg: ChannelizerConfig):
    """Carried input tail as f32 pairs (boundary-safe)."""
    T = cfg.num_channels * cfg.taps_per_branch
    return jnp.zeros((T - 1, 2), dtype=jnp.float32)


def make_block_fn(cfg: ChannelizerConfig):
    """jitted ``(state, iq_pairs[N, 2]) -> (y_pairs[frames, K, 2], state)``."""
    Hb = cfg.Hb  # numpy closure (real f32; kept host-side for symmetry)

    @jax.jit
    def block(state, iq_pairs):
        x = jax.lax.complex(iq_pairs[:, 0], iq_pairs[:, 1])
        ctx = jax.lax.complex(state[:, 0], state[:, 1])
        y, ctx = chan.channelize_block(x, Hb, ctx)
        new_state = jnp.stack([jnp.real(ctx), jnp.imag(ctx)], axis=-1)
        yp = jnp.stack([jnp.real(y), jnp.imag(y)], axis=-1)
        return yp, new_state

    return block


def make_planar_block_fn(cfg: ChannelizerConfig):
    """Plane-native variant: jitted ``(state, re[N], im[N]) ->
    ((yre[frames, K], yim[frames, K]), state)``.

    For ingest that deinterleaves on the host (recorded IQ is
    interleaved on disk, planar on the device).  State stays the
    (T-1, 2) f32 pairs of :func:`init_state` — interchangeable with
    :func:`make_block_fn` mid-stream.
    """
    Hb = cfg.Hb

    @jax.jit
    def block(state, re, im):
        yr, yi, nre, nim = chan.channelize_block_planar(
            re, im, Hb, state[:, 0], state[:, 1])
        new_state = jnp.stack([nre, nim], axis=-1)
        return (yr, yi), new_state

    return block
