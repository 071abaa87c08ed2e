"""2-D (time x channel) mesh for the wideband configs: the pod-shaped
layout (VERDICT r4 #4; SURVEY.md section 2.4's EP row scaled to a pod,
the fan-out of ``node_derive/src/lib.rs:153-163`` as a device grid).

The 1-D modules shard EITHER the sample axis (``parallel/wideband.py``)
OR the channel axis; the BASELINE wideband configs (64-channel
channelizer feeding per-channel receivers) want BOTH on a real pod:
a ``('time', 'chan')`` mesh where

* **stage 1 (channelize)** is time-local: the raw sample axis is
  sharded over the FLATTENED mesh (every device channelizes its
  slice; one overlap-save halo ppermute over the flattened ring,
  prototype length T-1);
* **corner turn** runs ``all_to_all`` WITHIN each time row over the
  ``chan`` axis only (local within a row): device (t, c) then
  holds ALL frames of time-row t for its K/nc channels;
* **stage 2 (per-channel FM receivers)** is channel-local with
  1-frame (demod lag) and M*D-1-frame (audio FIR) halos along the
  ``time`` axis only — neighbor traffic between consecutive rows of
  the SAME channel group;
* **reductions** (per-channel power map) psum over ``time`` within
  each channel column; stream-state collection one-hots the last
  time row.

Outputs equal the single-device band monitor exactly (overlap-save
halos reproduce every window; tests assert equality on a 2x4 CPU
mesh against ``fm_band_monitor.make_block_fn``).

Reference semantics being distributed: the polyphase channelizer
(``filter/fir.rs:87-102`` + ``fft/mod.rs:73-96`` composition) and the
FM demod chain (``examples/fm_radio.rs:144-168``).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax, shard_map
from jax.sharding import Mesh, PartitionSpec as P

from comms_tpu.models.fm_band_monitor import BandMonitorConfig
from comms_tpu.ops import channelizer as chan
from comms_tpu.ops import demodulation as demod
from comms_tpu.ops import fir
from comms_tpu.parallel import sharding as sh

__all__ = ["mesh_2d", "make_sharded_band_monitor_2d"]


def mesh_2d(nt: int, nc: int, t_axis: str = "time",
            c_axis: str = "chan") -> Mesh:
    """A ``(nt, nc)`` device grid named ``(t_axis, c_axis)``.  On a
    torus-linked machine pass a topology-aware device order so
    ``chan`` rows share a ring; on all-to-all links (NVLink) and
    virtual meshes the default order is fine."""
    devs = jax.devices()
    if nt * nc > len(devs):
        raise ValueError(f"mesh {nt}x{nc} needs {nt * nc} devices, "
                         f"have {len(devs)}")
    grid = np.array(devs[: nt * nc]).reshape(nt, nc)
    return Mesh(grid, (t_axis, c_axis))


def make_sharded_band_monitor_2d(cfg: BandMonitorConfig, mesh: Mesh,
                                 t_axis: str = "time",
                                 c_axis: str = "chan",
                                 fast_demod: bool = True):
    """jitted ``(state, iq_pairs[N, 2]) -> ((audio[K, M], power[K]),
    state)`` over the 2-D mesh: ``iq_pairs`` sharded over the
    flattened (time, chan) ring, ``audio`` sharded [chan, time],
    ``power`` (global per-channel spectral power) sharded over chan.

    State is interchangeable with the single-device
    ``fm_band_monitor.init_state`` pytree, sharded as
    ``(replicated, P(chan), P(chan))``.

    Constraints (validated): ``N % (nt*nc*K) == 0``, ``K % nc == 0``,
    per-row frames ``% audio_dec == 0`` and ``>= M*D - 1``, and the
    per-device slice must cover the T-1 channelizer halo.
    """
    nt, nc = mesh.shape[t_axis], mesh.shape[c_axis]
    K = cfg.num_channels
    T = K * cfg.taps_per_branch
    Tm1 = cfg.audio_C.size - 1
    audio_C = cfg.audio_C
    N = cfg.block
    if K % nc:
        raise ValueError(f"channels {K} must divide over chan axis {nc}")
    if N % (nt * nc * K):
        raise ValueError(f"block {N} must divide by devices*K "
                         f"= {nt * nc * K}")
    n_local = N // (nt * nc)          # raw samples per device
    if n_local < T - 1:
        raise ValueError(f"per-device slice {n_local} smaller than "
                         f"channelizer halo {T - 1}")
    frames_row = N // (nt * K)        # frames per time row
    if frames_row % cfg.audio_dec:
        raise ValueError(f"per-row frames {frames_row} must divide by "
                         f"audio_dec {cfg.audio_dec}")
    if frames_row < Tm1:
        raise ValueError(f"per-row frames {frames_row} smaller than "
                         f"audio halo {Tm1}")
    both = (t_axis, c_axis)
    at2 = demod.fast_atan2 if fast_demod else jnp.arctan2
    ftot = float(N // K)

    def local(state, iq):
        ctx_pairs, prev_pairs, actxs = state   # [T-1,2] | [Kl,2] | [Kl,Tm1]
        re, im = iq[:, 0], iq[:, 1]

        # --- stage 1: channelize this device's raw slice; overlap-
        # save halo from the flattened-ring left neighbor.
        cre = sh.halo_exchange(re, ctx_pairs[:, 0], T - 1, both)
        cim = sh.halo_exchange(im, ctx_pairs[:, 1], T - 1, both)
        yr, yi, _, _ = chan.channelize_block_planar(re, im, cfg.Hb,
                                                    cre, cim)
        new_ctx_re = sh.collect_ctx(re, T - 1, both)
        new_ctx_im = sh.collect_ctx(im, T - 1, both)

        # --- corner turn WITHIN the time row: [fl, K] time-sharded ->
        # [frames_row, K/nc] channel-sharded (all_to_all on chan only).
        yr = sh.corner_turn(yr, c_axis)
        yi = sh.corner_turn(yi, c_axis)

        # --- stage 2: per-channel FM demod; the lag-1 frame crosses
        # time rows of the SAME channel column (1-frame halo), row 0
        # uses the carried per-channel prev state.
        prow_r = sh.halo_exchange(yr, prev_pairs[:, 0][None, :], 1,
                                  t_axis)
        prow_i = sh.halo_exchange(yi, prev_pairs[:, 1][None, :], 1,
                                  t_axis)
        rt, it = yr.T, yi.T                       # [Kl, frames_row]
        a, b = rt[:, 1:], rt[:, :-1]
        c, d_ = it[:, 1:], it[:, :-1]
        d_int = at2(c * b - a * d_, a * b + c * d_)
        p_r, p_i = prow_r[0], prow_i[0]
        d0 = at2(it[:, 0] * p_r - rt[:, 0] * p_i,
                 rt[:, 0] * p_r + it[:, 0] * p_i)
        d = jnp.concatenate([d0[:, None], d_int], axis=1)

        # --- audio FIR + decimate per channel: M*D-1-frame halo along
        # time (the previous row's demod tail), row 0 uses the carried
        # audio tails.
        dctx = sh.halo_exchange(d.T, actxs.T, Tm1, t_axis)   # [Tm1, Kl]
        audio, _ = jax.vmap(
            lambda dk, ak: fir.fir_decimate_poly(dk, audio_C, ak)
        )(d, dctx.T)

        # --- stream state for the next block: one-hot the last row.
        idx_t = lax.axis_index(t_axis)
        n_t = lax.axis_size(t_axis)
        keep = (idx_t == n_t - 1).astype(jnp.float32)
        new_prev = lax.psum(
            jnp.stack([rt[:, -1], it[:, -1]], axis=-1) * keep, t_axis)
        new_actx = lax.psum(d[:, -Tm1:] * keep, t_axis)

        # --- per-channel power map: psum the row partials down each
        # channel column (the "estimator reduction within rows").
        power = lax.psum(jnp.sum(rt * rt + it * it, axis=1),
                         t_axis) / ftot

        new_state = (
            jnp.stack([new_ctx_re, new_ctx_im], axis=-1),
            new_prev,
            new_actx,
        )
        return (audio, power), new_state

    state_specs = (P(), P(c_axis), P(c_axis))
    fn = shard_map(
        local, mesh=mesh,
        in_specs=(state_specs, P(both, None)),
        out_specs=((P(c_axis, t_axis), P(c_axis)), state_specs),
        check_vma=False,
    )
    return jax.jit(fn)
