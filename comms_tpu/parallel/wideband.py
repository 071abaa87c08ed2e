"""Multi-chip wideband chain (BASELINE config 5): time-block sharded
FIR + FM demod + FIR + channelizer with overlap-save halo exchange.

One ``shard_map`` program over a 1-D ``"time"`` mesh:

    u8/f32 IQ pairs [N, 2], N sharded over chips
      -> FIR LPF        (halo = T-1 via ppermute)
      -> decimate /D1   (local; shard length % D1 == 0)
      -> FM demod       (halo = 1)
      -> FIR audio LPF  (halo = T-1)
      -> decimate /D2
      plus frequency-offset estimate (psum reduction)

All collectives are neighbor ppermutes + one psum (neighbour traffic,
no all-gathers).  Carried stream state crosses blocks as f32 pairs.

This module is the multi-chip "training step" analogue for the
framework: ``make_sharded_step`` returns a pjit-ted function running
the full chain on a sharded block.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from comms_tpu.ops import fir
from comms_tpu.parallel import sharding as sh

__all__ = ["WidebandConfig", "make_sharded_step", "make_sharded_psd",
           "make_sharded_psd_segments", "init_state"]


class WidebandConfig:
    def __init__(self, taps_lpf, block: int = 1 << 20, dec1: int = 5,
                 dec2: int = 5):
        t = np.asarray(taps_lpf)
        self.num_taps = len(t)
        self.B_iq = fir.banded_tap_matrix(t.astype(np.complex64))
        self.B_audio = fir.banded_tap_matrix(t.astype(np.float32))
        self.block = int(block)
        self.dec1 = int(dec1)
        self.dec2 = int(dec2)


def init_state(cfg: WidebandConfig):
    T = cfg.num_taps
    return (
        jnp.zeros((T - 1, 2), dtype=jnp.float32),  # IQ FIR tail (pairs)
        jnp.zeros((2,), dtype=jnp.float32),        # FM prev
        jnp.zeros((T - 1,), dtype=jnp.float32),    # audio FIR tail
    )


def make_sharded_step(cfg: WidebandConfig, mesh: Mesh,
                      axis: str = "time"):
    """Returns jitted ``(state, iq_pairs[N, 2]) ->
    ((audio[M], freq_est[]), new_state)`` with ``iq_pairs`` sharded
    over ``axis`` and audio returned sharded the same way.  Halos
    travel by ``lax.ppermute`` (NCCL on GPUs)."""
    n = mesh.shape[axis]
    if cfg.block % n:
        raise ValueError("block must divide evenly over shards")
    local = cfg.block // n
    if local % cfg.dec1 or (local // cfg.dec1) % cfg.dec2:
        raise ValueError("per-shard length must divide by dec1 and dec2")
    T = cfg.num_taps
    B_iq, B_audio = cfg.B_iq, cfg.B_audio

    def hx(xl, ctx, halo):
        return sh.halo_exchange(xl, ctx, halo, axis)

    def local_chain(state, iq_pairs):
        ctx_pairs, prev_pair, actx = state
        x = lax.complex(iq_pairs[:, 0], iq_pairs[:, 1])

        # --- FIR LPF with ring halo (overlap-save).
        ctx = lax.complex(ctx_pairs[:, 0], ctx_pairs[:, 1])
        halo = hx(x, ctx, T - 1)
        y, _ = fir.fir_block(x, B_iq, halo)
        new_ctx = sh.collect_ctx(x, T - 1, axis)

        # --- frequency estimate on filtered signal (psum).
        lag = y[1:] * jnp.conj(y[:-1])
        # cross-shard lag-1 term: left neighbor's last y sample.
        yprev = hx(y, jnp.zeros((1,), y.dtype), 1)
        idx = lax.axis_index(axis)
        edge = jnp.where(idx == 0, 0j, y[0] * jnp.conj(yprev[0]))
        fsum = sh.psum_estimate(jnp.sum(lag) + edge, axis)
        freq = jnp.arctan2(jnp.imag(fsum), jnp.real(fsum))

        # --- decimate (local; shard length % dec == 0 keeps global
        #     stride aligned).
        y = y[:: cfg.dec1]

        # --- FM demod with 1-sample halo.
        prev_g = lax.complex(prev_pair[0], prev_pair[1])
        hp = hx(y, prev_g[None], 1)
        shifted = jnp.concatenate([hp, y[:-1]])
        # polynomial atan2 (5e-7 rad): XLA's exact atan2 is the
        # chain's largest elementwise stage
        from comms_tpu.ops.demodulation import fast_angle
        d = fast_angle(y * jnp.conj(shifted)).astype(jnp.float32)
        new_prev_c = sh.collect_ctx(y, 1, axis)

        # --- audio FIR + decimate.
        ah = hx(d, actx, T - 1)
        a, _ = fir.fir_block(d, B_audio, ah)
        new_actx = sh.collect_ctx(d, T - 1, axis)
        audio = a[:: cfg.dec2]

        new_state = (
            jnp.stack([jnp.real(new_ctx), jnp.imag(new_ctx)], axis=-1),
            jnp.stack([jnp.real(new_prev_c[0]), jnp.imag(new_prev_c[0])]),
            new_actx,
        )
        return (audio, freq), new_state

    state_specs = (P(), P(), P())
    # check_rep off: on a 1-shard mesh the halo short-circuits skip
    # the collectives that would prove replication of the P() outputs.
    fn = shard_map(
        local_chain, mesh=mesh,
        in_specs=(state_specs, P(axis, None)),
        out_specs=((P(axis), P()), state_specs),
        check_vma=False,
    )
    return jax.jit(fn)


def _welch_window(fft_size: int, window):
    """Shared window/scale preamble of the three PSD makers."""
    from comms_tpu.ops import spectrum

    w = np.asarray(window if window is not None
                   else spectrum.hann(fft_size), np.float64)
    if w.shape[0] != fft_size:
        raise ValueError("window length must equal fft_size")
    return w.astype(np.float32), 1.0 / float(np.sum(w ** 2))


def make_sharded_psd(fft_size: int, mesh: Mesh, axis: str = "time",
                     window=None, local_radix=None):
    """Wideband spectral monitor on a sharded stream: a Welch-averaged
    PSD whose FFT is the distributed transposed FFT
    (:mod:`comms_tpu.parallel.dfft` inlined per shard — the dfft's
    consumer).  Segments of ``fft_size`` samples span ALL shards, so a
    single spectrum can be far larger than one chip's comfortable
    working set (e.g. 2^20 bins over the whole band).

    Returns jitted ``(pairs[B, fft_size, 2]) -> psd[fft_size]`` with
    the frequency axis sharded over ``axis``; ``B`` overlapping-free
    segments are averaged.  Window defaults to periodic Hann;
    normalization matches :func:`comms_tpu.ops.spectrum.welch_psd`
    (fs = 1, density, window power corrected).
    """
    from comms_tpu.parallel import dfft as dfft_mod

    n = mesh.shape[axis]
    w32, scale = _welch_window(fft_size, window)
    d = dfft_mod.make_dfft(fft_size, mesh, axis, local_radix=local_radix)
    local_f = fft_size // n

    def local(pairs_l):                          # [B, F/n, 2]
        x = lax.complex(pairs_l[..., 0], pairs_l[..., 1])
        idx = lax.axis_index(axis)
        wl = lax.dynamic_slice_in_dim(jnp.asarray(w32), idx * local_f,
                                      local_f)
        # per-segment mean removal needs the cross-shard mean (psum).
        mean = lax.psum(jnp.sum(x, axis=1, keepdims=True), axis) / fft_size
        spec = d.local_fn((x - mean) * wl[None, :])
        return jnp.mean(jnp.abs(spec) ** 2, axis=0) * scale

    fn = shard_map(
        local, mesh=mesh,
        in_specs=(P(None, axis, None),),
        out_specs=P(axis),
        check_vma=False,
    )
    return jax.jit(fn)


def make_sharded_psd_segments(fft_size: int, mesh: Mesh,
                              axis: str = "time", window=None):
    """Segment-parallel Welch PSD: the SEGMENT axis is sharded over
    the mesh (each spectrum fits one device), every shard transforms
    its local segments, and ONE psum of the [F] bin accumulators
    combines the estimate — complementing :func:`make_sharded_psd`
    (frequency-sharded, for F too large per device).

    Returns jitted ``(pairs[B, fft_size, 2]) -> psd[fft_size]`` with
    ``B`` sharded over ``axis`` (B % mesh size == 0) and the PSD
    replicated.  Window/demean/density semantics match
    :func:`make_sharded_psd` exactly.
    """
    n = mesh.shape[axis]
    w32, scale = _welch_window(fft_size, window)

    def local(pairs_l):                          # [B/n, F, 2]
        x = lax.complex(pairs_l[..., 0], pairs_l[..., 1])
        x = x - jnp.mean(x, axis=1, keepdims=True)
        spec = jnp.fft.fft(x * jnp.asarray(w32)[None, :], axis=1)
        acc = jnp.sum(jnp.abs(spec) ** 2, axis=0)
        acc = lax.psum(acc, axis)
        b_total = pairs_l.shape[0] * n
        return acc * jnp.float32(scale / b_total)

    fn = shard_map(
        local, mesh=mesh,
        in_specs=(P(axis, None, None),),
        out_specs=P(),
        check_vma=False,
    )
    return jax.jit(fn)


def make_sharded_psd_planar(fft_size: int, mesh: Mesh,
                            axis: str = "time", window=None,
                            local_radix=None):
    """Plane-native variant of :func:`make_sharded_psd`: jitted
    ``(re[B, fft_size], im[B, fft_size]) -> psd[fft_size]`` for the
    serving-ingest layout (io/raw_iq unpacks interleaved files to
    planes).  Window, demean, and density normalization match
    :func:`make_sharded_psd`.
    """
    from comms_tpu.parallel import dfft as dfft_mod

    n = mesh.shape[axis]
    w32, scale = _welch_window(fft_size, window)
    # one complex materialization, which the FFT needs anyway
    d = dfft_mod.make_dfft(fft_size, mesh, axis, local_radix=local_radix)
    local_f = fft_size // n

    def local(re_l, im_l):                       # [B, F/n] planes
        x = lax.complex(re_l, im_l)
        idx = lax.axis_index(axis)
        wl = lax.dynamic_slice_in_dim(jnp.asarray(w32), idx * local_f,
                                      local_f)
        mean = lax.psum(jnp.sum(x, axis=1, keepdims=True), axis
                        ) / fft_size
        spec = d.local_fn((x - mean) * wl[None, :])
        return jnp.mean(jnp.abs(spec) ** 2, axis=0) * scale

    fn = shard_map(
        local, mesh=mesh,
        in_specs=(P(None, axis), P(None, axis)),
        out_specs=P(axis),
        check_vma=False,
    )
    jfn = jax.jit(fn)

    def entry(re, im):
        if re.ndim == 3:     # pre-factorized serving shape
            re = re.reshape(re.shape[0], -1)
            im = im.reshape(im.shape[0], -1)
        return jfn(re, im)

    return entry
