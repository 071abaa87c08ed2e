"""QPSK receiver: matched filter -> sync -> symbol decisions -> bits.

The reference ships the *pieces* of a digital receiver — frequency
(frequency_estimator.rs), phase (phase_estimator.rs) and timing
(timing_estimator.rs) estimators — but never a receiver that closes
the loop.  This model composes them into the full feedforward
synchronization chain for the qpsk_tx waveform
(RRC sps=4, beta=0.25, consecutive-bit-pair map):

    i16 IQ -> frequency estimate (pre-matched-filter, Meyr 8.2.2)
           -> mixer de-rotation (closed-form ramp)
           -> RRC matched filter
           -> NDA ML timing estimate (Mengali 8.4) -> cubic-Lagrange
              fractional-delay correction + symbol downsample
           -> M-power phase estimate (Mengali 5.7.4) -> de-rotation
           -> hard decisions -> bits (+ differential resolution of the
              4-fold phase ambiguity is left to the caller / pilots;
              the loopback test resolves it by trying the 4 rotations)

Everything is one jittable block function; estimates are reductions
(psum-ready under sharding).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from comms_tpu.ops import demodulation, fir, mixer, taps

__all__ = ["QpskRxConfig", "make_rx_fn", "make_rx_fn_planar",
           "decide_bits", "resolve_ambiguity"]


class QpskRxConfig:
    def __init__(self, sps: int = 4, num_taps: int = 32,
                 beta: float = 0.25, timing_d: int = 5,
                 gemm_precision=jax.lax.Precision.DEFAULT):
        self.sps = int(sps)
        self.num_taps = int(num_taps)
        self.beta = float(beta)
        self.timing_d = int(timing_d)
        # Precision of the final fused decimating GEMM (symbol
        # output): DEFAULT (reduced-precision operands, ~1e-3
        # relative on unit-scale symbols — far inside the
        # hard-decision / symbol-rate-estimator budgets).  On CPU the
        # argument is a no-op (f32 dots are exact).
        self.gemm_precision = gemm_precision
        t = taps.rrc_taps(num_taps, float(sps), beta)
        # Unit-energy matched filter so decisions are scale-free.
        # Real taps: fir_block runs two real GEMMs on the re/im planes
        # instead of a zero-imag complex GEMM.
        t = t / np.sqrt(np.sum(np.abs(t) ** 2))
        self.mf_taps = np.real(t).astype(np.float32)
        self.mf = fir.banded_tap_matrix(self.mf_taps)
        self.timing = demodulation.TimingEstimator(
            n=self.sps, d=self.timing_d, alpha=self.beta)
        # One-hot banded matrices for the cubic-Lagrange interpolator
        # (general-sps staged path only): the traced 4-tap filter
        # becomes sum_j lag[j] * E_j, one device scalar-matrix product
        # per tap, then ONE banded GEMM replaces 3 full-rate rolls +
        # weighted sum.
        eye4 = np.eye(4, dtype=np.float32)
        self.lag_bands = np.stack(
            [fir.banded_tap_matrix(eye4[j]) for j in range(4)])
        self._fold_mf_weights()

    def _fold_mf_weights(self):
        """Host f64 folds that move the matched filter BEHIND the
        correlation panels (round-4 restructure, VERDICT r3 #2): all
        block-rate statistics — frequency, Mengali timing, per-phase
        symbol energies — become weighted sums of lagged correlations
        of the RAW signal, so the block is read ONCE for all three
        and the matched filter itself fuses into the final decimating
        GEMM.  Derivations: with y = h * x (zero-extended head),

            sum_k r2[k] y[k] conj(y[k+u])
              = sum_{a,b} h[a] h[b] r2[a] g2_x[u + a - b]  + O(T/N)

        (r2[k] = e^{-2j pi k / sps} is multiplicative in k), so the
        q-filter weight vector wq folds to

            wq2[v] = sum_{a,b} wq[v - a + b] h[a] h[b] r2[a],

        and the phase-restricted energies fold through
        w4[am, d] = sum_{a = am (mod sps)} h[a] h[a - d].
        """
        h = np.asarray(self.mf_taps, np.float64)
        T = h.shape[0]
        sps = self.sps
        nd = sps * self.timing_d
        self.panel_hw = nd + T - 1
        wq = self.timing._wq                      # [2*nd+1], v index +nd
        r2 = np.exp(-2j * np.pi * np.arange(T) / sps)
        wq2 = np.zeros(2 * self.panel_hw + 1, np.complex128)
        for a in range(T):
            for b in range(T):
                # v = u + a - b, u in [-nd, nd]
                lo = -nd + a - b + self.panel_hw
                wq2[lo:lo + 2 * nd + 1] += (h[a] * h[b] * r2[a]) * wq
        self.wq2 = wq2
        w4 = np.zeros((sps, 2 * T - 1), np.float64)
        for a in range(T):
            for d in range(-(T - 1), T):
                if 0 <= a - d < T:
                    w4[a % sps, d + T - 1] += h[a] * h[a - d]
        self.w4 = w4.astype(np.float32)
        self.w4_dvec = np.arange(-(T - 1), T, dtype=np.float32)


def make_rx_fn(cfg: QpskRxConfig):
    """Returns ``rx(iq_pairs_f32[N, 2]) -> (sym_planes_f32[2, M],
    diag)``: synchronized symbols as re/im PLANES (row 0 = re, row 1 =
    im — the planar layout is ~free on device, unlike an [M, 2]
    interleave; the public surface speaks f32, runtime/boundary.py)
    plus a diagnostics dict of the estimates.  N should be a multiple
    of sps.

    Formulation notes: derotations by the traced estimates use
    :func:`comms_tpu.ops.mixer.derotate_traced` (transcendentals on
    N/128-sized vectors, not N); the Lagrange interpolation, the
    traced integer timing shift, the max-energy phase pick AND the
    symbol downsample all fold into ONE traced-tap decimating GEMM
    (:func:`comms_tpu.ops.fir.fir_decimate_traced`) — a traced
    ``jnp.roll`` of the full-rate block is a full extra pass.
    """

    def rx(iq_pairs):
        return _rx_core(cfg, iq_pairs[:, 0], iq_pairs[:, 1])

    return jax.jit(rx)


def make_rx_fn_planar(cfg: QpskRxConfig):
    """Planar twin of :func:`make_rx_fn`: ``rx(re[N], im[N])`` —
    avoids the [N, 2] pair deinterleave.  The production ingest
    unpacks interleaved i16 IQ into planes (io/raw_iq), so planes are
    the native rx input; the pairs entry point exists for
    reference-parity callers.
    """

    def rx(re, im):
        return _rx_core(cfg, re, im)

    return jax.jit(rx)


def _rx_core(cfg: QpskRxConfig, re, im):
    """Dispatch: the round-4 fused core (panels on the RAW signal,
    matched filter folded into host weights + the final decimating
    GEMM — the block is read ~3x total) when sps divides the lane
    width; the staged core otherwise."""
    lanes = demodulation.TimingEstimator.LANES
    # sps >= 4: the e4 quadratic form indexes H's lag axis over
    # j - j' in [-3, 3], which needs 2*sps - 1 >= 7 (at sps = 2 the
    # gathers clamp out of range and feed wrong energies — caught by
    # round-4 review).
    if 4 <= cfg.sps <= lanes and lanes % cfg.sps == 0:
        return _rx_core_fused(cfg, re, im)
    return _rx_core_staged(cfg, re, im)


def _rx_core_fused(cfg: QpskRxConfig, re, im):
    """Fused receiver core.  The staged core runs freq estimate,
    derotate, matched filter, timing panels, traced decimating GEMM
    and symbol tail as separate full-rate stages; this core removes
    whole stages structurally:

    * the correlation panels move to the RAW planes, widened to
      ND + T - 1 lags (width-insensitive: the GEMMs' cost is operand
      reads), and now serve THREE consumers — the frequency estimate
      is the v = -1 diagonal (its stage deleted), the Mengali
      timing estimate uses the host-folded matched-filter weights
      ``cfg.wq2``, and the per-phase symbol energies fold through
      ``cfg.w4`` (see ``QpskRxConfig._fold_mf_weights`` for the exact
      identities; the carrier de-rotation folds as a traced
      ``exp(j*w*v)`` lag rotation — exact, not approximate);
    * the matched filter fuses into the final traced decimating GEMM
      (its taps become ``conv(mf, lagrange)`` — associativity of
      zero-extended causal convolution makes this EXACT, including
      the head transient; the few tail symbols that differ fall in
      the already-masked region), deleting the separate 1.28 ms MF
      pass and the full-rate y buffer entirely.
    """
    n = re.shape[0]
    sps = cfg.sps
    f_est, t_est, lag, shift, p_star = _panel_estimates(cfg, re, im)
    # shift2 lands in [-sps, 2] for |delay| <~ 2; clip to the tap
    # window's hard bounds (t0 = shift2 + sps must keep all 4
    # Lagrange taps inside the 3*sps flat vector) so an out-of-spec
    # delay estimate degrades gracefully instead of silently
    # truncating taps.
    shift2 = jnp.clip(shift - p_star, -sps, 2 * sps - 4)
    sr, si = _fused_symbol_gemm(cfg, re, im, f_est, lag, shift2)

    # Zero the contaminated block edges (identical rule to the staged
    # core; the tail symbols whose fused values would differ from the
    # staged zero-extended-y values all fall at m4 >= hi).
    lo = 3 + jnp.maximum(shift2, 0)
    hi = n + jnp.minimum(shift2, 0)
    m4 = jnp.arange(sr.shape[0]) * sps
    valid = (m4 >= lo) & (m4 < hi)
    sr = jnp.where(valid, sr, 0.0)
    si = jnp.where(valid, si, 0.0)

    sym_planes, diag_tail = _symbol_tail(sr, si)
    diag = {"freq": f_est, "timing": t_est, "sym_phase": p_star,
            **diag_tail}
    return sym_planes, diag


def _panel_estimates(cfg: QpskRxConfig, re, im):
    """All block-rate estimates from ONE pass of correlation panels
    over the raw planes: returns ``(f_est, t_est, lag[4], shift,
    p_star)`` — coarse carrier, Mengali timing, cubic-Lagrange
    weights, the interpolator's integer shift, and the max-energy
    symbol phase.  Only tiny (panel-sized) ops depend on the traced
    scalars."""
    panels = cfg.timing.corr_panels(re, im, halfwidth=cfg.panel_hw)
    return _estimates_from_panels(cfg, panels)


def _estimates_from_panels(cfg: QpskRxConfig, panels):
    """The estimate chain on GIVEN panels — split out so the
    time-sharded receiver (parallel/qpsk_rx_sharded.py) can psum the
    per-shard panels into global ones first (lagged-correlation sums
    are additive across shards)."""
    sps = cfg.sps
    T = int(cfg.mf_taps.shape[0])
    hw = cfg.panel_hw
    lanes = demodulation.TimingEstimator.LANES
    P1, P2, P3, P4, _meta = panels
    Er = P1 - P4                      # Re(V^T @ conj-windows)
    Ei = P2 + P3

    # --- coarse carrier frequency: angle of the v = -1 diagonal
    # (sum x[k] conj(x[k-1]) — frequency_estimator.rs:27-42; edge
    # terms differ from the full-block sum by O(hw/N)).
    idx_m1 = jnp.asarray((np.arange(lanes) + hw - 1)[:, None])
    g1r = jnp.sum(jnp.take_along_axis(Er, idx_m1, axis=1))
    g1i = jnp.sum(jnp.take_along_axis(Ei, idx_m1, axis=1))
    f_est = jnp.arctan2(g1i, g1r)

    # --- timing (Mengali 8.4) on the same panels: matched filter via
    # host-folded wq2, de-rotation via the exact e^{jwv} lag rotation.
    t_est = cfg.timing.estimate_from_panels(panels, weights=cfg.wq2,
                                            lag_rot=f_est)
    delay = -t_est
    mu = delay - jnp.floor(delay)
    d_int = jnp.floor(delay).astype(jnp.int32)
    tmu = 1.0 + mu
    pts = jnp.asarray([0.0, 1.0, 2.0, 3.0], dtype=jnp.float32)
    num = jnp.prod(
        jnp.where(jnp.eye(4, dtype=bool), 1.0, tmu - pts[None, :]),
        axis=1)
    den = jnp.prod(
        jnp.where(jnp.eye(4, dtype=bool), 1.0,
                  pts[:, None] - pts[None, :]), axis=1)
    lag = num / den                       # [4] traced f32

    # --- symbol phase: max-energy phase of the Lagrange-interpolated
    # matched-filter output, as a quadratic form in lag over the
    # phase-restricted raw correlations:
    #   e4[p] = Re sum_{j,j'} lag_j lag_j' e^{jw(j-j')}
    #               H[(p-j) mod sps, j-j'],
    #   H[q, t] = sum_{am,d} w4[am,d] e^{jwd} G_x[(q-am)%sps, t+d].
    vmax = (sps - 1) + (T - 1)
    vsel = np.arange(-vmax, vmax + 1)
    cols = jnp.asarray(np.arange(lanes)[:, None] + hw + vsel[None, :])
    Gr = jnp.take_along_axis(Er, cols, axis=1)
    Gr = Gr.reshape(lanes // sps, sps, vsel.size).sum(0)
    Gi = jnp.take_along_axis(Ei, cols, axis=1)
    Gi = Gi.reshape(lanes // sps, sps, vsel.size).sum(0)

    d_vec = jnp.asarray(cfg.w4_dvec)
    cd = jnp.cos(f_est * d_vec)
    sd = jnp.sin(f_est * d_vec)
    w4 = jnp.asarray(cfg.w4)
    q_idx = (np.arange(sps)[:, None] - np.arange(sps)[None, :]) % sps
    t_vec = np.arange(-(sps - 1), sps)
    v_idx = (t_vec[:, None] + np.arange(-(T - 1), T)[None, :]) + vmax
    qsel = jnp.asarray(q_idx)[:, None, :, None]
    vsel_j = jnp.asarray(v_idx)[None, :, None, :]
    Gsel_r = Gr[qsel, vsel_j]         # [sps, 2sps-1, sps(am), 2T-1]
    Gsel_i = Gi[qsel, vsel_j]
    wc = w4 * cd[None, :]
    ws = w4 * sd[None, :]
    Hr = (jnp.einsum("qtad,ad->qt", Gsel_r, wc)
          - jnp.einsum("qtad,ad->qt", Gsel_i, ws))
    Hi = (jnp.einsum("qtad,ad->qt", Gsel_i, wc)
          + jnp.einsum("qtad,ad->qt", Gsel_r, ws))

    jj = np.arange(4)
    t_jj = jj[:, None] - jj[None, :]
    ph_idx = jnp.asarray((np.arange(sps)[:, None, None]
                          - jj[None, :, None]) % sps)  # [p, j, 1]
    t_idx = jnp.asarray((t_jj + sps - 1)[None, :, :])  # [1, j, j']
    Hsel_r = Hr[ph_idx, t_idx]        # [sps, 4, 4]
    Hsel_i = Hi[ph_idx, t_idx]
    t_jj_f = jnp.asarray(t_jj.astype(np.float32))
    ll_c = lag[:, None] * lag[None, :] * jnp.cos(f_est * t_jj_f)
    ll_s = lag[:, None] * lag[None, :] * jnp.sin(f_est * t_jj_f)
    e4 = (jnp.einsum("jk,pjk->p", ll_c, Hsel_r)
          - jnp.einsum("jk,pjk->p", ll_s, Hsel_i))
    shift = d_int + 1  # +1: interpolator basepoint
    p_star = jnp.mod(jnp.argmax(e4).astype(jnp.int32) + shift, sps)
    return f_est, t_est, lag, shift, p_star


def modulated_taps(cfg: QpskRxConfig, w, lag, shift2):
    """The fused symbol GEMM's traced complex tap planes:
    conv(matched filter, cubic Lagrange at the estimated offset)
    modulated by ``e^{j*w*t}``.  Tiny panel-sized ops only — shared
    by the one-shot core and the fused stream step."""
    sps = cfg.sps
    t0 = shift2 + sps
    tt = jnp.arange(3 * sps)
    flat12 = jnp.where((tt >= t0) & (tt < t0 + 4),
                       lag[jnp.clip(tt - t0, 0, 3)], 0.0)
    flat_full = jnp.convolve(flat12, jnp.asarray(cfg.mf_taps))
    md = int(flat_full.shape[0])
    pad_to = -(-md // sps) * sps
    flat = jnp.concatenate(
        [flat_full, jnp.zeros(pad_to - md, flat_full.dtype)])
    tvec = jnp.arange(pad_to, dtype=jnp.float32)
    return flat * jnp.cos(w * tvec), flat * jnp.sin(w * tvec)


def _fused_symbol_gemm(cfg: QpskRxConfig, re, im, w, lag, shift2,
                       ctx=None, phase0=0.0):
    """The fused symbol path: ONE traced decimating GEMM ON THE RAW
    PLANES whose complex taps are conv(mf, lagrange-at-offset)
    modulated by e^{j*w*t} — matched filter, carrier de-rotation,
    fractional-delay interpolation, integer timing shift, phase
    pick and symbol downsample in a single pass.  The de-rotation
    folds as taps*e^{jwt} + an e^{-j(phase0 + w*sps*m)} SYMBOL-rate
    rotation (exact identity); folding it keeps every full-rate
    operand independent of the panel-derived scalars, so no
    full-rate stage waits on a data-dependent scalar.

    ``ctx``: optional carried raw-tail ``(re, im)`` planes (the
    streaming form — see fir_decimate_traced_planar_complex);
    ``phase0``: carried absolute de-rotation phase at the block
    start.  Returns the symbol planes ``(sr, si)`` of N/sps frames
    (the leading artifact frame of the underlying decimator is
    dropped here)."""
    sps = cfg.sps
    md_flat = 3 * sps + int(cfg.mf_taps.shape[0]) - 1
    pad_to = -(-md_flat // sps) * sps
    fr, fi = modulated_taps(cfg, w, lag, shift2)

    # Main GEMM always with the ZERO head extension: a zero jnp.pad
    # fuses into the window reads, while concatenating real carried
    # context materializes a full plane copy per plane (measured
    # 1.1 -> 3.0 ms at 33.5M samples).  Streaming context instead
    # PATCHES the few head outputs whose windows reach before the
    # block from a tiny recompute over [ctx ++ first samples].
    sr_all, si_all = fir.fir_decimate_traced_planar_complex(
        re, im, fr, fi, sps, tail_zeros=sps,
        precision=cfg.gemm_precision)
    if ctx is not None:
        Cn = pad_to - 1                   # = MD - 1 carried samples
        nh = (Cn // sps) + 1              # head outputs touching ctx
        L = nh * sps
        xh_r = jnp.concatenate(
            [jnp.zeros((1,), jnp.float32),
             jnp.asarray(ctx[0], jnp.float32), re[:L]])
        xh_i = jnp.concatenate(
            [jnp.zeros((1,), jnp.float32),
             jnp.asarray(ctx[1], jnp.float32), im[:L]])
        hr, hi = fir.fir_decimate_traced_planar_complex(
            xh_r, xh_i, fr, fi, sps, tail_zeros=0,
            precision=cfg.gemm_precision)
        off = pad_to // sps               # zero+ctx consume MD/sps
        sr_all = jax.lax.dynamic_update_slice(sr_all, hr[off:off + nh],
                                              (0,))
        si_all = jax.lax.dynamic_update_slice(si_all, hi[off:off + nh],
                                              (0,))
    sr_all, si_all = mixer.derotate_traced_planar(
        sr_all, si_all, w * float(sps), phase0=phase0)
    return sr_all[1:], si_all[1:]


def fused_gemm_ctx_len(cfg: QpskRxConfig) -> int:
    """Carried raw-tail samples for the streaming symbol GEMM
    (MD - 1 of :func:`_fused_symbol_gemm`'s padded tap vector)."""
    md = 3 * cfg.sps + int(cfg.mf_taps.shape[0]) - 1
    return -(-md // cfg.sps) * cfg.sps - 1


def _symbol_tail(sr, si, fphase=None, pfine=None, warm=None,
                 reduce=None, sym_offset=None):
    """Shared symbol-rate tail: fine carrier at symbol rate (4th
    power), then the Mengali 5.7.4 phase estimate and rotation onto
    the +-1+-1j constellation.  Returns ``(sym_planes, diag)``.

    Streaming continuity (qpsk_rx_stream.make_stream_fast_fn): pass
    the carried ``fphase`` (absolute fine-carrier phase at the block
    start — the rotation then starts from it and
    ``diag["fphase_next"]`` carries it forward) and ``pfine``/``warm``
    (previous phase estimate; the new one is unwrapped mod pi/2
    against it so the 4-fold ambiguity cannot jump quadrants at
    block seams — ``diag["phase"]`` is then the unwrapped value to
    carry).

    Sharding (parallel/qpsk_rx_sharded.py): ``reduce`` maps each
    estimator sum pair to its global value (``lax.psum`` inside
    shard_map — the sums are additive across time shards) and
    ``sym_offset`` anchors the fine-carrier rotation at this shard's
    global first-symbol index (phase0 += w_fine * sym_offset) so
    every shard applies the SAME globally-coherent correction."""
    red = reduce if reduce is not None else (lambda v: v)
    tr = sr[1:] * sr[:-1] + si[1:] * si[:-1]
    ti = si[1:] * sr[:-1] - sr[1:] * si[:-1]
    t2r, t2i = tr * tr - ti * ti, 2.0 * tr * ti
    t4r, t4i = t2r * t2r - t2i * t2i, 2.0 * t2r * t2i
    s4 = red((jnp.sum(t4r), jnp.sum(t4i)))
    w_fine = jnp.arctan2(s4[1], s4[0]) / 4.0
    phase0 = jnp.float32(0.0) if fphase is None else fphase
    if sym_offset is not None:
        # sym_offset = (block_symbols, block_index): reduced mod 2pi
        # PER FACTOR so no f32 product ever exceeds ~2pi * index
        # (a raw w * Mloc * idx product loses precision past 2^24)
        mloc_f, idx_f = sym_offset
        two_pi = jnp.float32(2.0 * np.pi)
        phase0 = phase0 + jnp.mod(
            jnp.mod(w_fine * mloc_f, two_pi) * idx_f, two_pi)
    sr, si = mixer.derotate_traced_planar(sr, si, w_fine,
                                          phase0=phase0)

    s2r, s2i = sr * sr - si * si, 2.0 * sr * si
    q4r, q4i = s2r * s2r - s2i * s2i, 2.0 * s2r * s2i
    g4 = red((jnp.sum(q4r), jnp.sum(q4i)))
    p_est = jnp.arctan2(g4[1], g4[0]) / 4.0
    if pfine is not None:
        halfq = jnp.float32(np.pi / 4)
        dp = jnp.mod(p_est - pfine + halfq, jnp.float32(np.pi / 2)) \
            - halfq
        p_est = jnp.where(warm > 0, pfine + dp, p_est)
    th = jnp.pi / 4 - p_est
    c, s = jnp.cos(th), jnp.sin(th)
    out_r = sr * c - si * s
    out_i = si * c + sr * s
    diag = {"freq_fine": w_fine, "phase": p_est}
    if fphase is not None:
        diag["fphase_next"] = jnp.mod(
            fphase + w_fine * sr.shape[0], jnp.float32(2.0 * np.pi))
    return jnp.stack([out_r, out_i], axis=0), diag


def _rx_core_staged(cfg: QpskRxConfig, re, im):
        # The whole core is PLANAR: complex64 is never materialized
        # (each complex op would cost extra full-rate re/im extraction
        # passes, and complex cannot cross the jit boundary on this
        # runtime anyway — runtime/boundary.py).
        n = re.shape[0]

        # --- coarse carrier frequency (pre-matched-filter; reference
        # tolerance is 0.01 rad/sample — a fine stage follows at
        # symbol rate).
        f_est = demodulation.frequency_offset_estimate_planar(re, im)
        xr, xi = mixer.derotate_traced_planar(re, im, f_est)

        # --- matched filter (zero head context).
        yr, yi = fir.fir_apply_planar(xr, xi, cfg.mf)

        # --- timing (Mengali 8.4): estimate ~ -(sampling delay);
        # correct with a traced-mu cubic Lagrange interpolator.  The
        # correlation panels are computed ONCE and shared with the
        # symbol-phase energy pick below (both are lagged-product
        # statistics of y; see TimingEstimator.corr_panels).
        panels = cfg.timing.corr_panels(yr, yi)
        t_est = cfg.timing.estimate_from_panels(panels)
        delay = -t_est
        mu = delay - jnp.floor(delay)
        d_int = jnp.floor(delay).astype(jnp.int32)
        tmu = 1.0 + mu
        pts = jnp.asarray([0.0, 1.0, 2.0, 3.0], dtype=jnp.float32)
        num = jnp.prod(
            jnp.where(jnp.eye(4, dtype=bool),
                      1.0, tmu - pts[None, :]), axis=1)
        den = jnp.prod(
            jnp.where(jnp.eye(4, dtype=bool),
                      1.0, pts[:, None] - pts[None, :]), axis=1)
        lag = num / den                       # [4] traced f32

        # --- symbol phase: pick the max-energy phase of the
        # Lagrange-interpolated signal.  e4[p] = sum_m |yd[sps*m+p]|^2
        # with yd = FIR_lag(y) expands to a quadratic form in lag over
        # phase-restricted lagged correlations of y,
        #     e4[p] = Re sum_{j,j'} lag[j] lag[j']
        #                 G[(p-j) mod sps, j-j'],
        #     G[q,u] = sum_{i = q mod sps} y[i] conj(y[i+u]),
        # and G is a diagonal functional of the timing panels already
        # computed — so the pick costs no full-rate work at all.  (The
        # previous full-rate yd GEMM + [N/sps, sps]-reshape reduce not
        # only cost a pass, its sps-lane minor layout propagated
        # upstream through argmax.)
        # Panel edge terms differ from the zero-context yd by
        # O((taps+ND)/N) of the energy — irrelevant to an argmax over
        # a modulated signal's eye.
        lanes = demodulation.TimingEstimator.LANES
        if 0 < cfg.sps <= lanes and lanes % cfg.sps == 0:
            P1, _p2, _p3, P4, meta = panels
            Er_raw = P1 - P4            # Re(V^T @ conj-windows)
            nd_t = meta["nd"]
            u7 = np.arange(-(cfg.sps - 1), cfg.sps)      # [2*sps-1]
            cols = np.arange(lanes)[:, None] + nd_t + u7[None, :]
            Gr = jnp.take_along_axis(Er_raw, jnp.asarray(cols), axis=1)
            Gr = Gr.reshape(lanes // cfg.sps, cfg.sps, u7.size).sum(0)
            jj = np.arange(4)
            qh = (np.arange(cfg.sps)[:, None] - jj[None, :]) % cfg.sps
            uh = (jj[:, None] - jj[None, :]) + cfg.sps - 1
            Gsel = Gr[jnp.asarray(qh)[:, :, None],
                      jnp.asarray(uh)[None, :, :]]       # [sps, 4, 4]
            e4 = jnp.einsum("j,k,pjk->p", lag, lag, Gsel)
        else:
            B_lag = jnp.tensordot(lag, jnp.asarray(cfg.lag_bands), axes=1)
            y_c = jax.lax.complex(yr, yi)
            yd, _ = fir.fir_block(y_c, B_lag, jnp.zeros((3,), y_c.dtype))
            keep = (n // cfg.sps) * cfg.sps
            en = (jnp.real(yd) ** 2 + jnp.imag(yd) ** 2)[:keep]
            e4 = jnp.sum(en.reshape(-1, cfg.sps), axis=0)
        shift = d_int + 1  # +1: interpolator basepoint
        p_star = jnp.mod(jnp.argmax(e4).astype(jnp.int32) + shift,
                         cfg.sps)

        # Fold the integer timing shift, the phase pick AND the
        # Lagrange interpolation + symbol downsample into ONE traced-
        # tap decimating GEMM:
        #   sym[m] = yd[sps*m - shift2] = sum_j lag[j]*y[sps*m-shift2-j]
        # i.e. a 3*sps-tap decimating FIR with lag placed at traced
        # offset t0 = shift2 + sps (one extra leading frame via
        # tail_zeros keeps t0 >= 0; the first output is dropped).  A
        # traced jnp.roll of the full-rate block (the previous
        # formulation) is a whole extra full-rate pass.
        shift2 = shift - p_star          # in [-sps..2] for |delay|<~2
        t0 = shift2 + cfg.sps
        tt = jnp.arange(3 * cfg.sps)
        flat = jnp.where((tt >= t0) & (tt < t0 + 4),
                         lag[jnp.clip(tt - t0, 0, 3)], 0.0)
        # Precision.HIGH (~1e-5 relative) instead of HIGHEST: 1e-5 on
        # unit-scale symbols is far inside the decision/estimator
        # budgets downstream.
        sr_all, si_all = fir.fir_decimate_traced_planar(
            yr, yi, flat, cfg.sps, tail_zeros=cfg.sps,
            precision=jax.lax.Precision.HIGH)
        sr, si = sr_all[1:], si_all[1:]

        # Zero the contaminated block edges (Lagrange zero-context
        # head, shifted-off-the-end tail) — the same lo/hi rule the
        # full-rate mask used, applied at symbol resolution (callers
        # should skip the first few symbols either way).
        lo = 3 + jnp.maximum(shift2, 0)
        hi = n + jnp.minimum(shift2, 0)
        m4 = jnp.arange(sr.shape[0]) * cfg.sps
        valid = (m4 >= lo) & (m4 < hi)
        sr = jnp.where(valid, sr, 0.0)
        si = jnp.where(valid, si, 0.0)

        sym_planes, diag_tail = _symbol_tail(sr, si)
        diag = {"freq": f_est, "timing": t_est, "sym_phase": p_star,
                **diag_tail}
        return sym_planes, diag


def _as_complex(symbols) -> np.ndarray:
    """Accept complex [M], planar [2, M] (rx output), or pairs [M, 2]."""
    s = np.asarray(symbols)
    if s.ndim == 2 and s.shape[0] == 2 and s.shape[1] != 2:
        return s[0] + 1j * s[1]
    if s.ndim == 2 and s.shape[-1] == 2:
        return s[:, 0] + 1j * s[:, 1]
    return s


def decide_bits(symbols) -> np.ndarray:
    """Hard decisions back to the tx bit convention
    (single_thread_qpsk.rs:29-36: re = 2*b0 - 1, im = 2*b1 - 1).
    Accepts complex [M], planar [2, M], or re/im pairs [M, 2]."""
    s = _as_complex(symbols)
    b0 = (s.real > 0).astype(np.uint8)
    b1 = (s.imag > 0).astype(np.uint8)
    out = np.empty(2 * len(s), dtype=np.uint8)
    out[0::2] = b0
    out[1::2] = b1
    return out


def resolve_ambiguity(symbols, reference_bits, search: int = 1024,
                      max_lag: int = 16):
    """Resolve the 4-fold phase ambiguity and the pipeline's symbol
    lag (tx+rx group delay, ~(2*num_taps-1)/sps symbols) against known
    bits: try the 4 rotations x lags in [0, max_lag], return
    ``((rot, lag), errors, bits_compared)`` for the best candidate.
    A real system resolves this with pilots/differential coding; the
    loopback tests use the transmitted bits."""
    best = None
    s = _as_complex(symbols)
    for rot in range(4):
        cand = decide_bits(s * np.exp(1j * np.pi / 2 * rot))
        for lag in range(0, max_lag + 1):
            a = cand[2 * lag:]
            m = min(len(a), len(reference_bits), search * 2)
            if m <= 0:
                continue
            errs = int(np.sum(a[:m] != reference_bits[:m]))
            if best is None or errs < best[1]:
                best = ((rot, lag), errs, m)
    return best
