"""Demodulation and synchronization estimators.

Functional parity with the reference:

* FM quadrature demod (``/root/reference/src/modulation/analog.rs:22-34``):
  ``y[n] = arg(x[n] * conj(x[n-1]))`` with ``prev`` carried across
  blocks (zero-initialized; arg(0) = 0).
* Frequency-offset estimator
  (``src/demodulation/frequency_estimator.rs:27-42``):
  ``arg(sum(x[1:] * conj(x[:-1])))`` rad/sample (Meyr/Moeneclaey/
  Fechtel ch. 8.2.2).
* PSK/QAM phase estimators (``src/demodulation/phase_estimator.rs:26-65``):
  ``arg(sum(x^m))/m`` and ``arg(sum(-x^4))/4`` (Mengali 5.7.4/5.7.5).
* Feedforward NDA ML timing estimator
  (``src/demodulation/timing_estimator.rs:13-113``, Mengali ch. 8.4):
  mix by ``exp(-j*pi*n/N)``, run parallel q-filter and ND-sample
  delay, ``-N * arg(sum(q .* d)) / (2*pi)`` samples.

All estimators are elementwise products + one reduction — VPU work
that XLA fuses; on a sharded time axis the sums become ``psum``.
The FM demod's lag-1 product is the 1-sample-halo op of the
framework (SURVEY.md section 5).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from comms_tpu.ops import taps as _taps

__all__ = [
    "fast_atan2",
    "fast_angle",
    "fm_demod_init",
    "fm_demod_block",
    "frequency_offset_estimate",
    "frequency_offset_estimate_planar",
    "psk_phase_estimate",
    "qam_phase_estimate",
    "TimingEstimator",
    "costas_loop_block",
]


def fast_atan2(y, x):
    """Octant-reduced degree-15 odd-polynomial atan2, 8.8e-8 rad max
    error; the fused FM kernel (kernels/fm_chain_pallas.py) calls it
    too.

    Why: ``jnp.angle``/``lax.atan2`` lowers to XLA's full-precision
    expansion, the largest stage of a per-sample demod chain.  This
    polynomial is cheaper at ~1e-7 rad, far inside the reference
    chains' 1e-3-rad parity budgets (analog.rs:22-34 uses f32::atan2 whose
    own error is ~1e-7).  IEEE signed-zero faithful on the x<0 branch
    cuts (atan2(+-0, -0) = +-pi) like the reference's f32::atan2.
    Estimator ops that feed tolerance-1e-6 oracles keep jnp.angle.
    """
    y = jnp.asarray(y, jnp.float32)
    x = jnp.asarray(x, jnp.float32)
    ax = jnp.abs(x)
    ay = jnp.abs(y)
    swap = ay > ax
    num = jnp.minimum(ax, ay)
    den = jnp.maximum(ax, ay)
    r = num / (den + jnp.float32(1e-30))
    r2 = r * r
    p = jnp.float32(-4.831168387e-03)
    p = p * r2 + jnp.float32(2.475678069e-02)
    p = p * r2 + jnp.float32(-6.021912799e-02)
    p = p * r2 + jnp.float32(9.967923619e-02)
    p = p * r2 + jnp.float32(-1.404013889e-01)
    p = p * r2 + jnp.float32(1.997368136e-01)
    p = p * r2 + jnp.float32(-3.333230283e-01)
    p = p * r2 + jnp.float32(9.999999582e-01)
    a = p * r
    a = jnp.where(swap, jnp.float32(np.pi / 2) - a, a)
    # signbit is exact for -0.0 AND for +-inf / |x| > 8.5e37, where a
    # 1/x sign probe fails (1/x flushes to -0.0, losing the sign -> a
    # pi-radian error); it is also cheaper than a division.
    neg_x = jnp.signbit(x)
    neg_y = jnp.signbit(y)
    a = jnp.where(neg_x, jnp.float32(np.pi) - a, a)
    return jnp.where(neg_y, -a, a)


def fast_angle(z):
    """:func:`fast_atan2` of a complex array's (im, re)."""
    return fast_atan2(jnp.imag(z), jnp.real(z))


def fm_demod_init(dtype=jnp.complex64):
    """Carried ``prev`` sample, zero-initialized (analog.rs:44-47)."""
    return jnp.zeros((), dtype=dtype)


def fm_demod_block(x, prev, fast: bool = False):
    """Quadrature FM demod of one block.  Returns ``(y, new_prev)``;
    y is real with the dtype of ``x.real``.

    ``fast``: use :func:`fast_atan2` (f32, 5e-7 rad) instead of the
    exact ``jnp.angle``, whose expansion dominates the demod stage.
    The default stays exact (this op is
    the reference-parity surface, oracle atol 1e-9 in f64)."""
    x = jnp.asarray(x)
    shifted = jnp.concatenate([prev[None].astype(x.dtype), x[:-1]])
    z = x * jnp.conj(shifted)
    y = fast_angle(z) if fast else jnp.angle(z)
    return y.astype(x.real.dtype), x[-1]


def frequency_offset_estimate(x):
    """Carrier-offset estimate in rad/sample (pre-matched-filter)."""
    x = jnp.asarray(x)
    acc = jnp.sum(x[1:] * jnp.conj(x[:-1]))
    return jnp.angle(acc)


def frequency_offset_estimate_planar(re, im):
    """Planar twin of :func:`frequency_offset_estimate` (re/im
    planes in) for pipelines that never materialize complex64."""
    ar = jnp.sum(re[1:] * re[:-1] + im[1:] * im[:-1])
    ai = jnp.sum(im[1:] * re[:-1] - re[1:] * im[:-1])
    return jnp.arctan2(ai, ar)


def psk_phase_estimate(symbols, m: int):
    """Mengali 5.7.4: ``arg(sum(x^m)) / m`` for M-PSK symbols."""
    x = jnp.asarray(symbols)
    return jnp.angle(jnp.sum(x ** int(m))) / float(m)


def qam_phase_estimate(symbols):
    """Mengali 5.7.5: ``arg(sum(-x^4)) / 4`` for square QAM."""
    x = jnp.asarray(symbols)
    return jnp.angle(jnp.sum(-(x ** 4))) / 4.0


def costas_loop_block(symbols, state, alpha: float, beta: float,
                      order: int = 4):
    """Decision-directed Costas carrier-tracking loop over one block.

    The closed-loop use of the reference's NCO (nco.rs:71-78: each
    step ``phase += dphase + perr``): a second-order loop where the
    M-th-power phase detector output drives the NCO.  The per-sample
    recurrence is irreducible, so it runs as a ``lax.scan`` — the one
    op class the block framework keeps sequential by design
    (SURVEY.md section 7, "hard parts"); track at symbol rate, off the
    sample-rate hot path.

    Args:
      symbols: [N] complex symbol-rate input.
      state: ``(phase, freq)`` float32 scalars (start ``(0, 0)``).
      alpha, beta: proportional / integrator gains.
      order: constellation order (4 = QPSK).

    Returns ``(corrected, (phase, freq))``.
    """
    x = jnp.asarray(symbols)
    phase0, freq0 = state

    def step(carry, s):
        ph, fr = carry
        c = s * jnp.exp(-1j * ph)
        # M-th power detector with the -x^M sign (as
        # qam_phase_estimate): for M-PSK at the +-1+-1j-style
        # constellation, c^M = -|c|^M at lock, so the error zero sits
        # at the constellation points, not the decision boundaries.
        err = jnp.angle(-(c ** order)) / order
        fr = fr + beta * err
        ph = ph + fr + alpha * err
        return (ph, fr), c

    (ph, fr), y = jax.lax.scan(step, (phase0, freq0), x)
    return y, (ph, fr)


class TimingEstimator:
    """Feedforward NDA ML timing estimator (Mengali ch. 8.4).

    Mirrors the reference construction (timing_estimator.rs:42-58):
    q-filter = ``qfilt_taps(2*N*D + 1, alpha, N)``; delay filter =
    ND zeros followed by 1 (a pure ND-sample delay).  Each ``push``
    uses fresh zero filter state (timing_estimator.rs:97-103), so the
    estimate is a pure function of the block — ideal for jit.

    Formulation — correlation GEMM.  The reference computes
    ``s = sum_m qout[m] * din[m-ND]`` with ``qout = FIR_q(conj(x)*r)``
    and ``din = x*r`` (``r[k] = exp(-j*pi*k/N)``), which needs three
    materialized full-rate intermediates plus an unaligned
    product-reduce (the receiver's hottest stage).  Exchanging the
    sums,

        s = sum_t q[t] * exp(-j*pi*(ND-t)/N) * g[ND-t],
        g[u] = sum_k r2[k] * x[k] * conj(x[k+u]),   u in [-ND, ND],
        r2[k] = exp(-2j*pi*k/N)   (period N),

    and the 2ND+1 lagged correlations ``g`` come from ONE small-output
    GEMM: with ``V[row, j] = (r2*x)[128*row + j]`` (zero-padded past
    k = len-ND) and ``W[row, i] = conj(x)[128*row + i - ND]``,
    ``E = V^T @ W`` is [128, 128+2ND] and ``g[u]`` is the sum of E's
    ``(ND+u)``-offset diagonal.  Nothing full-rate is ever written:
    both GEMM operands are shifted reshapes of the input planes, and
    when ``N | 128`` the r2 rotation moves BEHIND the GEMM (r2 depends
    only on ``j = k mod 128`` there, so ``V^T W = diag(c2)(re^T W) +
    diag(s2)(im^T W)`` — the GEMMs read the raw planes).
    Numpy-validated to 3e-14 against the direct form.

    GEMM precision: f32 inputs default to the device's default
    matmul precision (reduced-precision operands on accelerators) —
    measured estimate shift <= 1.2e-4 samples on delayed-QPSK signals
    (the reference's own tolerance is 0.01, timing_estimator.rs:191);
    the estimate feeds an angle, so split-f32 passes buy nothing.
    f64 inputs (CPU parity path) always run HIGHEST.  Pass
    ``precision`` to override.
    """

    def __init__(self, n: int, d: int, alpha: float,
                 precision=None):
        if not 0.0 <= alpha <= 1.0:
            raise _taps.InvalidRolloffError(f"alpha={alpha} not in [0, 1]")
        self.n = int(n)
        self.d = int(d)
        self.alpha = float(alpha)
        self.precision = precision
        q = _taps.qfilt_taps(2 * self.n * self.d + 1, alpha, self.n)
        # q(t) is real (math.rs:307-342).
        self.qfilt = np.real(q).astype(np.float64)
        # Host-folded weights: s = sum_u wq[u+ND] * g[u] with
        # wq[u+ND] = q[ND-u] * exp(-j*pi*u/N).
        nd = self.n * self.d
        u = np.arange(-nd, nd + 1, dtype=np.float64)
        self._wq = (self.qfilt[nd - u.astype(int)]
                    * np.exp(-1j * np.pi * u / self.n))

    LANES = 128

    def corr_panels(self, re, im, halfwidth: int | None = None):
        """Raw correlation panels of one block's re/im planes.

        Returns ``(P1, P2, P3, P4, meta)`` with
        ``P1 = rev^T @ Wr`` etc., where ``rev/imv`` are the planes
        reshaped to [R, 128] rows (zero-padded past k = N-HW) and
        ``Wr/Wi`` are 128-stride windows of ``conj(x)``'s planes at
        offset ``-HW``, width ``128 + 2*HW``.  Every lagged-product
        statistic of the block with |lag| <= HW is a diagonal
        functional of these four small [128, width] matrices — the
        timing estimate consumes them via the r2 rotation, and
        qpsk_rx reuses the SAME panels for its frequency estimate and
        per-phase interpolated energies, so the block is read exactly
        once for all of them.

        ``halfwidth`` (default ND = n*d) sets the max |lag| HW —
        qpsk_rx widens it to ND + mf_taps - 1 so matched-filter
        correlations fold into host weights (the GEMMs' cost is
        operand reads, measured width-insensitive at 168 vs 230).

        The GEMMs run as per-piece dots on shifted reshapes — a
        concatenated [R, width] window MATERIALIZES (measured 2.38 ->
        1.51 ms at 33.5M samples; PERF lesson 9 at the XLA level).
        """
        lanes = self.LANES
        hw = self.n * self.d if halfwidth is None else int(halfwidth)
        N = int(re.shape[0])
        fdt = re.dtype
        K = N - hw
        R = -(-K // lanes)
        Kp = lanes * R
        width = lanes + 2 * hw
        prec = self.precision
        if prec is None:
            prec = (jax.lax.Precision.DEFAULT if fdt == jnp.float32
                    else jax.lax.Precision.HIGHEST)
        rev = jnp.pad(re[:K], (0, Kp - K)).reshape(R, lanes)
        imv = jnp.pad(im[:K], (0, Kp - K)).reshape(R, lanes)
        # W rows: conj(x) at offset -HW, padded so every piece's
        # dynamic slice is in range.  The imag W plane is +im, NOT
        # -im: the conj negation moves onto the tiny panel outputs so
        # the big operand is a pure pad of the input.
        need = (R - 1) * lanes + (-(-width // lanes)) * lanes
        Wr_flat = jnp.pad(re, (hw, max(need - hw - N, 0)))
        Wi_flat = jnp.pad(im, (hw, max(need - hw - N, 0)))
        # Stacked-V dots: ONE [R, 256] operand holding rev|imv gives
        # two panels per dot ([256, w] splits into the rev / imv
        # halves) — 4 dots instead of 8, halving the window-piece
        # operand traffic (these GEMMs are read-bound: 128x230-ish
        # outputs against an R-deep contraction).
        V2 = jnp.concatenate([rev, imv], axis=1)   # [R, 2*lanes]

        def panel2(Wflat):
            tops, bots = [], []
            off = 0
            while off < width:
                w = min(lanes, width - off)
                chunk = jax.lax.dynamic_slice_in_dim(Wflat, off,
                                                     R * lanes)
                Wp = chunk.reshape(R, lanes)[:, :w]
                E2 = jnp.dot(V2.T, Wp, precision=prec)  # [2*lanes, w]
                tops.append(E2[:lanes])
                bots.append(E2[lanes:])
                off += w
            return (jnp.concatenate(tops, axis=1),
                    jnp.concatenate(bots, axis=1))

        P1, P3 = panel2(Wr_flat)
        P2n, P4n = panel2(Wi_flat)
        P2, P4 = -P2n, -P4n          # conj(x): imag plane negated
        meta = {"nd": hw, "K": K, "Kp": Kp, "R": R, "width": width,
                "fdt": fdt, "prec": prec, "rev": rev, "imv": imv,
                "Wr_flat": Wr_flat, "Wi_flat": jnp.negative(Wi_flat)}
        return P1, P2, P3, P4, meta

    def lag_sums_r2(self, panels):
        """r2-rotated lagged-correlation sums ``(gr, gi)`` over
        lag v in [-HW, HW]: ``g[v] = sum_k r2[k] x[k] conj(x[k+v])``
        with ``r2[k] = exp(-2j*pi*k/N)`` — the statistic the Mengali
        estimate weights.  The r2 rotation is applied AFTER the GEMMs
        when it collapses to a function of j = k mod 128 (128 % N
        == 0), else as a per-row-tile multiply before piecewise dots.
        """
        P1, P2, P3, P4, meta = panels
        lanes = self.LANES
        hw, fdt = meta["nd"], meta["fdt"]
        if lanes % self.n == 0:
            ph = 2.0 * np.pi * np.arange(lanes, dtype=np.float64) / self.n
            c2 = jnp.asarray(np.cos(ph).astype(fdt))[:, None]
            s2 = jnp.asarray(np.sin(ph).astype(fdt))[:, None]
            Er = (c2 * P1 + s2 * P3) - (c2 * P4 - s2 * P2)
            Ei = (c2 * P2 + s2 * P4) + (c2 * P3 - s2 * P1)
        else:
            prec = meta["prec"]
            rev, imv = meta["rev"], meta["imv"]
            Wr_flat, Wi_flat = meta["Wr_flat"], meta["Wi_flat"]
            R, width = meta["R"], meta["width"]
            ph = (2.0 * np.pi * np.arange(meta["Kp"], dtype=np.float64)
                  / self.n).reshape(R, lanes)
            c2 = jnp.asarray(np.cos(ph).astype(fdt))
            s2 = jnp.asarray(np.sin(ph).astype(fdt))
            Vr = rev * c2 + imv * s2
            Vi = imv * c2 - rev * s2

            def panel(V, Wflat):
                pieces = []
                off = 0
                while off < width:
                    w = min(lanes, width - off)
                    chunk = jax.lax.dynamic_slice_in_dim(
                        Wflat, off, R * lanes)
                    Wp = chunk.reshape(R, lanes)[:, :w]
                    pieces.append(jnp.dot(V.T, Wp, precision=prec))
                    off += w
                return jnp.concatenate(pieces, axis=1)

            Er = panel(Vr, Wr_flat) - panel(Vi, Wi_flat)
            Ei = panel(Vr, Wi_flat) + panel(Vi, Wr_flat)
        # g[v] = sum_j E[j, j + HW + v]: offset-diagonal sums of the
        # small [lanes, width] result.
        cols = (np.arange(lanes)[:, None]
                + np.arange(2 * hw + 1)[None, :])   # j + (HW+v)
        cols_j = jnp.asarray(cols)
        gr = jnp.sum(jnp.take_along_axis(Er, cols_j, axis=1), axis=0)
        gi = jnp.sum(jnp.take_along_axis(Ei, cols_j, axis=1), axis=0)
        return gr, gi

    def estimate_from_panels(self, panels, weights=None, lag_rot=None):
        """Timing estimate from :meth:`corr_panels` output.

        ``weights``: host complex weight vector over lag v in
        [-HW, HW] replacing the default q-filter fold ``self._wq``
        (which requires HW == ND) — qpsk_rx passes the matched-filter
        autocorrelation fold so the panels can sit on the RAW signal.
        ``lag_rot``: optional TRACED scalar w; g[v] is rotated by
        ``exp(j*w*v)`` before weighting — the exact fold of a
        carrier de-rotation ``x * exp(-j*w*k)`` into the statistic.
        """
        _P1, _P2, _P3, _P4, meta = panels
        hw, fdt = meta["nd"], meta["fdt"]
        gr, gi = self.lag_sums_r2(panels)
        if weights is None:
            if hw != self.n * self.d:
                raise ValueError(
                    "widened panels need an explicit weight vector")
            weights = self._wq
        wq = np.asarray(weights)
        if wq.shape[0] != 2 * hw + 1:
            raise ValueError(f"weights must cover 2*HW+1 = {2*hw+1} "
                             f"lags, got {wq.shape[0]}")
        wr = jnp.asarray(np.real(wq).astype(fdt))
        wi = jnp.asarray(np.imag(wq).astype(fdt))
        if lag_rot is not None:
            v = jnp.asarray(np.arange(-hw, hw + 1), fdt)
            cv = jnp.cos(lag_rot * v)
            sv = jnp.sin(lag_rot * v)
            gr, gi = gr * cv - gi * sv, gr * sv + gi * cv
        s_re = jnp.sum(wr * gr - wi * gi)
        s_im = jnp.sum(wr * gi + wi * gr)
        return (-float(self.n) * jnp.arctan2(s_im, s_re)
                / (2.0 * np.pi)).astype(fdt)

    def estimate_planar(self, re, im):
        """Timing estimate from re/im planes (planar entry point)."""
        nd = self.n * self.d
        if int(re.shape[0]) <= nd:
            # Reference semantics: empty product sum -> angle(0) = 0.
            return jnp.zeros((), re.dtype)
        return self.estimate_from_panels(self.corr_panels(re, im))

    def estimate(self, samples):
        """Timing estimate in samples for one block (push semantics)."""
        x = jnp.asarray(samples)
        return self.estimate_planar(jnp.real(x), jnp.imag(x))

    __call__ = estimate
