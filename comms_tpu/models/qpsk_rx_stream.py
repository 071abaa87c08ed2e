"""Streaming QPSK receiver: continuous synchronization over a block
stream.

The one-shot receiver (``models/qpsk_rx.py``) estimates afresh per
block and zeroes its roll-wrap region; this model is the *streaming*
counterpart the reference's node forms imply (TimingEstimatorNode
``/root/reference/src/demodulation/timing_estimator.rs:116-137``, the
closed-loop NCO ``src/demodulation/nco.rs:84-134``): every estimate is
a carried state smoothed across blocks, the matched filter carries its
tail, and the symbol grid is continuous across block seams — gap-free
output with a constant 2-symbol latency, no zeroed regions.

Architecture (one jitted block step; all state in an explicit pytree):

1. **Coarse carrier**: per-block pre-MF lag-1 frequency estimate
   (Meyr 8.2.2) smoothed by an EMA into a carried ``omega``; the
   de-rotation phase ``theta`` is carried so the mixer is continuous
   even while ``omega`` adapts.
2. **Matched filter**: streaming RRC FIR (carried tail).
3. **Timing**: Mengali 8.4 NDA estimate per block.  Measured fact
   (see tests): the optimum sampling phase is ``t_est mod sps``
   exactly, so the carried phase ``tau`` EMA-tracks it with
   wrap-aware updates.  Symbols are interpolated at stream positions
   ``m*sps + tau`` with a cubic Lagrange over the carried 12-sample
   context — block seams need no rolls and produce no gaps.
4. **Fine carrier**: decision-directed Costas loop at symbol rate
   (``ops/demodulation.costas_loop_block`` — the reference NCO closed
   loop), carried ``(phase, freq)``; absorbs residual offsets and
   mid-stream frequency steps.

The 4-fold phase ambiguity and the constant pipeline lag are resolved
by the caller (``qpsk_rx.resolve_ambiguity``), as in a pilot-based
system.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from comms_tpu.ops import demodulation, fir, taps

__all__ = ["QpskRxStreamConfig", "make_stream_fn", "init_state",
           "make_stream_fast_fn", "init_state_fast",
           "make_stream_split_fns", "make_split_serving_step"]

_TWO_PI = 2.0 * np.pi


class QpskRxStreamConfig:
    """Streaming receiver for the qpsk_tx waveform (RRC, sps, beta).

    ``block``: input samples per step (multiple of sps).
    ``costas_alpha/beta``: symbol-rate loop gains (proportional /
    integrator).  ``g_freq``/``g_tau``: per-block EMA gains for the
    coarse carrier and timing phases.
    """

    def __init__(self, block: int = 8192, sps: int = 4,
                 num_taps: int = 32, beta: float = 0.25,
                 timing_d: int = 5, costas_alpha: float = 0.1,
                 costas_beta: float = 0.005, g_freq: float = 0.2,
                 g_tau: float = 0.25):
        if block % sps:
            raise ValueError(f"block {block} must be a multiple of sps {sps}")
        self.block = int(block)
        self.sps = int(sps)
        # interpolator left context: the 2-symbol emission latency plus
        # the cubic window must stay inside [ctx ++ block] for every
        # tau in [0, sps) — min index is -2*sps + 3 relative the block.
        self.L_CTX = max(12, 2 * self.sps + 4)
        self.num_taps = int(num_taps)
        self.beta = float(beta)
        self.costas_alpha = float(costas_alpha)
        self.costas_beta = float(costas_beta)
        self.g_freq = float(g_freq)
        self.g_tau = float(g_tau)
        t = taps.rrc_taps(num_taps, float(sps), beta)
        t = t / np.sqrt(np.sum(np.abs(t) ** 2))
        self.mf = fir.banded_tap_matrix(t.astype(np.complex64))
        self.timing = demodulation.TimingEstimator(
            n=self.sps, d=int(timing_d), alpha=self.beta)

    @property
    def syms_per_block(self) -> int:
        return self.block // self.sps


def init_state(cfg: QpskRxStreamConfig):
    """Boundary-safe state pytree (complex tails as f32 pairs)."""
    return {
        "mf_ctx": jnp.zeros((cfg.num_taps - 1, 2), jnp.float32),
        "interp_ctx": jnp.zeros((cfg.L_CTX, 2), jnp.float32),
        "theta": jnp.zeros((), jnp.float32),     # mixer phase (carried)
        "omega": jnp.zeros((), jnp.float32),     # rad/sample coarse carrier
        "tau": jnp.zeros((), jnp.float32),       # sampling phase in [0,sps)
        "costas": (jnp.zeros((), jnp.float32), jnp.zeros((), jnp.float32)),
        "warm": jnp.zeros((), jnp.float32),      # 0 = first block
    }


def _wrap_pi(a):
    return jnp.mod(a + jnp.pi, _TWO_PI) - jnp.pi


def make_stream_fn(cfg: QpskRxStreamConfig):
    """jitted ``(state, iq_pairs_f32[N, 2]) -> (sym_pairs_f32[M, 2],
    new_state)`` with M = N/sps symbols per block, gap-free."""
    sps = cfg.sps
    N = cfg.block
    M = cfg.syms_per_block
    L = cfg.L_CTX
    half = float(sps) / 2.0

    @jax.jit
    def step(state, iq_pairs):
        x = jax.lax.complex(iq_pairs[:, 0], iq_pairs[:, 1])
        warm = state["warm"]

        # -- 1. coarse carrier (EMA; first block takes the raw estimate)
        f_b = demodulation.frequency_offset_estimate(x).astype(jnp.float32)
        omega = jnp.where(
            warm > 0,
            state["omega"] + cfg.g_freq * _wrap_pi(f_b - state["omega"]),
            f_b)
        k = jnp.arange(N, dtype=jnp.float32)
        xc = x * jnp.exp(-1j * (state["theta"] + omega * k))
        theta = jnp.mod(state["theta"] + omega * N, jnp.float32(_TWO_PI))

        # -- 2. matched filter (streaming)
        mf_ctx = jax.lax.complex(state["mf_ctx"][:, 0],
                                 state["mf_ctx"][:, 1])
        y, mf_ctx = fir.fir_block(xc, cfg.mf, mf_ctx)

        # -- 3. timing: NDA estimate -> EMA'd sampling phase tau
        t_b = cfg.timing.estimate(y).astype(jnp.float32)
        tau_b = jnp.mod(t_b, jnp.float32(sps))
        d = jnp.mod(tau_b - state["tau"] + half, jnp.float32(sps)) - half
        tau = jnp.where(warm > 0,
                        jnp.mod(state["tau"] + cfg.g_tau * d,
                                jnp.float32(sps)),
                        tau_b)

        # -- interpolate the continuous symbol grid m*sps + tau
        # (2-symbol latency keeps every cubic window inside
        # [ctx_L ++ block]).
        ictx = jax.lax.complex(state["interp_ctx"][:, 0],
                               state["interp_ctx"][:, 1])
        y_ext = jnp.concatenate([ictx, y])
        u = (jnp.arange(M, dtype=jnp.float32) - 2.0) * sps + tau + L
        base = jnp.floor(u).astype(jnp.int32)
        mu = (u - base.astype(jnp.float32)).astype(jnp.float32)
        p0 = jnp.take(y_ext, base - 1)
        p1 = jnp.take(y_ext, base)
        p2 = jnp.take(y_ext, base + 1)
        p3 = jnp.take(y_ext, base + 2)
        muc = mu.astype(y_ext.dtype)
        w0 = -muc * (muc - 1) * (muc - 2) / 6
        w1 = (muc + 1) * (muc - 1) * (muc - 2) / 2
        w2 = -(muc + 1) * muc * (muc - 2) / 2
        w3 = (muc + 1) * muc * (muc - 1) / 6
        sym_raw = w0 * p0 + w1 * p1 + w2 * p2 + w3 * p3

        # -- 4. fine carrier: decision-directed Costas at symbol rate
        sym, costas = demodulation.costas_loop_block(
            sym_raw, state["costas"], cfg.costas_alpha, cfg.costas_beta,
            order=4)

        new_state = {
            "mf_ctx": jnp.stack(
                [jnp.real(mf_ctx), jnp.imag(mf_ctx)], axis=-1),
            "interp_ctx": jnp.stack(
                [jnp.real(y[-L:]), jnp.imag(y[-L:])], axis=-1),
            "theta": theta,
            "omega": omega,
            "tau": tau,
            "costas": costas,
            "warm": jnp.ones((), jnp.float32),
        }
        sym_pairs = jnp.stack([jnp.real(sym), jnp.imag(sym)], axis=-1)
        return sym_pairs.astype(jnp.float32), new_state

    return step


# --------------------------------------------------------------------
# Fast streaming receiver: ESTIMATE PIPELINING (round 4)
# --------------------------------------------------------------------

def init_state_fast(cfg):
    """State for :func:`make_stream_fast_fn` (``cfg`` is a
    ``qpsk_rx.QpskRxConfig``): carried raw-tail planes for the fused
    symbol GEMM plus the previous block's estimates."""
    from comms_tpu.models import qpsk_rx as _rx

    C = _rx.fused_gemm_ctx_len(cfg)
    z = jnp.zeros((C,), jnp.float32)
    return {
        "ctx_re": z, "ctx_im": z,
        "omega": jnp.zeros((), jnp.float32),
        "theta": jnp.zeros((), jnp.float32),
        "lag": jnp.zeros((4,), jnp.float32).at[1].set(1.0),
        "shift2": jnp.zeros((), jnp.int32),
        "fphase": jnp.zeros((), jnp.float32),   # fine-carrier phase
        "pfine": jnp.zeros((), jnp.float32),    # unwrapped phase est
        "warm": jnp.zeros((), jnp.float32),
    }


def make_stream_fast_fn(cfg=None):
    """Throughput-oriented streaming receiver: jitted
    ``(state, re[N], im[N]) -> (sym_planes[2, N/sps], state)``.

    ESTIMATE PIPELINING (the lever docs/PERF.md's QPSK section
    identifies): block k's FULL-RATE work — the single fused
    complex-tap decimating GEMM over the raw planes — runs with block
    k-1's carried estimates, so NO full-rate operand is gated on a
    data-dependent scalar (each such gate measured ~+1 ms of
    scheduling stall per block at 33.5M samples); block k's
    correlation panels update the estimates for block k+1.  The
    carried raw tail (`qpsk_rx.fused_gemm_ctx_len` samples) makes the
    symbol grid gap-free across seams; the carried ``theta`` keeps
    the de-rotation phase continuous.

    Semantics: per-block raw estimates, carried one block (at serving
    block sizes the estimator variance is microscopic, so smoothing
    gains nothing; a drifting channel re-converges one block late).
    Block 0 is a warm-up block (zero estimates, zero context) —
    discard its symbols.  Fine carrier/phase (4th-power) run
    block-locally at symbol rate, as in the one-shot receiver.
    """
    from comms_tpu.models import qpsk_rx as _rx

    cfg = cfg if cfg is not None else _rx.QpskRxConfig()
    sps = cfg.sps
    C = _rx.fused_gemm_ctx_len(cfg)

    @jax.jit
    def step(state, re, im):
        n = re.shape[0]
        # --- full-rate symbol path with the CARRIED estimates.
        sr, si = _rx._fused_symbol_gemm(
            cfg, re, im, state["omega"], state["lag"], state["shift2"],
            ctx=(state["ctx_re"], state["ctx_im"]),
            phase0=state["theta"])

        # --- fine carrier/phase at symbol rate, PHASE-CONTINUOUS
        # across blocks: the shared _symbol_tail with the carried
        # fine phase and the mod-pi/2 ambiguity unwrap (a stream must
        # not jump quadrants at seams).
        sym_planes, dtail = _rx._symbol_tail(
            sr, si, fphase=state["fphase"], pfine=state["pfine"],
            warm=state["warm"])
        fphase = dtail["fphase_next"]
        p_eff = dtail["phase"]

        # --- this block's estimates (panels on the raw planes) for
        # the NEXT block.
        f_b, _t_b, lag_b, shift_b, p_sym = _rx._panel_estimates(
            cfg, re, im)
        new_state = {
            "ctx_re": re[-C:],
            "ctx_im": im[-C:],
            "omega": f_b,
            # phase continuity: the block we JUST processed advanced
            # the carried phase by omega * N.
            "theta": jnp.mod(state["theta"] + state["omega"] * n,
                             jnp.float32(2.0 * np.pi)),
            "lag": lag_b,
            # same hard tap-window bounds as the one-shot fused core
            "shift2": jnp.clip(shift_b - p_sym, -cfg.sps,
                               2 * cfg.sps - 4),
            "fphase": fphase,
            "pfine": p_eff,
            "warm": jnp.ones((), jnp.float32),
        }
        return sym_planes, new_state

    return step


def make_stream_split_fns(cfg=None):
    """TWO-DISPATCH streaming receiver: the decoupled-pair form of
    :func:`make_stream_fast_fn` — identical state pytree, identical
    outputs, but the two full-rate stages run as SEPARATE jitted
    programs the serving loop dispatches back-to-back:

        sym, state = sym_fn(state, re, im)     # fused symbol GEMM+tail
        omega, lag, shift2 = est_fn(re, im)    # panels -> next block
        state = {**state, "omega": omega, "lag": lag, "shift2": shift2}

    Why: co-residency of the two full-rate stages (the symbol GEMM
    and the correlation panels) in ONE XLA program can serialize
    their scheduling; as two programs each stage runs alone.  The
    extra dispatch's host cost hides behind device compute in any
    depth>=2 serving loop (``runtime.StreamRunner``).

    The merge is a host-side dict update of device arrays — no sync,
    no transfer.  Estimate pipelining semantics are unchanged: block
    k's symbols use block k-1's estimates.  Returns
    ``(sym_fn, est_fn)``; state comes from :func:`init_state_fast`.
    """
    from comms_tpu.models import qpsk_rx as _rx

    cfg = cfg if cfg is not None else _rx.QpskRxConfig()
    C = _rx.fused_gemm_ctx_len(cfg)

    @jax.jit
    def sym_fn(state, re, im):
        n = re.shape[0]
        sr, si = _rx._fused_symbol_gemm(
            cfg, re, im, state["omega"], state["lag"], state["shift2"],
            ctx=(state["ctx_re"], state["ctx_im"]),
            phase0=state["theta"])
        sym_planes, dtail = _rx._symbol_tail(
            sr, si, fphase=state["fphase"], pfine=state["pfine"],
            warm=state["warm"])
        new_state = {
            "ctx_re": re[-C:],
            "ctx_im": im[-C:],
            # estimates stay as-is; est_fn's outputs overwrite them.
            "omega": state["omega"],
            "theta": jnp.mod(state["theta"] + state["omega"] * n,
                             jnp.float32(2.0 * np.pi)),
            "lag": state["lag"],
            "shift2": state["shift2"],
            "fphase": dtail["fphase_next"],
            "pfine": dtail["phase"],
            "warm": jnp.ones((), jnp.float32),
        }
        return sym_planes, new_state

    @jax.jit
    def est_fn(re, im):
        f_b, _t_b, lag_b, shift_b, p_sym = _rx._panel_estimates(
            cfg, re, im)
        shift2 = jnp.clip(shift_b - p_sym, -cfg.sps, 2 * cfg.sps - 4)
        return f_b, lag_b, shift2

    return sym_fn, est_fn


def make_split_serving_step(cfg=None):
    """Serving-loop form of :func:`make_stream_split_fns`: a
    ``runtime.StreamRunner``-compatible host step
    ``(state, (re, im)) -> (sym_planes, state)`` that enqueues the two
    programs back-to-back with NO host sync between them — the
    estimate merge is a dict update of device-array futures.

    The symbol GEMM and the correlation panels each run as their own
    XLA program, so neither pays the co-residency serialization of
    sharing one program, and neither full-rate stage
    is gated on the other's data-dependent scalars (estimate
    pipelining: block k's symbols use block k-1's estimates, as in
    ``make_stream_fast_fn``).  The reference analogue is its per-node
    thread pipeline overlapping estimator and data-path nodes
    (``src/node/mod.rs:275-284``) — here the overlap comes from the
    device queue, not threads.

    Whether the second dispatch costs more than the co-residency it
    saves depends on the host's launch cost; on the GPU it is not
    measured yet (ROADMAP.md).

    State comes from :func:`init_state_fast`; block 0 is warm-up
    (discard its symbols).  Outputs are bit-identical to driving
    ``make_stream_split_fns`` by hand and match
    ``make_stream_fast_fn`` to float tolerance (tested).
    """
    sym_fn, est_fn = make_stream_split_fns(cfg)

    def step(state, x):
        re, im = x
        sym, state = sym_fn(state, re, im)
        omega, lag, shift2 = est_fn(re, im)
        return sym, {**state, "omega": omega, "lag": lag,
                     "shift2": shift2}

    return step
