"""Time-sharded QPSK receiver: distributed synchronization.

The reference ships its estimators as single-threaded nodes
(frequency_estimator.rs / phase_estimator.rs / timing_estimator.rs);
SURVEY.md section 2.4 maps estimator reductions to ``psum``.  This
module makes that real for the FULL receiver: the round-4 fused core
(models/qpsk_rx.py) splits over a time mesh with

* **global estimates from psum'd correlation panels** — each shard
  computes the [128, 128+2*HW] panels of ITS slice of the raw planes
  (the only full-rate work), and ONE ``psum`` of the four tiny panel
  matrices makes every downstream statistic — coarse carrier, Mengali
  timing with the matched-filter fold, per-phase symbol energies —
  GLOBAL (sums over k are additive; per-shard edge truncation loses
  O(HW / N_shard) cross-boundary lag products, the same class of edge
  term the single-chip core already carries);
* **per-shard fused symbol GEMM** with the left neighbor's raw tail
  as carried context (one ring ``ppermute`` of MD-1 samples — the
  overlap-save halo), so the global symbol grid is GAP-FREE across
  shard boundaries;
* **global phase coherence**: the de-rotation identity needs the
  GLOBAL sample index, so each shard's symbol-rate outer rotation
  starts at ``phase0 = w * shard_start`` (and the fine-carrier stage
  likewise psums its 4th-power sums and rotates from the shard's
  global symbol offset) — every shard applies the SAME carrier/phase
  corrections, no per-shard quadrant ambiguity.

Collectives: 2 psums of [128, ~230] panels + 2 scalar-psum pairs +
one MD-1-sample ppermute — trivial next to the N/n_shards of
local work.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from comms_tpu.models import qpsk_rx as _rx
from comms_tpu.ops import demodulation

__all__ = ["make_sharded_rx_step"]


def make_sharded_rx_step(cfg: "_rx.QpskRxConfig", mesh: Mesh,
                         axis: str = "time"):
    """Returns jitted ``(re[N], im[N]) -> (sym_planes[2, N/sps],
    diag)`` with the inputs and the symbol planes sharded over
    ``axis``.  ``cfg.sps`` must satisfy the fused core's constraint
    (4 <= sps, sps | 128); the per-shard length must be a MULTIPLE of
    sps (validated).

    Semantics: the one-shot fused receiver over the WHOLE block with
    globally-exact-up-to-edge-terms estimates; symbols match the
    single-device ``qpsk_rx._rx_core_fused`` to estimator-edge-term
    precision (bit-comparable interiors, zero BER in the loopback
    test on the 8-device CPU mesh).
    """
    n = mesh.shape[axis]
    sps = cfg.sps
    lanes = demodulation.TimingEstimator.LANES
    if not (4 <= sps <= lanes and lanes % sps == 0):
        raise ValueError(f"sharded rx needs 4 <= sps | {lanes}, "
                         f"got {sps}")
    hw = cfg.panel_hw
    C = _rx.fused_gemm_ctx_len(cfg)

    def local(re_l, im_l):
        nloc = int(re_l.shape[0])
        if nloc % sps:
            # local k mod sps must equal global k mod sps — the r2
            # lag rotation, the per-phase energy fold and the global
            # symbol grid all assume it (review catch: an indivisible
            # shard ran silently to wrong symbols)
            raise ValueError(
                f"per-shard length {nloc} must be a multiple of "
                f"sps={sps}")
        if nloc * n >= 2 ** 31:
            raise ValueError("global block >= 2^31 samples overflows "
                             "the int32 position grid")
        idx = lax.axis_index(axis)
        idx_f = idx.astype(jnp.float32)
        ntot = nloc * n
        two_pi = jnp.float32(2.0 * np.pi)

        # --- panels on the local slice; ONE (batched) psum makes
        # them global.
        P1, P2, P3, P4, meta = cfg.timing.corr_panels(re_l, im_l,
                                                      halfwidth=hw)
        P1, P2, P3, P4 = lax.psum((P1, P2, P3, P4), axis)
        panels = (P1, P2, P3, P4, meta)
        f_est, t_est, lag, shift, p_star = _rx._estimates_from_panels(
            cfg, panels)
        shift2 = jnp.clip(shift - p_star, -sps, 2 * sps - 4)

        # --- per-shard symbol GEMM: left neighbor's raw tail as
        # context (overlap-save), global de-rotation phase.  The
        # phase anchor is reduced mod 2*pi PER FACTOR (idx * nloc as
        # a raw f32 product loses index precision past 2^24 and the
        # int32 form overflows past 2^31 — review catch).
        from comms_tpu.parallel import sharding as sh

        zc = jnp.zeros((C,), jnp.float32)
        ctx_r = sh.halo_exchange(re_l, zc, C, axis)
        ctx_i = sh.halo_exchange(im_l, zc, C, axis)
        phase0 = jnp.mod(
            jnp.mod(f_est * jnp.float32(nloc), two_pi) * idx_f, two_pi)
        sr, si = _rx._fused_symbol_gemm(
            cfg, re_l, im_l, f_est, lag, shift2,
            ctx=(ctx_r, ctx_i), phase0=phase0)

        # --- the one-shot core's edge mask, at GLOBAL positions
        # (head transient on shard 0, shifted-off-the-end tail on the
        # last shard only).
        m4 = (jnp.arange(sr.shape[0]) + idx * (nloc // sps)) * sps
        lo = 3 + jnp.maximum(shift2, 0)
        hi = ntot + jnp.minimum(shift2, 0)
        valid = (m4 >= lo) & (m4 < hi)
        sr = jnp.where(valid, sr, 0.0)
        si = jnp.where(valid, si, 0.0)

        # --- fine carrier + Mengali phase: the SHARED symbol tail
        # with psum'd estimator sums and this shard's global symbol
        # offset anchoring the rotation.
        mloc = sr.shape[0]
        sym, dtail = _rx._symbol_tail(
            sr, si,
            reduce=lambda v: lax.psum(v, axis),
            sym_offset=(jnp.float32(mloc), idx_f))
        diag = {"freq": f_est, "timing": t_est, "sym_phase": p_star,
                **dtail}
        return sym, diag

    fn = shard_map(
        local, mesh=mesh,
        in_specs=(P(axis), P(axis)),
        out_specs=(P(None, axis), P()),
        check_vma=False,
    )
    return jax.jit(fn)
