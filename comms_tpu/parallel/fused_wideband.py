"""Sharded fused FM chain: the single-kernel chain, per device.

The fused FM kernel (:mod:`comms_tpu.kernels.fm_chain_pallas` —
interleaved u8 IQ in, audio out) runs per shard under ``shard_map``
over a 1-D time mesh, with each shard's carried context derived from
its left neighbor's RAW input tail.

This is exact because the kernel's only carried state is the last
``FUSED_TAIL_SAMPLES`` raw samples before a block
(:func:`comms_tpu.models.fm_receiver.fused_ctx_from_raw_tail`).  A
shard boundary IS a block boundary, so one ``ppermute`` of the u8
tails (2 x 512 B per boundary, neighbor-only traffic) yields the same
context as a sequential run of ``make_fused_block_fn`` over
per-shard-sized blocks.  Shard 0 uses the carried stream state
instead; the next block's stream state is the global tail (last
shard).

Reference role: the whole-graph concurrency of
comms-rs ``src/node/mod.rs:275-284`` scaled to several devices —
every device runs the complete chain on its time slice instead of one
thread per node on one machine.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from comms_tpu.kernels import fm_chain_pallas as _K
from comms_tpu.models import fm_receiver

__all__ = ["make_sharded_fused_step", "fused_init_state", "TAIL_SAMPLES"]

TAIL_SAMPLES = fm_receiver.FUSED_TAIL_SAMPLES

# re-export so callers need one module
fused_init_state = fm_receiver.fused_init_state


def make_sharded_fused_step(mesh: Mesh, block: int, axis: str = "time",
                            interpret: bool = False):
    """jitted ``(state, iq_u8[N, 2]) -> (audio[N/25], state)`` with the
    interleaved u8 IQ and the audio sharded over ``axis``.

    ``state`` is the fused chain's state (replicated;
    :func:`fused_init_state` at stream start) — interchangeable with
    the single-device ``make_fused_block_fn`` state, so a stream can
    move between one device and a mesh mid-flight.  ``interpret`` runs
    the kernel in the Pallas interpreter (CPU tests).
    """
    n = mesh.shape[axis]
    if block % n:
        raise ValueError(f"block {block} must divide over {n} shards")
    local_n = block // n
    if local_n % fm_receiver.FUSED_BLOCK_QUANTUM:
        raise ValueError(
            f"per-shard length {local_n} must be a multiple of the "
            f"kernel quantum {fm_receiver.FUSED_BLOCK_QUANTUM}")

    def local(state, iq_l):
        idx = lax.axis_index(axis)
        tail = iq_l[-TAIL_SAMPLES:]
        if n > 1:
            tail = lax.ppermute(tail, axis,
                                perm=[(i, i + 1) for i in range(n - 1)])
        # shard 0's left context is the carried stream state
        # (ppermute delivered zeros there).
        ctx = jnp.where(idx == 0, state,
                        fm_receiver.fused_ctx_from_raw_tail(tail))
        return _K.fm_chain_fused(iq_l, ctx, fm_receiver.FM_LPF_TAPS,
                                 fm_receiver.FM_LPF_TAPS,
                                 interpret=interpret)

    sharded = shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(axis, None)),
        out_specs=P(axis),
        check_vma=False,
    )

    @jax.jit
    def step(state, iq_u8):
        audio = sharded(state, iq_u8)
        return audio, fm_receiver.fused_ctx_from_raw_tail(iq_u8)

    return step
