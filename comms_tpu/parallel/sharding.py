"""Time-block sharding over a device mesh with halo exchange.

The replacement for BOTH of the reference's concurrency
mechanisms (SURVEY.md section 2.4): thread-pipeline parallelism
(dissolved into one fused XLA program) and ZMQ inter-process transport
(replaced by XLA collectives inside ``shard_map``).

Model: the sample (time) axis of each block is sharded across the
mesh axis ``"time"``.  Stateful ops need the last ``halo`` input
samples owned by the left neighbor — exactly the carried state of the
single-device streaming ops — so the same op kernels run unchanged:

    xh = halo_exchange(x_local, ctx, halo, axis="time")   # ppermute
    y_local, _ = fir.fir_block(x_local, B, ctx=xh)        # overlap-save

``halo_exchange`` passes each shard's tail one step right around the
ring (one ``ppermute``, NCCL on GPUs); shard 0 receives the global
stream context instead.  ``collect_ctx`` returns the stream context
for the next block (the global tail, owned by the last shard).

Estimator reductions (sums) become ``psum``; the channelizer's
channel-parallel corner turn is ``all_to_all``.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh

__all__ = [
    "time_mesh",
    "halo_exchange",
    "collect_ctx",
    "psum_estimate",
    "corner_turn",
]


def time_mesh(n_devices: int | None = None, name: str = "time") -> Mesh:
    """1-D mesh over the first ``n_devices`` devices."""
    devs = jax.devices()
    n = len(devs) if n_devices is None else int(n_devices)
    return Mesh(np.array(devs[:n]), (name,))


def halo_exchange(x_local, ctx, halo: int, axis: str = "time"):
    """Give each shard the ``halo`` samples preceding its chunk.

    Inside ``shard_map`` over ``axis``.  Returns ``[halo]``-shaped
    context for this shard: the left neighbor's tail, or ``ctx`` (the
    carried stream state) on shard 0.  One ring ``ppermute`` —
    neighbor traffic only, no all-gather.
    """
    if halo == 0:
        return x_local[:0]
    if halo > x_local.shape[0]:
        raise ValueError(
            f"halo {halo} exceeds per-shard length {x_local.shape[0]}; "
            "use larger blocks or fewer shards"
        )
    n = lax.axis_size(axis)
    idx = lax.axis_index(axis)
    tail = x_local[-halo:]
    if n == 1:
        return _cast_like(ctx, x_local)
    recv = lax.ppermute(tail, axis,
                        perm=[(i, i + 1) for i in range(n - 1)])
    # Shard 0 received nothing (zeros); substitute the stream context.
    return jnp.where(idx == 0, _cast_like(ctx, x_local), recv)


def _cast_like(ctx, x):
    """Cast a carried context to the stream dtype.  Complex -> real
    takes the real part explicitly (a context stored complex by a
    uniform state-dtype init feeding a real stage)."""
    ctx = jnp.asarray(ctx)
    if (jnp.issubdtype(ctx.dtype, jnp.complexfloating)
            and not jnp.issubdtype(x.dtype, jnp.complexfloating)):
        ctx = jnp.real(ctx)
    return ctx.astype(x.dtype)


def collect_ctx(x_local, halo: int, axis: str = "time"):
    """The next block's stream context: the tail of the LAST shard,
    replicated to all shards (psum of a one-hot selection)."""
    if halo == 0:
        return x_local[:0]
    n = lax.axis_size(axis)
    idx = lax.axis_index(axis)
    tail = x_local[-halo:]
    if n == 1:
        return tail
    keep = (idx == n - 1).astype(x_local.dtype)
    return lax.psum(tail * keep, axis)


def psum_estimate(partial_sum, axis: str = "time"):
    """Cross-shard reduction for estimator sums (frequency/phase/
    timing): each shard reduces its chunk, then one psum."""
    return lax.psum(partial_sum, axis)


def corner_turn(y_local, axis: str = "time"):
    """Channelizer corner turn: [frames_local, K] time-sharded ->
    [frames_global, K_local] channel-sharded via ``all_to_all``
    (the EP-style exchange, SURVEY.md section 2.4).

    Requires K % axis_size == 0.
    """
    n = lax.axis_size(axis)
    frames_local, K = y_local.shape
    if K % n:
        raise ValueError(f"channels {K} not divisible by shards {n}")
    # split channel axis into n groups, exchange, concat on time.
    y = y_local.reshape(frames_local, n, K // n)
    y = lax.all_to_all(y, axis, split_axis=1, concat_axis=0, tiled=False)
    # result: [n, frames_local, K//n] concat on leading -> reshape
    return y.reshape(n * frames_local, K // n)
