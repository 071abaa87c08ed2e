"""Pipeline composer + streaming drivers.

The reference wires nodes with ``connect_nodes!`` and spawns a thread
per node (``/root/reference/src/node/mod.rs:149-284``).  Here a linear
chain composes into ONE pure function over a block, jitted once:

    pipe = Pipeline([PrnSource.make(...), BpskMod(), PulseShape.make(...)])
    state = pipe.init_state()
    y, state = pipe.step(state, x)            # one jitted block
    ys, state = pipe.run(state, x_blocks)     # lax.scan over blocks

Design notes
------------
* State is a tuple pytree (one leaf group per op) — snapshotting the
  whole pipeline is ``jax.device_get(state)`` (the checkpointing the
  reference lacks, SURVEY.md section 5).
* ``run`` drives ``lax.scan`` over a [num_blocks, block] array: the
  sequential carry is tiny (a few scalars/tap-tails), so XLA overlaps
  the per-block compute aggressively; for throughput the block size
  should be large (>= 2^17 samples).
* Rate bookkeeping: block sizes through the chain must stay integral;
  checked at trace time with clear errors.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
from jax import lax

from comms_tpu.runtime.block import BlockOp

__all__ = ["Pipeline"]


class Pipeline:
    """A linear chain of :class:`BlockOp` compiled into one block step."""

    def __init__(self, ops: Sequence[BlockOp], state_dtype=jnp.complex64):
        self.ops = list(ops)
        self.state_dtype = state_dtype
        self._jit_step = jax.jit(self._step)

    # ------------------------------------------------------------ state
    def init_state(self):
        """Per-op states with dtypes propagated through the chain
        (``state_dtype`` is the pipeline INPUT stream dtype; each op's
        ``out_dtype`` determines its successor's).

        Built INSIDE one jitted program, so complex leaves are made on
        the device (the public boundary speaks f32 pairs,
        runtime/boundary.py), ready for the step functions.
        """
        def build():
            cur = self.state_dtype
            states = []
            for op in self.ops:
                states.append(op.init_state(dtype=cur))
                cur = op.out_dtype(cur)
            return tuple(states)

        return jax.jit(build)()

    @property
    def rate(self) -> Fraction:
        r = Fraction(1, 1)
        for op in self.ops:
            r *= op.rate
        return r

    # ------------------------------------------------------------- step
    def _step(self, state, x):
        new_state = []
        y = x
        for i, op in enumerate(self.ops):
            with jax.named_scope(f"{i}_{type(op).__name__}"):
                y, s = op.apply(state[i], y)
            new_state.append(s)
        return y, tuple(new_state)

    def step(self, state, x=None):
        """Process one block (jitted).  For source-headed pipelines
        pass ``x=None``."""
        return self._jit_step(state, x)

    # -------------------------------------------------------------- run
    def run(self, state, blocks=None, num_blocks: Optional[int] = None):
        """Drive many blocks with ``lax.scan``.

        ``blocks``: [num_blocks, block_len] array (or None for a
        source-headed pipeline, in which case ``num_blocks`` is
        required).  Returns ``(ys[num_blocks, out_len], final_state)``.
        """
        if blocks is None:
            if num_blocks is None:
                raise ValueError("num_blocks required for source pipelines")

            def body(carry, _):
                y, carry = self._step(carry, None)
                return carry, y

            final, ys = lax.scan(body, state, None, length=num_blocks)
            return ys, final

        def body(carry, xb):
            y, carry = self._step(carry, xb)
            return carry, y

        final, ys = lax.scan(body, state, blocks)
        return ys, final

    # --------------------------------------------------------- sharding
    def make_sharded_step(self, mesh, axis: str = "time",
                          block: Optional[int] = None):
        """Compile this pipeline for time-block sharding over ``mesh``.

        Every op runs per-shard through its ``shard_apply`` hook:
        overlap-save ops get their left neighbor's tail via one ring
        ``ppermute``, estimator-style reductions psum, Mixer offsets
        its phase ramp per shard, and the carried stream state stays
        replicated — so the sharded step is numerically identical to
        the single-device step on the concatenated block.

        Returns jitted ``(state, x[N, ...]) -> (y, state)`` with the
        leading axis of ``x``/``y`` sharded over ``axis``.  If
        ``block`` is given, per-shard sizes are validated up front.
        """
        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        n_dev = mesh.shape[axis]
        if block is not None:
            if block % n_dev:
                raise ValueError(
                    f"block {block} must divide over {n_dev} shards")
            local = block // n_dev
            self.check_block_size(local)
            for op in self.ops:
                if 0 < local <= op.halo:
                    raise ValueError(
                        f"per-shard length {local} must exceed the "
                        f"halo {op.halo} of {op}")
                local = op.out_len(local)

        def local_chain(state, x_local):
            y = x_local
            new_state = []
            for i, op in enumerate(self.ops):
                with jax.named_scope(f"{i}_{type(op).__name__}"):
                    y, s = op.shard_apply(state[i], y, axis)
                new_state.append(s)
            return y, tuple(new_state)

        fn = shard_map(
            local_chain, mesh=mesh,
            in_specs=(P(), P(axis)),
            out_specs=(P(axis), P()),
            check_vma=False,
        )
        return jax.jit(fn)

    # ------------------------------------------------------ introspection
    def check_block_size(self, n: int) -> int:
        """Validate block length ``n`` through the chain (each op's
        own length rule, including per-block-reset ceil decimation);
        returns the output length."""
        cur = int(n)
        for op in self.ops:
            cur = op.out_len(cur)
        return cur

    def __repr__(self):
        inner = ", ".join(type(op).__name__ for op in self.ops)
        return f"Pipeline([{inner}], rate={self.rate})"
