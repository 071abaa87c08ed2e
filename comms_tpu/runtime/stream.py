"""Streaming executor: host IO overlapped with device compute.

The runtime piece that replaces the reference's free-running source /
sink node threads (``src/node/mod.rs:275-284`` spawning IO nodes) and
the bounded-channel back-pressure knob of its ``Graph``
(``src/node/graph.rs:44-47``): a serving loop that drives any block
function over a block source with up to ``depth`` blocks in flight —

    dispatch block k            (async: h2d + compute queue up)
    start d2h copy of result k  (async: overlaps later blocks)
    drain result k-depth        (host wait only when it is consumed)
    sink result k-depth

``depth`` is the analogue of the reference's channel capacity: it
bounds how far the host runs ahead of the sink.  The per-block
readback round trip is hidden once the drain lags the dispatch by
more than the round-trip/compute ratio.

Sources are plain iterables of numpy or device blocks (e.g. the
native C++ reader, ``io.raw_iq.iter_iq_blocks``, a live radio's recv
loop, or a jitted on-device generator); sinks are callables
(``io.audio.WavSink.write``, the native writer, a network sender).
State stays on device for the whole stream.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Iterable, Optional, Sequence

import numpy as np

import jax
import jax.numpy as jnp

from comms_tpu.runtime.metrics import ThroughputMeter

__all__ = ["StreamRunner", "BatchedStreamRunner"]


def _start_host_copy(y) -> None:
    """Kick off the async device->host copy of every array leaf (a
    no-op for non-device values); the later ``np.asarray`` then waits
    only for a transfer that has been in flight since dispatch."""
    for leaf in jax.tree_util.tree_leaves(y):
        start = getattr(leaf, "copy_to_host_async", None)
        if start is not None:
            try:
                start()
            except Exception:  # runtime without async copies
                pass


class StreamRunner:
    """Drive ``block_fn(state, x) -> (y, state)`` over a block source.

    Args:
      block_fn: jitted block step.
      state: initial state pytree (device-resident after first step).
      source: iterable of input blocks (numpy or device-resident).
      sink: optional callable receiving each output block (numpy).
      meter: optional ThroughputMeter; ``samples_of(x)`` counts the
        samples per input block (defaults to ``len``).
      depth: max in-flight (dispatched, not yet drained) results —
        the back-pressure bound.  1 reproduces the classic
        double-buffered loop; raise it to hide the per-block
        device->host round trip when the sink consumes small
        summaries (see module docstring for measured rates).
    """

    def __init__(self, block_fn: Callable, state: Any,
                 source: Iterable[Any],
                 sink: Optional[Callable[[Any], None]] = None,
                 meter: Optional[ThroughputMeter] = None,
                 samples_of: Callable[[Any], int] = len,
                 depth: int = 1):
        self.block_fn = block_fn
        self.state = state
        self.source = source
        self.sink = sink
        self.meter = meter if meter is not None else ThroughputMeter()
        self.samples_of = samples_of
        self.depth = max(1, int(depth))
        self.blocks_done = 0

    def _drain(self, y) -> None:
        if self.sink is not None:
            self.sink(np.asarray(y))
        else:
            jax.block_until_ready(y)

    def run(self, max_blocks: Optional[int] = None) -> ThroughputMeter:
        """Stream until the source ends (or ``max_blocks``).  Returns
        the throughput meter."""
        pending: deque = deque()  # oldest-first device results
        for i, x in enumerate(self.source):
            if max_blocks is not None and i >= max_blocks:
                break
            with self.meter.block(self.samples_of(x)):
                # dispatch this block (async)...
                y, self.state = self.block_fn(self.state,
                                              jax.device_put(x))
                if self.sink is not None:
                    _start_host_copy(y)
                pending.append(y)
                # ...and drain the block `depth` dispatches back while
                # the newer ones run.
                if len(pending) > self.depth:
                    self._drain(pending.popleft())
                self.blocks_done += 1
        while pending:
            self._drain(pending.popleft())
        return self.meter


# Lifted-step cache: a fresh jax.jit per runner would make every
# BatchedStreamRunner construction recompile the whole B-stream
# program (seconds for 8 fused FM chains, which silently dominated a
# short serving run).  Keyed weakly on the step so repeated runners over
# the same step (the serving pattern) reuse one compiled program.
_LIFT_CACHE: "weakref.WeakKeyDictionary" = None  # built lazily


def _lifted_step(block_fn: Callable, B: int, mode: str) -> Callable:
    global _LIFT_CACHE
    import weakref

    if _LIFT_CACHE is None:
        _LIFT_CACHE = weakref.WeakKeyDictionary()
    try:
        per_fn = _LIFT_CACHE.setdefault(block_fn, {})
    except TypeError:          # callable without weakref support
        per_fn = None
    key = (B, mode)
    if per_fn is not None and key in per_fn:
        return per_fn[key]

    tm = jax.tree_util.tree_map
    if mode == "unroll":
        def lifted(state, x):
            ys, sts = [], []
            for b in range(B):
                y, s2 = block_fn(tm(lambda a: a[b], state),
                                 tm(lambda a: a[b], x))
                ys.append(y)
                sts.append(s2)
            return (tm(lambda *ls: jnp.stack(ls), *ys),
                    tm(lambda *ls: jnp.stack(ls), *sts))
    elif mode == "map":
        def lifted(state, x):
            return jax.lax.map(
                lambda p: block_fn(p[0], p[1]), (state, x))
    elif mode == "vmap":
        lifted = jax.vmap(block_fn)
    else:
        raise ValueError(
            f"mode must be 'unroll', 'map' or 'vmap', got {mode!r}")
    fn = jax.jit(lifted)
    if per_fn is not None:
        per_fn[key] = fn
    return fn


class BatchedStreamRunner(StreamRunner):
    """Serve ``B`` independent streams with ONE device dispatch per
    round: the per-stream step is lifted over a leading stream axis,
    so one program launch (and one drain through the depth window)
    carries ``B`` blocks.

    Why this exists: every program launch has a fixed cost, serial
    with compute, so a single stream served at realistic per-client
    block sizes is launch-bound.  Batching B streams into one dispatch
    amortizes that cost B ways; it is the analogue of the reference
    running N independent flowgraphs as N thread sets
    (comms-rs ``src/node/mod.rs:275-284``).

    Per-stream state pytrees are stacked on the leading axis and stay
    strictly independent — no cross-stream term exists in the lifted
    program.  Three lift modes:

    * ``mode="unroll"`` (default) — the per-stream step is traced B
      times over sliced operands inside ONE program: each stream's
      subgraph is the SAME trace as the unbatched step (outputs
      bit-identical to B separate runs — tested on CPU, including the
      fused FM kernel), and XLA schedules the B independent subgraphs
      concurrently.  This is the serving mode.
    * ``mode="map"`` — ``lax.map`` over the stream axis: same
      bit-exactness, O(1) program size in B, but the streams run one
      after another: the right choice only when B is large enough
      that the unrolled program blows up compile time.
    * ``mode="vmap"`` — ``jax.vmap``: stream-parallel batched ops
      (GEMM batching changes rounding at the ULP level; right choice
      for many tiny streams).  Steps that call a Pallas kernel on
      whole unblocked operands (the fused FM chain) are not batched
      by vmap — use ``mode="unroll"``.

    Args:
      block_fn: per-stream step ``(state, x) -> (y, state)``.
      states: length-B list of per-stream initial state pytrees.
      sources: length-B list of per-stream block iterables (leaves
        are stacked on the host each round), OR pass
        ``batched_source`` — an iterable of pre-stacked ``[B, ...]``
        pytrees — to skip host stacking (device-resident serving).
      sinks: optional length-B list of per-stream callables; each
        receives its own stream's output block (leading axis
        sliced off).
      samples_of: per-ROUND sample count of a *batched* block
        (defaults to B * leading-leaf block length).
      depth: in-flight rounds, as in :class:`StreamRunner`.
    """

    def __init__(self, block_fn: Callable, states: Sequence[Any],
                 sources: Optional[Sequence[Iterable[Any]]] = None,
                 sinks: Optional[Sequence[Callable[[Any], None]]] = None,
                 meter: Optional[ThroughputMeter] = None,
                 samples_of: Optional[Callable[[Any], int]] = None,
                 depth: int = 1, mode: str = "unroll",
                 batched_source: Optional[Iterable[Any]] = None):
        B = len(states)
        if B < 1:
            raise ValueError("need at least one stream state")
        state0 = jax.tree_util.tree_map(
            lambda *ls: jnp.stack(ls), *states)

        if batched_source is None:
            if sources is None:
                raise ValueError("pass sources or batched_source")
            if len(sources) != B:
                raise ValueError(
                    f"{len(sources)} sources for {B} stream states")

            def _stacked():
                for xs in zip(*sources):
                    yield jax.tree_util.tree_map(
                        lambda *ls: np.stack(ls), *xs)
            source: Iterable[Any] = _stacked()
        else:
            source = batched_source

        sink = None
        if sinks is not None:
            if len(sinks) != B:
                raise ValueError(
                    f"{len(sinks)} sinks for {B} stream states")

            def sink(y):
                for b, s in enumerate(sinks):
                    s(jax.tree_util.tree_map(lambda a: a[b], y))

        if samples_of is None:
            def samples_of(x):
                return B * len(jax.tree_util.tree_leaves(x)[0][0])

        super().__init__(_lifted_step(block_fn, B, mode), state0, source,
                         sink=sink, meter=meter, samples_of=samples_of,
                         depth=depth)
        self.num_streams = B

    def _drain(self, y) -> None:
        if self.sink is not None:
            self.sink(jax.tree_util.tree_map(np.asarray, y))
        else:
            jax.block_until_ready(y)

    def stream_states(self):
        """Unstack the carried state back into B per-stream pytrees."""
        return [jax.tree_util.tree_map(lambda a: a[b], self.state)
                for b in range(self.num_streams)]
