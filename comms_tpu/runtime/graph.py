"""DAG graph API: named nodes, fan-out, fan-in — compiled to one fn.

Parity surface for the reference's graph construction
(``/root/reference/src/node/graph.rs:13-74`` and the
``connect_nodes!`` macros, ``src/node/mod.rs:149-219``):

* ``add_node(name, op, inputs=[...])`` — like ``Graph::add_node``;
* fan-out is implicit: any node may be named as input by several
  consumers (the reference clones each message to every registered
  sender, ``node_derive/src/lib.rs:153-163``; here it is plain SSA
  value reuse — zero copies);
* multi-input ops receive a tuple of block arrays, mirroring the
  generated ``call()``'s recv-all-inputs-in-declared-order;
* ``validate()`` mirrors ``Graph::is_connected`` (graph.rs:52-61);
* feedback edges (``connect_nodes_feedback!``, mod.rs:212-219) become
  block-level carries: the consumer reads the producer's *previous*
  block output, primed with a default value — exactly the reference's
  one-default-message deadlock-breaking semantics at block
  granularity.

The compiled step is a pure function ``(state, feedback, inputs) ->
(outputs, state, feedback)`` over topologically-sorted nodes; jit
fuses it into a single XLA program.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import jax

from comms_tpu.runtime.block import BlockOp

__all__ = ["Graph", "GraphNotConnectedError"]


class GraphNotConnectedError(ValueError):
    """A node reads from a producer that does not exist (the
    reference returns false from is_connected)."""


@dataclass
class _NodeSpec:
    name: str
    op: Any                      # BlockOp or callable(state, *ins)
    inputs: Tuple[str, ...]
    feedback: bool = False       # inputs are read from previous block
    default: Any = None          # priming value for feedback edges
    elementwise: Optional[bool] = None  # raw callables: shard-safety


class Graph:
    """Named-node DAG compiled into one jitted block step."""

    def __init__(self):
        self._nodes: Dict[str, _NodeSpec] = {}
        self._order: List[str] = []
        self._outputs: List[str] = []
        self._external: List[str] = []
        self._compiled = None

    # ------------------------------------------------------------ build
    def add_input(self, name: str) -> str:
        """Declare an external input (a block fed by the caller)."""
        if name in self._nodes or name in self._external:
            raise ValueError(f"duplicate node name {name!r}")
        self._external.append(name)
        return name

    def add_node(self, name: str, op, inputs: Sequence[str] = (),
                 feedback_from: Optional[Dict[str, Any]] = None,
                 elementwise: Optional[bool] = None) -> str:
        """Add a named op.  ``inputs`` are producer names (external or
        node).  ``feedback_from`` maps producer name -> priming default
        for cycle edges (read the producer's previous-block output).

        ``elementwise`` declares a RAW CALLABLE's shard-safety: True
        means output sample i depends only on input sample(s) i, so
        running it per-shard equals the single-device result.
        ``make_sharded_step`` refuses undeclared raw callables (a
        reduction run per-shard would silently compute per-shard
        values).  Ignored for :class:`BlockOp` nodes — those carry
        their own ``shard_apply`` contract."""
        if name in self._nodes or name in self._external:
            raise ValueError(f"duplicate node name {name!r}")
        fb = feedback_from or {}
        for p, d in fb.items():
            self._nodes[f"{name}@fb:{p}"] = _NodeSpec(
                f"{name}@fb:{p}", None, (p,), feedback=True, default=d
            )
        self._nodes[name] = _NodeSpec(
            name, op,
            tuple(f"{name}@fb:{p}" if p in fb else p for p in inputs),
            elementwise=elementwise,
        )
        self._order.append(name)
        self._compiled = None
        return name

    def set_outputs(self, names: Sequence[str]):
        self._outputs = list(names)
        self._compiled = None

    # --------------------------------------------------------- validate
    def validate(self):
        """is_connected parity: every input must name a producer."""
        known = set(self._external) | set(self._nodes)
        for spec in self._nodes.values():
            for p in spec.inputs:
                if p not in known:
                    raise GraphNotConnectedError(
                        f"node {spec.name!r} reads undefined input {p!r}"
                    )
        if not self._outputs:
            raise GraphNotConnectedError("no outputs set")
        for o in self._outputs:
            if o not in known:
                raise GraphNotConnectedError(f"unknown output {o!r}")

    # ---------------------------------------------------------- compile
    def _topo(self) -> List[_NodeSpec]:
        """Topological order ignoring feedback edges (they read the
        previous block, so they are not dependencies)."""
        order: List[_NodeSpec] = []
        done = set(self._external)
        pending = [self._nodes[n] for n in self._order]
        while pending:
            progressed = False
            rest = []
            for spec in pending:
                deps = [
                    p for p in spec.inputs
                    if not self._nodes.get(p, _NodeSpec("", None, ())).feedback
                ]
                if all(p in done for p in deps):
                    order.append(spec)
                    done.add(spec.name)
                    progressed = True
                else:
                    rest.append(spec)
            pending = rest
            if not progressed:
                raise GraphNotConnectedError(
                    f"cycle without feedback edge among "
                    f"{[s.name for s in pending]}"
                )
        return order

    def init_state(self, dtype=None):
        """State pytree: per-node op state + feedback slots (primed
        with their defaults, the connect_nodes_feedback! semantics).

        Stream dtypes are propagated through the DAG (each node's
        state dtype is the result_type of its producers' output
        dtypes; ``dtype`` seeds the external inputs) so e.g. a real
        stage after FmDemod gets real carried state.
        """
        import jax.numpy as jnp
        dtype = dtype or jnp.complex64

        # Built inside one jitted program, so no complex leaf crosses
        # the host<->device boundary (see Pipeline.init_state).
        def build():
            stream: Dict[str, Any] = {name: dtype
                                      for name in self._external}
            op_state = {}
            fb_state = {}
            for spec in self._topo():
                ins = [stream.get(pr, dtype) for pr in spec.inputs]
                in_dt = jnp.result_type(*ins) if ins else dtype
                if isinstance(spec.op, BlockOp):
                    op_state[spec.name] = spec.op.init_state(dtype=in_dt)
                    stream[spec.name] = spec.op.out_dtype(in_dt)
                else:
                    op_state[spec.name] = ()
                    stream[spec.name] = in_dt  # raw callable: same dtype
            for spec in self._nodes.values():
                if spec.feedback:
                    fb_state[spec.name] = spec.default
            return {"ops": op_state, "fb": fb_state}

        return jax.jit(build)()

    def _make_step(self, op_apply=None):
        """Build the step body; ``op_apply(op, state, x)`` defaults to
        plain ``op.apply`` (the sharded variant passes shard_apply)."""
        self.validate()
        order = self._topo()
        if op_apply is None:
            def op_apply(op, st, x):
                return op.apply(st, x)

        def step(state, inputs):
            values: Dict[str, Any] = dict(inputs)
            # Feedback slots provide their previous-block values.
            for name, v in state["fb"].items():
                values[name] = v
            new_ops = dict(state["ops"])
            for spec in order:
                ins = tuple(values[p] for p in spec.inputs)
                with jax.named_scope(spec.name):
                    if isinstance(spec.op, BlockOp):
                        x = (ins[0] if len(ins) == 1
                             else (ins if ins else None))
                        y, s = op_apply(spec.op,
                                        state["ops"][spec.name], x)
                        new_ops[spec.name] = s
                    else:  # raw callable: fn(*ins)
                        y = spec.op(*ins)
                values[spec.name] = y
            new_fb = {
                name: values[self._nodes[name].inputs[0]]
                for name in state["fb"]
            }
            outs = tuple(values[o] for o in self._outputs)
            return outs, {"ops": new_ops, "fb": new_fb}

        return step

    def compile(self):
        """Return the jitted block step ``(state, {input: block}) ->
        (outputs, new_state)``."""
        if self._compiled is None:
            self._compiled = jax.jit(self._make_step())
        return self._compiled

    # ---------------------------------------------------------- sharding
    def make_sharded_step(self, mesh, axis: str = "time"):
        """Compile the DAG for time-block sharding (the counterpart of
        ``Pipeline.make_sharded_step``): every node runs per-shard via
        its ``shard_apply`` hook, external inputs and outputs are
        sharded over ``axis``, op states stay replicated.

        Feedback edges carry the previous block sharded over ``axis``
        — the identical layout to a live sharded stream input, so any
        BlockOp consumer handles it correctly through its own
        ``shard_apply`` (halo exchange, psum, shard offsets).  Raw
        callables run per-shard with no collectives, so they must be
        declared ``elementwise=True`` at ``add_node`` time; undeclared
        (or declared non-elementwise) raw callables raise here rather
        than silently computing per-shard values — e.g. a reducing
        feedback consumer.
        """
        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        for spec in self._nodes.values():
            if spec.feedback or isinstance(spec.op, BlockOp):
                continue
            if spec.op is not None and spec.elementwise is not True:
                raise ValueError(
                    f"node {spec.name!r} is a raw callable not declared "
                    "elementwise=True; per-shard execution of a "
                    "non-elementwise function (e.g. a reduction over a "
                    "feedback edge) would silently diverge from the "
                    "single-device graph.  Declare "
                    "add_node(..., elementwise=True) if it is "
                    "sample-wise, or wrap it in a BlockOp with a "
                    "collective-aware shard_apply."
                )

        local_step = self._make_step(
            op_apply=lambda op, st, x: op.shard_apply(st, x, axis))

        state_specs = {"ops": P(), "fb": P(axis)}
        fn = shard_map(
            local_step, mesh=mesh,
            in_specs=(state_specs, P(axis)),
            out_specs=(P(axis), state_specs),
            check_vma=False,
        )
        return jax.jit(fn)
