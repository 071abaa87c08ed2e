"""Sharded fused FM chain (parallel/fused_wideband.py): the fused
kernel per shard (Pallas interpreter on the CPU mesh) must reproduce
the sequential streaming path EXACTLY — a shard boundary is a block
boundary, and both derive their context from the same raw tail."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from comms_tpu.models import fm_receiver
from comms_tpu.parallel import fused_wideband, sharding as sh

Q = fm_receiver.FUSED_BLOCK_QUANTUM


def _capture(n, seed):
    rng = np.random.default_rng(seed)
    ph = np.cumsum(0.3 + 0.05 * rng.standard_normal(n))
    iq = np.stack([127.5 + 100 * np.cos(ph), 127.5 + 100 * np.sin(ph)], 1)
    return np.clip(np.round(iq), 0, 255).astype(np.uint8)


def _sequential_oracle(iq, per_shard, shards):
    """make_fused_block_fn over per-shard-sized blocks, state chained."""
    cfg = fm_receiver.FmReceiverConfig(block=per_shard)
    blk = fm_receiver.make_fused_block_fn(cfg, interpret=True)
    st = fm_receiver.fused_init_state()
    outs = []
    for b in range(shards):
        a, st = blk(st, jnp.asarray(iq[b * per_shard:(b + 1) * per_shard]))
        outs.append(np.asarray(a))
    return np.concatenate(outs), st


def test_sharded_fused_matches_sequential_exactly():
    n_dev = min(8, len(jax.devices()))
    N = n_dev * Q
    iq = _capture(N, 0)
    step = fused_wideband.make_sharded_fused_step(
        sh.time_mesh(n_dev), block=N, interpret=True)
    audio, new_state = step(fused_wideband.fused_init_state(),
                            jnp.asarray(iq))
    ref, ref_state = _sequential_oracle(iq, Q, n_dev)
    got = np.asarray(audio)
    assert got.shape == ref.shape
    # bit-exact: identical ops on identical inputs at every boundary.
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(np.asarray(new_state),
                                  np.asarray(ref_state))


def test_sharded_fused_second_block_continues_stream():
    # Two sharded steps with carried state == one long sequential run.
    n_dev = min(4, len(jax.devices()))
    N = n_dev * Q
    iq = _capture(2 * N, 1)
    step = fused_wideband.make_sharded_fused_step(
        sh.time_mesh(n_dev), block=N, interpret=True)
    st = fused_wideband.fused_init_state()
    a1, st = step(st, jnp.asarray(iq[:N]))
    a2, _ = step(st, jnp.asarray(iq[N:]))
    got = np.concatenate([np.asarray(a1), np.asarray(a2)])
    ref, _ = _sequential_oracle(iq, Q, 2 * n_dev)
    np.testing.assert_array_equal(got, ref)


def test_sharded_fused_validates_shapes():
    mesh = sh.time_mesh(min(2, len(jax.devices())))
    with pytest.raises(ValueError, match="multiple of the"):
        fused_wideband.make_sharded_fused_step(
            mesh, block=mesh.shape["time"] * 1024)
    with pytest.raises(ValueError, match="divide"):
        fused_wideband.make_sharded_fused_step(mesh, block=2 * Q + 1)


def test_sharded_fused_matches_xla_chain():
    # the sharded kernel stream against the XLA chain (the plain
    # reference) over the same samples
    n_dev = min(4, len(jax.devices()))
    N = n_dev * Q
    iq = _capture(N, 2)
    step = fused_wideband.make_sharded_fused_step(
        sh.time_mesh(n_dev), block=N, interpret=True)
    audio, _ = step(fused_wideband.fused_init_state(), jnp.asarray(iq))
    cfg = fm_receiver.FmReceiverConfig(block=N)
    ref, _ = fm_receiver.make_block_fn(cfg)(fm_receiver.init_state(cfg),
                                            jnp.asarray(iq))
    assert np.max(np.abs(np.asarray(audio) - np.asarray(ref))) < 1e-4
