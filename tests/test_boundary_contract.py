"""Contract: no complex dtype may appear in the inputs or outputs of
any model's public jitted surface (the framework's boundary API speaks
float32 re/im pairs — runtime/boundary.py).  Checked via eval_shape so
new models get caught at test time, not on hardware."""

import numpy as np
import jax
import jax.numpy as jnp

from comms_tpu.models import (
    bpsk_tx,
    channelizer,
    fm_receiver,
    qpsk_rx,
    qpsk_tx,
)


def assert_no_complex(tree, where):
    for leaf in jax.tree_util.tree_leaves(tree):
        dt = getattr(leaf, "dtype", None)
        assert dt is None or not jnp.issubdtype(dt, jnp.complexfloating), (
            f"complex leaf {dt} crosses the jit boundary in {where}"
        )


def _check(fn, args, name):
    assert_no_complex(args, f"{name} inputs")
    out = jax.eval_shape(fn, *args)
    assert_no_complex(out, f"{name} outputs")


def test_bpsk_tx_boundary():
    cfg = bpsk_tx.BpskTxConfig(syms_per_block=128)
    _check(bpsk_tx.make_block_fn(cfg), (bpsk_tx.init_state(cfg),),
           "bpsk_tx")


def test_qpsk_tx_boundary():
    cfg = qpsk_tx.QpskTxConfig(bits_per_block=256)
    _check(qpsk_tx.make_block_fn(cfg), (qpsk_tx.init_state(cfg),),
           "qpsk_tx")


def test_tx_fast_boundaries():
    cfg = bpsk_tx.BpskTxConfig(syms_per_block=128)
    _check(bpsk_tx.make_block_fn_fast(cfg),
           (bpsk_tx.init_state_fast(cfg),), "bpsk_tx.fast")
    qcfg = qpsk_tx.QpskTxConfig(bits_per_block=256, dphase=0.5)
    _check(qpsk_tx.make_block_fn_fast(qcfg),
           (qpsk_tx.init_state_fast(qcfg),), "qpsk_tx.fast")


def test_fm_receiver_boundary():
    cfg = fm_receiver.FmReceiverConfig(block=1000)
    iq = jnp.zeros((1000, 2), jnp.uint8)
    _check(fm_receiver.make_block_fn(cfg),
           (fm_receiver.init_state(cfg), iq), "fm_receiver.block")
    blocks = jnp.zeros((2, 1000, 2), jnp.uint8)
    _check(fm_receiver.make_scan_fn(cfg),
           (fm_receiver.init_state(cfg), blocks), "fm_receiver.scan")


def test_channelizer_boundary():
    cfg = channelizer.ChannelizerConfig(num_channels=16,
                                        taps_per_branch=4, block=256)
    pairs = jnp.zeros((256, 2), jnp.float32)
    _check(channelizer.make_block_fn(cfg),
           (channelizer.init_state(cfg), pairs), "channelizer")


def test_qpsk_rx_boundary():
    rx = qpsk_rx.make_rx_fn(qpsk_rx.QpskRxConfig())
    pairs = jnp.zeros((4096, 2), jnp.float32)
    _check(rx, (pairs,), "qpsk_rx")


def test_graft_entry_boundary():
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "graft_entry",
        os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "__graft_entry__.py"))
    ge = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ge)
    fn, args = ge.entry()
    _check(fn, args, "__graft_entry__.entry")


def test_fm_band_monitor_boundary():
    from comms_tpu.models import fm_band_monitor as fbm
    cfg = fbm.BandMonitorConfig(num_channels=8, block=8 * 512)
    pairs = jnp.zeros((cfg.block, 2), jnp.float32)
    _check(fbm.make_block_fn(cfg), (fbm.init_state(cfg), pairs),
           "fm_band_monitor")


def test_qpsk_rx_stream_boundary():
    from comms_tpu.models import qpsk_rx_stream
    cfg = qpsk_rx_stream.QpskRxStreamConfig(block=256)
    step = qpsk_rx_stream.make_stream_fn(cfg)
    pairs = jnp.zeros((cfg.block, 2), jnp.float32)
    _check(step, (qpsk_rx_stream.init_state(cfg), pairs), "qpsk_rx_stream")


def test_fused_fm_boundary():
    from comms_tpu.models import fm_receiver
    cfg = fm_receiver.FmReceiverConfig(
        block=fm_receiver.FUSED_BLOCK_QUANTUM)
    blk = fm_receiver.make_fused_block_fn(cfg, interpret=True)
    iq = jnp.zeros((cfg.block, 2), jnp.uint8)
    _check(blk, (fm_receiver.fused_init_state(), iq), "fused_fm")
