"""The compiled FM kernel on the GPU (``pytest -m gpu`` with
JAX_PLATFORMS=cuda; skips elsewhere).  Its arithmetic is also covered
on the CPU in the Pallas interpreter (tests/test_fused_chain.py)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from comms_tpu.models import fm_receiver

pytestmark = pytest.mark.gpu

# max |audio| error of the kernel vs the XLA chain at HIGHEST: 63-term
# f32 sums re-associated (~1e-6) plus the 5e-7 polynomial atan2
_TOL = 1e-4


def _fm_capture(n, seed=0):
    rng = np.random.default_rng(seed)
    ph = np.cumsum(0.3 * np.sin(2 * np.pi * np.arange(n) / 997.0)
                   + 0.05 * rng.standard_normal(n))
    iq = np.stack([127.5 + 100 * np.cos(ph), 127.5 + 100 * np.sin(ph)], 1)
    return np.clip(np.round(iq), 0, 255).astype(np.uint8)


def _xla(iq, block):
    cfg = fm_receiver.FmReceiverConfig(block=block)
    blk = fm_receiver.make_block_fn(cfg)
    st = fm_receiver.init_state(cfg)
    outs = []
    with jax.default_matmul_precision("highest"):
        for b in range(iq.shape[0] // block):
            a, st = blk(st, jnp.asarray(iq[b * block:(b + 1) * block]))
            outs.append(np.asarray(a))
    return np.concatenate(outs)


@pytest.mark.parametrize("programs", [1, 8, 512])
def test_fused_chain_compiled_matches_xla(gpu, programs):
    n = programs * fm_receiver.FUSED_BLOCK_QUANTUM
    iq = _fm_capture(2 * n)
    cfg = fm_receiver.FmReceiverConfig(block=n)
    blk = fm_receiver.make_fused_block_fn(cfg)
    st = fm_receiver.fused_init_state()
    outs = []
    for b in range(2):
        a, st = blk(st, jnp.asarray(iq[b * n:(b + 1) * n]))
        outs.append(np.asarray(a))
    got = np.concatenate(outs)
    assert np.max(np.abs(got - _xla(iq, n))) < _TOL


def test_run_file_routes_to_kernel_on_gpu(gpu, tmp_path):
    cfg = fm_receiver.FmReceiverConfig(block=8 * fm_receiver.FUSED_BLOCK_QUANTUM)
    assert fm_receiver.fused_chain_ok(cfg)
    iq = _fm_capture(3 * cfg.block + 3777, seed=1)
    path = tmp_path / "cap.u8"
    iq.tofile(path)
    got = fm_receiver.run_file(str(path), cfg)
    with jax.default_matmul_precision("highest"):
        ref = fm_receiver.run_file(str(path), cfg, fused=False)
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) < _TOL
