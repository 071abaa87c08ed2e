#!/usr/bin/env python
"""Smoke test on the GPU: the FM receiver end to end plus every model's
block function, at full width, in one process that owns the card.

Phases run in order and any failure exits non-zero (there is no
fallback and no result line then):

  device     the first JAX device must be a GPU; prints it, the JAX
             version, the compile-cache directory and nvidia-smi's name
             and power limit.
  fm_main    writes a synthetic FM capture (4 blocks of 6,553,600
             samples + a ragged tail of 3,777) and demodulates it with
             ``fm_receiver.run_file`` on its default routing, against
             ``run_file(..., fused=False)`` at highest matmul
             precision; then the reference-parity dense path
             (block 262,144) against a float64 numpy oracle.
  fm_kernel  the fused kernel at 26,214,400-sample blocks, two chained,
             against ``make_block_fn`` at highest precision; then times
             both chains.
  models     each other model's block function once at its bench
             width: shape and finite output, memory analysis.

``--four-cards`` runs only the multi-device paths on four GPUs
(``wideband.make_sharded_step`` and ``make_sharded_psd_segments``,
each against the same computation on one device) and checks that the
outputs span all four cards.

The last line of standard output is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": N}}``.

Usage: python chip_smoke.py [--seed N] [--out DIR] [--four-cards]
"""

import argparse
import json
import os
import subprocess
import time

import numpy as np

BLOCK = 6_553_600          # run_file block: 1024 fused-kernel quanta
TAIL = 3_777               # ragged tail samples
KBLOCK = 26_214_400        # fused-kernel block (bench.py's FM width)
REF_BLOCK = 262_144        # the reference's rtl-sdr read size
FM_TOL = 1e-4              # max |audio| error, kernel vs XLA (rad)
ORACLE_TOL = 2e-4          # dense path vs float64 oracle (tests/test_models)


def _check(ok, what):
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def _mem(compiled):
    m = compiled.memory_analysis()
    return (f"args {m.argument_size_in_bytes / 2**20:.1f} MiB, "
            f"out {m.output_size_in_bytes / 2**20:.1f} MiB, "
            f"temp {m.temp_size_in_bytes / 2**20:.1f} MiB")


def _median_seconds(fn, runs=7):
    import jax

    jax.block_until_ready(fn())                      # warm-up
    ts = []
    for _ in range(runs):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _fm_capture(n, seed):
    """Constant-envelope FM capture quantised to u8 (as in
    tests/test_fused_chain.py): a random-walk instantaneous frequency
    around 0.3 rad/sample."""
    rng = np.random.default_rng(seed)
    ph = np.cumsum(0.3 + 0.02 * rng.standard_normal(n))
    iq = np.empty((n, 2), np.uint8)
    iq[:, 0] = np.clip(np.round(np.cos(ph) * 100 + 127.5), 0, 255)
    iq[:, 1] = np.clip(np.round(np.sin(ph) * 100 + 127.5), 0, 255)
    return iq


def _fm_oracle(u8):
    """fm_radio.rs chain in float64 from zero state: convert -> FIR ->
    keep every 5th -> quadrature demod -> FIR -> keep every 5th."""
    from comms_tpu.models import fm_receiver

    t = fm_receiver.FM_LPF_TAPS
    x = (u8[:, 0] - 127.5) / 127.5 + 1j * ((u8[:, 1] - 127.5) / 127.5)
    y = np.convolve(x, t)[:len(x)][::5]
    d = np.angle(y * np.conj(np.concatenate([[0j], y[:-1]])))
    return np.convolve(d, t)[:len(d)][::5]


def phase_device(need):
    import jax

    from comms_tpu.runtime.compile_cache import enable_compile_cache

    devs = jax.devices()
    _check(devs[0].platform == "gpu",
           f"no GPU: JAX found {devs[0].platform} devices")
    _check(len(devs) >= need, f"need {need} GPUs, JAX found {len(devs)}")
    print(f"[device] {devs[0].device_kind} x{len(devs)}, "
          f"jax {jax.__version__}, compile cache {enable_compile_cache()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(card, flush=True)
    return card


def phase_fm_main(iq, out_dir):
    import jax
    import jax.numpy as jnp

    from comms_tpu.models import fm_receiver
    from comms_tpu.native import native_available

    path = os.path.join(out_dir, "fm_capture.u8")
    iq[:4 * BLOCK + TAIL].tofile(path)
    cfg = fm_receiver.FmReceiverConfig(block=BLOCK)
    print(f"[fm_main] reader {'native' if native_available() else 'python'}"
          f", chain {'kernel' if fm_receiver.fused_chain_ok(cfg) else 'xla'}"
          f", {4 * BLOCK + TAIL} samples", flush=True)
    got = fm_receiver.run_file(path, cfg)
    with jax.default_matmul_precision("highest"):
        ref = fm_receiver.run_file(path, cfg, fused=False)
    _check(got.shape == ref.shape == (4 * BLOCK // 25 + -(-TAIL // 25),),
           f"run_file shapes {got.shape} vs {ref.shape}")
    err = float(np.max(np.abs(got - ref)))
    print(f"[fm_main] run_file default vs XLA at highest: max|err| "
          f"{err:.3g} (tol {FM_TOL})", flush=True)
    _check(np.isfinite(got).all() and err <= FM_TOL, "fm_main parity")

    dcfg = fm_receiver.FmReceiverConfig()
    _check(not dcfg.polyphase, "reference block must take the dense path")
    audio, _ = fm_receiver.make_block_fn(dcfg)(
        fm_receiver.init_state(dcfg), jnp.asarray(iq[:REF_BLOCK]))
    audio = np.asarray(audio)
    want = _fm_oracle(iq[:REF_BLOCK].astype(np.float64))
    _check(audio.shape == want.shape, f"dense shape {audio.shape}")
    err = float(np.max(np.abs(audio - want)))
    print(f"[fm_main] dense path (block {REF_BLOCK}) vs float64 oracle: "
          f"max|err| {err:.3g} (tol {ORACLE_TOL})", flush=True)
    _check(err <= ORACLE_TOL, "dense path vs oracle")


def phase_fm_kernel(iq, card):
    import jax

    from comms_tpu.models import fm_receiver

    cfg = fm_receiver.FmReceiverConfig(block=KBLOCK)
    blocks = [jax.device_put(iq[b * KBLOCK:(b + 1) * KBLOCK])
              for b in range(2)]
    kblk = fm_receiver.make_fused_block_fn(cfg)
    with jax.default_matmul_precision("highest"):
        xblk = fm_receiver.make_block_fn(cfg)

    def run(blk, state):
        outs = []
        for b in blocks:
            a, state = blk(state, b)
            outs.append(a)
        return outs

    def run_kernel():
        return run(kblk, fm_receiver.fused_init_state())

    def run_xla():
        with jax.default_matmul_precision("highest"):
            return run(xblk, fm_receiver.init_state(cfg))

    got = np.concatenate([np.asarray(a) for a in run_kernel()])
    ref = np.concatenate([np.asarray(a) for a in run_xla()])
    _check(got.shape == ref.shape == (2 * KBLOCK // 25,), "kernel shapes")
    err = float(np.max(np.abs(got - ref)))
    print(f"[fm_kernel] fused kernel vs make_block_fn at highest, "
          f"2 x {KBLOCK}: max|err| {err:.3g} (tol {FM_TOL})", flush=True)
    _check(np.isfinite(got).all() and err <= FM_TOL, "fm_kernel parity")

    for name, fn in (("kernel", run_kernel), ("xla", run_xla)):
        t = _median_seconds(fn)
        print(f"[fm_kernel] {name}: {2 * KBLOCK / t / 1e6:.1f} Msps "
              f"(median of 7, 2 chained blocks) on {card}", flush=True)
    with jax.default_matmul_precision("highest"):
        xmem = _mem(xblk.lower(fm_receiver.init_state(cfg),
                               blocks[0]).compile())
    kmem = _mem(kblk.lower(fm_receiver.fused_init_state(),
                           blocks[0]).compile())
    print(f"[fm_kernel] memory: kernel step {kmem}; xla step {xmem}",
          flush=True)


def phase_models():
    import jax
    import jax.numpy as jnp

    from comms_tpu.models import (bpsk_tx, channelizer, fm_band_monitor,
                                  qpsk_rx, qpsk_rx_stream, qpsk_tx)
    from comms_tpu.ops import spectrum

    key = jax.random.PRNGKey(0)

    def normal(shape):
        return jax.random.normal(key, shape, jnp.float32)

    bcfg = bpsk_tx.BpskTxConfig(syms_per_block=1 << 22)
    qcfg = qpsk_tx.QpskTxConfig(bits_per_block=1 << 23)
    rcfg = qpsk_rx.QpskRxConfig()
    ccfg = channelizer.ChannelizerConfig(block=1 << 24)
    mcfg = fm_band_monitor.BandMonitorConfig(block=1 << 24)
    n_rx = 1 << 25
    re, im = normal((n_rx,)), normal((n_rx,)) * 0.5
    cases = [
        ("bpsk_tx", bpsk_tx.make_block_fn_fast(bcfg),
         (bpsk_tx.init_state_fast(bcfg),)),
        ("qpsk_tx", qpsk_tx.make_block_fn_fast(qcfg),
         (qpsk_tx.init_state_fast(qcfg),)),
        ("qpsk_rx", qpsk_rx.make_rx_fn(rcfg), (normal((n_rx, 2)),)),
        ("qpsk_rx_stream", qpsk_rx_stream.make_stream_fast_fn(rcfg),
         (qpsk_rx_stream.init_state_fast(rcfg), re, im)),
        ("channelizer64", channelizer.make_planar_block_fn(ccfg),
         (channelizer.init_state(ccfg), re[:ccfg.block], im[:ccfg.block])),
        ("fm_band_monitor", fm_band_monitor.make_block_fn(mcfg),
         (fm_band_monitor.init_state(mcfg), normal((mcfg.block, 2)))),
        ("welch_psd_1024", jax.jit(
            lambda a, b: spectrum.welch_psd(jax.lax.complex(a, b),
                                            nperseg=1024)[1]), (re, im)),
        ("welch_psd_2pow20", jax.jit(
            lambda a, b: spectrum.welch_psd(jax.lax.complex(a, b),
                                            nperseg=1 << 20,
                                            noverlap=0)[1]), (re, im)),
    ]
    for name, fn, args in cases:
        compiled = fn.lower(*args).compile()
        out = jax.block_until_ready(compiled(*args))
        leaves = jax.tree_util.tree_leaves(out)
        _check(leaves and all(np.isfinite(np.asarray(x)).all()
                              for x in leaves), f"{name}: non-finite output")
        shapes = [tuple(x.shape) for x in leaves[:2]]
        print(f"[models] {name}: ok, out {shapes}, {_mem(compiled)}",
              flush=True)


def phase_four_cards(iq):
    import jax
    import jax.numpy as jnp

    from comms_tpu.models.fm_receiver import FM_LPF_TAPS
    from comms_tpu.ops import spectrum
    from comms_tpu.parallel import sharding as sh
    from comms_tpu.parallel import wideband

    devs = set(jax.devices()[:4])
    mesh4, mesh1 = sh.time_mesh(4), sh.time_mesh(1)

    n = 4 * BLOCK
    pairs = jnp.asarray((iq[:n].astype(np.float32) - 127.5) / 127.5)
    cfg = wideband.WidebandConfig(FM_LPF_TAPS, block=n, dec1=5, dec2=5)
    outs = {}
    for name, mesh in (("4", mesh4), ("1", mesh1)):
        step = wideband.make_sharded_step(cfg, mesh)
        st = wideband.init_state(cfg)
        audio = []
        for _ in range(2):                    # two blocks, state carried
            (a, f), st = step(st, pairs)
            audio.append(a)
        outs[name] = (audio, f)
    a4, f4 = outs["4"]
    a1, f1 = outs["1"]
    _check(all(a.sharding.device_set == devs for a in a4),
           f"sharded audio on {a4[0].sharding.device_set}")
    err = max(float(np.max(np.abs(np.asarray(x) - np.asarray(y))))
              for x, y in zip(a4, a1))
    ferr = abs(float(f4) - float(f1))
    print(f"[four_cards] wideband.make_sharded_step 4 x {BLOCK} (2 blocks) "
          f"vs one device: max|audio err| {err:.3g}, |freq err| "
          f"{ferr:.3g}, audio on {len(a4[0].sharding.device_set)} devices",
          flush=True)
    _check(err <= 1e-5 and ferr <= 1e-5, "sharded chain vs one device")

    F, B = 1 << 20, 8
    key = jax.random.PRNGKey(1)
    segs = jax.random.normal(key, (B, F, 2), jnp.float32)
    psd4 = wideband.make_sharded_psd_segments(F, mesh4)(
        jax.device_put(segs, jax.sharding.NamedSharding(
            mesh4, jax.sharding.PartitionSpec("time", None, None))))
    _check(psd4.sharding.device_set == devs,
           f"psd on {psd4.sharding.device_set}")
    x = jax.device_put(segs, jax.devices()[0])
    _, ref = spectrum.welch_psd(
        jax.lax.complex(x[..., 0], x[..., 1]).reshape(-1), nperseg=F,
        noverlap=0)
    ref = np.asarray(ref)
    rel = float(np.max(np.abs(np.asarray(psd4) - ref)) / np.max(ref))
    print(f"[four_cards] make_sharded_psd_segments 2^20 bins x {B} "
          f"segments vs single-device welch_psd: max rel err {rel:.3g}, "
          f"psd on {len(psd4.sharding.device_set)} devices", flush=True)
    _check(rel <= 2e-5, "segment-parallel PSD vs welch_psd")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=".chip_smoke",
                    help="where the synthetic capture is written")
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-GPU sharded paths")
    args = ap.parse_args()

    card = phase_device(4 if args.four_cards else 1)
    import jax

    os.makedirs(args.out, exist_ok=True)
    if args.four_cards:
        phase_four_cards(_fm_capture(4 * BLOCK, args.seed))
    else:
        iq = _fm_capture(2 * KBLOCK, args.seed)
        phase_fm_main(iq, args.out)
        phase_fm_kernel(iq, card)
        phase_models()
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
