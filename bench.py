"""Benchmark suite: every flagship model plus kernel rooflines.

Prints one JSON line per row; the FINAL line is the flagship
FM-receiver chain (same metric name since round 1) — the PRODUCTION
streaming path (``make_fused_block_fn``, the fused kernel, wherever
``fm_receiver.fused_chain_ok`` routes to it), state chained across
blocks.

  {"metric": ..., "value": N, "unit": "Msamples/s", "vs_baseline": N,
   "platform": ..., "device_kind": ..., "device_count": N,
   "power_limit": ...}

Timing: each dispatch runs R passes over device-resident input inside
a ``lax.fori_loop`` with carried state and an f32 checksum (the data
dependency defeats hoisting; stateless ops perturb the input by
``acc * 1e-30`` per pass), and ends in ``block_until_ready``.  R is a
TRACED bound, so a row compiles one program.  Throughput is the SLOPE
between R and 2R passes, which cancels fixed overheads; >= 3 slope
samples must agree within ~10% (else more are taken), each row
reports ``spread_pct``, and a row whose tightest samples spread beyond
25% is marked ``"stable": false`` (see ``_measure_row``).  Operands are
passed whole, never sliced by a ``lax.scan`` over a block axis (XLA
materializes sliced operands with a copy).

Roofline shares (``pct_of_sol``) read against the published peaks of
the device (``runtime.metrics.PEAKS``, keyed by ``device_kind``); the
same run also prints the copy bandwidth and matmul rates it reaches.
A device without a row in that table is an error: this suite measures
the accelerator and never falls back to the CPU.

Baseline: the reference's implied real-time bound — its threaded FM
pipeline keeps up with an RTL-SDR at 1.14 Msps complex input
(examples/fm_radio.rs:57,144; BASELINE.md).  vs_baseline is the
speedup over that 1.14 Msamples/s rate.

Inputs are generated on the device; values are irrelevant to
throughput.
"""

import json
import time

import numpy as np

BASELINE_MSPS = 1.14          # reference real-time bound (BASELINE.md)

# Set in main() before any row runs: the device every row names, and
# its published peaks (runtime.metrics.PEAKS).
_DEVICE = {}
_PEAKS = {}


# --------------------------------------------------------------- timing

def _timed_call(fn, args):
    """Wall seconds of one dispatch, ended by ``block_until_ready``."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    return max(time.perf_counter() - t0, 1e-6)


def _best_of(fn, args, reps=3, budget_s=30.0):
    best = float("inf")
    deadline = time.perf_counter() + budget_s
    done = 0
    while done < reps and time.perf_counter() < deadline:
        best = min(best, _timed_call(fn, args))
        done += 1
    return best


def _measure_row(make_fn, args, per_pass, pilot_R=4, target_s=None,
                 reps=3, max_R=4096, spread_bound_pct=25.0):
    """Build ONE jitted dynamic-R runner, calibrate R, and SLOPE-
    measure the row: throughput = per_pass / marginal-seconds-per-
    added-pass between R and 2R passes, which cancels every fixed
    overhead (dispatch, sync readback, operand staging) instead of
    subtracting an estimate of it.

    Reproducibility contract:

    * R is calibrated so the timed region at R is >= ``target_s``
      seconds (2R twice that) — dispatch noise then perturbs the
      slope, not the reading;
    * >= ``reps`` independent slope samples are taken (each one a
      fresh t(2R) - t(R) pair); if their spread exceeds ~10% the
      row takes up to 2 more rounds of samples;
    * the reported value is the MEDIAN slope of the best
      (tightest-spread) ``reps`` samples, and every row carries
      ``spread_pct`` (max/min - 1 over those samples).  A row whose
      spread still exceeds ``spread_bound_pct`` is marked
      ``"stable": false`` — recorded (the driver contract needs the
      final flagship line) but self-declared non-reproducible.

    Returns ``(samples_per_second, seconds_for_R_passes, R, extra)``
    where extra is the dict to merge into the row's JSON.

    ``make_step(*args)`` is traced under jit and must return
    ``(carry0, body)`` where ``body(carry) -> carry`` runs ONE pass of
    ``per_pass`` samples with a chained f32 checksum somewhere in the
    carry (the data dependency defeats hoisting/DCE).  R is a TRACED
    ``fori_loop`` bound, so calibration and every sample share ONE
    compile.
    """
    import jax
    from jax import lax

    make_step = make_fn
    if target_s is None:
        target_s = 0.5

    @jax.jit
    def f(R, *a):
        carry0, body = make_step(*a)
        c = lax.fori_loop(0, R, lambda i, cc: body(cc), carry0)
        return _cks(c)

    pa = (np.int32(pilot_R),) + tuple(args)
    _timed_call(f, pa)                       # warm: compile + drain
    t_pilot = _best_of(f, pa, reps=2, budget_s=20.0)
    per_pass_t = max(t_pilot / pilot_R, 1e-7)
    R = int(min(max_R, max(pilot_R, round(target_s / per_pass_t))))
    a1 = (np.int32(R),) + tuple(args)
    a2 = (np.int32(2 * R),) + tuple(args)

    slopes = []                              # seconds per added pass
    for round_ in range(3):                  # 1 round + up to 2 extra
        for _ in range(reps):
            t1 = _timed_call(f, a1)
            t2 = _timed_call(f, a2)
            if t2 > t1:                      # DISCARD non-positive
                slopes.append((t2 - t1) / R)
            # (clamping them instead would let a contended run report
            # an absurd rate with 0% spread — a reviewer catch)
        if len(slopes) < reps:
            continue
        best = _tightest(slopes, reps)
        spread = (max(best) / min(best) - 1.0) * 100.0
        if spread <= 10.0:
            break
    if not slopes:                           # every sample inverted:
        med = max(t_pilot / pilot_R, 1e-9)   # fall back to the pilot
        return (per_pass / med, R * med, R,
                {"spread_pct": 100.0, "stable": False})
    if len(slopes) < reps:
        best = slopes
        spread = (max(best) / min(best) - 1.0) * 100.0
    med = sorted(best)[len(best) // 2]
    extra = {"spread_pct": round(spread, 1)}
    if spread > spread_bound_pct or len(slopes) < reps:
        extra["stable"] = False
    return per_pass / med, R * med, R, extra


def _tightest(samples, k):
    """The k consecutive values (sorted) with the smallest max/min
    ratio — the agreeing subset among noisy samples."""
    s = sorted(samples)
    if len(s) <= k:
        return s
    best = min(range(len(s) - k + 1), key=lambda i: s[i + k - 1] / s[i])
    return s[best:best + k]


def _cks(y):
    """Cheap f32 checksum of a pytree: strided sums touching every
    leaf buffer (forces materialization without re-reading it all)."""
    import jax
    import jax.numpy as jnp

    tot = jnp.float32(0)
    for leaf in jax.tree_util.tree_leaves(y):
        x = leaf
        if jnp.iscomplexobj(x):
            x = jnp.real(x)
        x = x.ravel()
        stride = max(1, x.size // 64)
        tot = tot + jnp.sum(x[::stride].astype(jnp.float32))
    return tot


def _chain(state, s):
    """Fold the carried scalar checksum into every float leaf of a
    model state (x + s*1e-30): makes each pass's operands depend on
    the previous pass's OUTPUT, so no part of the body is
    syntactically loop-invariant and hoistable — several model states
    are otherwise pure input slices after the first pass (the FIR
    rows measured real rates either way, but hoisting would be LEGAL
    and a compiler upgrade must not be able to fake a record)."""
    import jax
    import jax.numpy as jnp

    def leaf(a):
        if hasattr(a, "dtype") and jnp.issubdtype(a.dtype, jnp.floating):
            return a + (s * jnp.float32(1e-30)).astype(a.dtype)
        if hasattr(a, "dtype") and jnp.issubdtype(a.dtype, jnp.complexfloating):
            return a + (s * jnp.float32(1e-30)).astype(a.dtype)
        return a
    return jax.tree_util.tree_map(leaf, state)


def _row(metric, msps, extra=None):
    r = {"metric": metric, "value": round(msps, 2), "unit": "Msamples/s",
         "vs_baseline": round(msps / BASELINE_MSPS, 1), **_DEVICE}
    if extra:
        r.update(extra)
    print(json.dumps(r), flush=True)
    return r


def _roof(best_s, bytes_per_pass, flops_per_pass, R, peak="f32_tflops"):
    """Roofline share against the device's published peaks; ``peak``
    names the compute peak the row's arithmetic runs at."""
    from comms_tpu.runtime import metrics

    rl = metrics.roofline(
        bytes_moved=R * bytes_per_pass, flops=R * flops_per_pass,
        seconds=best_s, hbm_gbps=_PEAKS["hbm_gbps"],
        peak_tflops=_PEAKS[peak])
    return {"pct_of_sol": rl["pct_of_sol"], "bound": rl["bound"]}


def _device_info():
    """Platform, device kind, device count and power limit of the run
    (``nvidia-smi``'s reading, or "not measured")."""
    import subprocess

    import jax

    d = jax.devices()[0]
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.splitlines()[0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        out = "not measured"
    return {"platform": d.platform, "device_kind": d.device_kind,
            "device_count": len(jax.devices()), "power_limit": out}


# --------------------------------------------------------- device inputs

def _device_pairs(shape, seed=0):
    """f32 planes generated on the device (one jitted dispatch);
    values are irrelevant to throughput."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def gen(key):
        return jax.random.normal(key, shape, dtype=jnp.float32)

    return gen(jax.random.PRNGKey(seed))


def _device_u8(shape, seed=0):
    import jax
    import jax.numpy as jnp

    @jax.jit
    def gen(key):
        return jax.random.randint(key, shape, 0, 256,
                                  dtype=jnp.int32).astype(jnp.uint8)

    return gen(jax.random.PRNGKey(seed))


# ------------------------------------------------------------ rooflines

def _slope_seconds(make_step, args, K1, K2):
    """Marginal seconds per added in-dispatch iteration — fixed
    overheads (dispatch, sync) cancel in the difference.
    ``make_step`` has the same dynamic-count contract as
    ``_measure_row`` (one compile serves both K values)."""
    import jax
    from jax import lax

    @jax.jit
    def f(K, *a):
        carry0, body = make_step(*a)
        c = lax.fori_loop(0, K, lambda i, cc: body(cc), carry0)
        return _cks(c)

    a1 = (np.int32(K1),) + tuple(args)
    a2 = (np.int32(K2),) + tuple(args)
    _timed_call(f, a2)
    t1 = _best_of(f, a1, reps=3, budget_s=20.0)
    t2 = _best_of(f, a2, reps=3, budget_s=30.0)
    return max((t2 - t1) / (K2 - K1), 1e-9)


def _measure_copy_gbps():
    import jax
    import jax.numpy as jnp
    from jax import lax

    n = 1 << 27                       # 512 MB of f32
    x = _device_pairs((n,), seed=99)

    def make_step(a):
        def body(c):
            return c * jnp.float32(1.0000001)
        return a, body

    # median of three slopes
    samples = sorted(_slope_seconds(make_step, (x,), 8, 32)
                     for _ in range(3))
    return 2 * 4 * n / samples[1] / 1e9


def _measure_matmul_tflops(bf16):
    """Marginal matmul rate: K dependent relu'd matmuls in one scan
    (the nonlinearity + data dependency defeat algebraic folding)."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    n = 4096
    w = _device_pairs((n, n), seed=100)
    if bf16:
        w = jax.jit(lambda a: a.astype(jnp.bfloat16))(w)

    def make_step(a):
        def body(c):
            y = (jnp.dot(c, a) if bf16 else
                 jnp.dot(c, a, precision=lax.Precision.HIGHEST))
            return jnp.maximum(y, 0) * y.dtype.type(1e-3)
        return a, body

    s = _slope_seconds(make_step, (w,), 16 if bf16 else 8,
                       64 if bf16 else 32)
    return 2 * n ** 3 / s / 1e12


# ----------------------------------------------------------------- rows

def bench_bpsk_tx():
    import jax
    import jax.numpy as jnp
    from jax import lax

    from comms_tpu.models import bpsk_tx

    # Production path: fused bits->packed-i16 planar GEMM
    # (models/bpsk_tx.make_block_fn_fast).
    cfg = bpsk_tx.BpskTxConfig(syms_per_block=1 << 22)
    blk = bpsk_tx.make_block_fn_fast(cfg)
    nb = 4

    def make_step(state):
        def body(c):
            st, acc = c
            def inner(cc, _):
                y, cc = blk(cc)
                return cc, _cks(y)
            st, cs = lax.scan(inner, st, None, length=nb)
            return (st, acc + jnp.sum(cs))
        return (state, _f32(0)), body

    msps, best, R, ex = _measure_row(make_step,
                                 (bpsk_tx.init_state_fast(cfg),),
                                 nb * cfg.samples_per_block)
    _row("bpsk_tx_throughput", msps / 1e6, ex)


def _f32(v):
    import jax.numpy as jnp

    return jnp.float32(v)


def bench_qpsk_tx():
    import jax
    import jax.numpy as jnp
    from jax import lax

    from comms_tpu.models import qpsk_tx

    # Production path: fused bits->packed-i16 planar GEMM + planar
    # mixer (models/qpsk_tx.make_block_fn_fast).
    cfg = qpsk_tx.QpskTxConfig(bits_per_block=1 << 23)
    blk = qpsk_tx.make_block_fn_fast(cfg)
    nb = 4

    def make_step(state):
        def body(c):
            st, acc = c
            def inner(cc, _):
                y, cc = blk(cc)
                return cc, _cks(y)
            st, cs = lax.scan(inner, st, None, length=nb)
            return (st, acc + jnp.sum(cs))
        return (state, _f32(0)), body

    msps, best, R, ex = _measure_row(make_step,
                                 (qpsk_tx.init_state_fast(cfg),),
                                 nb * cfg.samples_per_block)
    _row("qpsk_tx_throughput", msps / 1e6, ex)


def bench_qpsk_rx():
    import jax
    import jax.numpy as jnp
    from jax import lax

    from comms_tpu.models import qpsk_rx

    cfg = qpsk_rx.QpskRxConfig()
    rx = qpsk_rx.make_rx_fn(cfg)
    n = 1 << 25                       # one whole 33.5M-sample capture
    pairs = _device_pairs((n, 2), seed=10)

    def make_step(block):
        def body(c):
            (acc,) = c
            # acc-dependent perturbation: defeats hoisting of this
            # stateless body out of the rep loop
            sym, _aux = rx(block + acc * jnp.float32(1e-30))
            return (acc + _cks(sym),)
        return (_f32(0),), body

    msps, best, R, ex = _measure_row(make_step, (pairs,), n)
    _row("qpsk_rx_throughput", msps / 1e6, ex)

    # Planar entry (production ingest layout: io/raw_iq unpacks
    # interleaved i16 to planes, so the receiver never pays the
    # [N, 2] pair deinterleave — a 2/128-lane relayout).
    rxp = qpsk_rx.make_rx_fn_planar(cfg)
    re_d = jnp.asarray(pairs[:, 0])
    im_d = jnp.asarray(pairs[:, 1])

    def make_step_planar(re_d, im_d):
        def body(c):
            (acc,) = c
            sym, _aux = rxp(re_d + acc * jnp.float32(1e-30), im_d)
            return (acc + _cks(sym),)
        return (_f32(0),), body

    msps, best, R, ex = _measure_row(make_step_planar, (re_d, im_d), n)
    _row("qpsk_rx_planar_throughput", msps / 1e6, ex)

    # The estimate-pipelined STREAMING receiver (gap-free symbols,
    # carried context/phase), state chained across passes as it serves.
    from comms_tpu.models import qpsk_rx_stream

    step_s = qpsk_rx_stream.make_stream_fast_fn(cfg)

    def make_step_stream(re_d, im_d):
        def body(c):
            st, acc = c
            sym, st = step_s(st, re_d + acc * jnp.float32(1e-30), im_d)
            return (st, acc + _cks(sym))
        return ((qpsk_rx_stream.init_state_fast(cfg), _f32(0)), body)

    msps, best, R, ex = _measure_row(make_step_stream, (re_d, im_d), n)
    _row("qpsk_rx_stream_throughput", msps / 1e6, ex)


def bench_channelizer():
    """64-channel channelizer model, planar ingest, state chained."""
    import jax.numpy as jnp

    from comms_tpu.models import channelizer

    block = 1 << 24                       # one 16.8M-sample block
    cfg = channelizer.ChannelizerConfig(block=block)
    blk = channelizer.make_planar_block_fn(cfg)
    res = _device_pairs((block,), seed=11)
    ims = _device_pairs((block,), seed=18)

    def make_step(state, res, ims):
        def body(c):
            st, acc = c          # state chained: pass = next block
            y, st = blk(st, res, ims)
            s = acc + _cks(y)
            return (_chain(st, s), s)
        return (state, _f32(0)), body

    msps, best, R, ex = _measure_row(
        make_step, (channelizer.init_state(cfg), res, ims), block)
    _row("channelizer64_throughput", msps / 1e6, ex)


def bench_band_monitor():
    from comms_tpu.models import fm_band_monitor

    cfg = fm_band_monitor.BandMonitorConfig(block=1 << 24)
    blk = fm_band_monitor.make_block_fn(cfg)
    pairs = _device_pairs((cfg.block, 2), seed=12)

    def make_step(state, block):
        def body(c):
            st, acc = c              # state chained: pass = next block
            y, st = blk(st, block)
            s = acc + _cks(y)
            return (_chain(st, s), s)
        return (state, _f32(0)), body

    msps, best, R, ex = _measure_row(
        make_step, (fm_band_monitor.init_state(cfg), pairs), cfg.block)
    _row("fm_band_monitor_throughput", msps / 1e6, ex)


def bench_wideband_psd():
    """The distributed FFT's consumer (wideband.make_sharded_psd): a
    2^20-bin Welch PSD over 32 segments, planes fed (the serving-ingest
    layout).  On one device the mesh is trivial (the dfft reduces to
    the local FFT)."""
    import jax.numpy as jnp

    from comms_tpu.parallel import sharding as sh
    from comms_tpu.parallel import wideband

    F, B = 1 << 20, 32
    psd = wideband.make_sharded_psd_planar(F, sh.time_mesh(1))
    res = _device_pairs((B, F), seed=24)
    ims = _device_pairs((B, F), seed=25)

    def make_step(res, ims):
        def body(c):
            (acc,) = c
            y = psd(res + acc * jnp.float32(1e-30), ims)
            return (acc + _cks(y),)
        return (_f32(0),), body

    msps, best, R, ex = _measure_row(make_step, (res, ims), B * F)
    _row("wideband_psd_2pow20_throughput", msps / 1e6, ex)


def bench_kernels():
    import jax
    import jax.numpy as jnp

    from comms_tpu.ops import fir

    rng = np.random.default_rng(3)
    taps63 = rng.normal(size=63).astype(np.complex64)

    # ---- dense streaming FIR, 63 complex taps (banded GEMM).
    B = fir.banded_tap_matrix(taps63)
    nf = 1 << 24                       # one whole 16.8M-sample block
    per_pass = nf
    fres = _device_pairs((nf,), seed=20)
    fims = _device_pairs((nf,), seed=21)

    # Anti-CSE: the returned ctx is a SLICE OF THE INPUT (loop-
    # invariant), so chaining it alone leaves the body invariant after
    # iteration 1 and legally hoistable.  Fold the carried scalar
    # checksum into the ctx: every pass's operands then depend on the
    # previous pass's output.
    def make_fir_xla(res, ims):
        z = jax.lax.complex(res, ims)

        def body(c):
            ctx, acc = c
            y, ctx = fir.fir_block(z, B, ctx)
            s = acc + _cks(y)
            return (ctx + s * jnp.complex64(1e-30), s)
        return (fir.init_ctx(63), _f32(0)), body

    msps_x, best_x, R_x, ex_x = _measure_row(make_fir_xla, (fres, fims),
                                             per_pass)
    _row("kernel_fir63_throughput", msps_x / 1e6,
         {**ex_x, **_roof(best_x, 16 * per_pass, 8 * 63 * per_pass, R_x)})

    # ---- polyphase decimating FIR /5 (the FM chain's hot pair,
    # fm_radio.rs:144-151), ctx chained through the passes.
    from comms_tpu.models.fm_receiver import FM_LPF_TAPS

    npal = 128 * 5 * 128 * 256               # one whole 21M-sample block
    per_pass = npal
    res = _device_pairs((npal,), seed=14)
    ims = _device_pairs((npal,), seed=19)
    C = fir.decimating_branch_taps(FM_LPF_TAPS.astype(np.float32), 5)

    def make_poly_xla(res, ims):
        def body(c):
            ctx, acc = c
            y, ctx = fir.fir_decimate_poly(
                jax.lax.complex(res, ims), C, ctx)
            s = acc + _cks(y)
            return (ctx + s * jnp.complex64(1e-30), s)
        return (jnp.zeros(C.size - 1, jnp.complex64), _f32(0)), body

    msps_x, best_x, R_x, ex_x = _measure_row(make_poly_xla, (res, ims),
                                             per_pass)
    bytes_pp = 8 * per_pass + 8 * per_pass // 5
    flops_pp = 8 * 63 * per_pass // 5
    _row("kernel_polyphase_fir63_dec5_throughput", msps_x / 1e6,
         {**ex_x, **_roof(best_x, bytes_pp, flops_pp, R_x)})

    # ---- batched FFTs: XLA's FFT (cuFFT) at 1024..16384 points and
    # the four-step matmul FFT at 1024, identical 16.8M-sample batches,
    # natural order.
    from comms_tpu.ops import fft as cfft

    per_pass = 1 << 24

    def make_fft(fft_fn):
        def make_step(res, ims):
            def body(c):
                (acc,) = c
                z = fft_fn(jax.lax.complex(
                    res + acc * jnp.float32(1e-30), ims))
                return (acc + _cks(z),)
            return (_f32(0),), body
        return make_step

    for nfft in (1024, 4096, 8192, 16384):
        rn = _device_pairs((per_pass // nfft, nfft), seed=22)
        imn = _device_pairs((per_pass // nfft, nfft), seed=23)
        flops = 5 * per_pass * int(np.log2(nfft))
        msps_n, best_n, R_n, ex_n = _measure_row(make_fft(jnp.fft.fft),
                                                 (rn, imn), per_pass)
        _row(f"kernel_fft{nfft}_throughput", msps_n / 1e6,
             {**ex_n, **_roof(best_n, 16 * per_pass, flops, R_n)})
        if nfft == 1024:
            qres, qims = rn, imn
            msps_m, best_m, R_m, ex_m = _measure_row(
                make_fft(cfft.fft_four_step), (rn, imn), per_pass)
            _row("kernel_fft1024_fourstep_throughput", msps_m / 1e6,
                 {**ex_m, **_roof(best_m, 16 * per_pass, flops, R_m)})

    # ---- Welch PSD (window+FFT+|.|^2+accumulate, 1024 bins, 50%
    # overlap).  Anti-CSE via the WINDOW operand: welch reduces to
    # bins, so there is no output to chain, and perturbing the input
    # would add a full pass of traffic.
    from comms_tpu.ops import spectrum

    nsamp = per_pass
    wbase = jnp.asarray(spectrum.hann(1024).astype(np.float32))

    def make_welch(res, ims):
        z = jax.lax.complex(res, ims).reshape(-1)

        def body(c):
            (acc,) = c
            _, p = spectrum.welch_psd(z, nperseg=1024,
                                      window=wbase
                                      + acc * jnp.float32(1e-30))
            return (acc + _cks(p),)
        return (_f32(0),), body

    msps_w, best_w, R_w, ex_w = _measure_row(make_welch, (qres, qims),
                                             nsamp)
    _row("kernel_welch1024_throughput", msps_w / 1e6,
         {**ex_w, **_roof(best_w, 8 * nsamp, 2 * 5 * nsamp * 10, R_w)})


def _fm_production(cfg):
    """The FM chain ``run_file`` would serve for ``cfg``: the fused
    kernel where ``fused_chain_ok`` routes to it, else the XLA chain.
    Returns ``(block_fn, init_state_fn, path)``."""
    from comms_tpu.models import fm_receiver

    if fm_receiver.fused_chain_ok(cfg):
        return (fm_receiver.make_fused_block_fn(cfg),
                fm_receiver.fused_init_state, "kernel")
    return (fm_receiver.make_block_fn(cfg),
            lambda: fm_receiver.init_state(cfg), "xla")


def bench_fm_receiver():
    from comms_tpu.models import fm_receiver

    cfg = fm_receiver.FmReceiverConfig(block=26214400)
    per_pass = cfg.block
    # chain memory floor: u8 pairs in (2 B/sample) + f32 audio out
    # (4/25 B/sample)
    bytes_pp = int(per_pass * (2 + 4 / 25))
    flops_pp = int(per_pass * 2 * 26)

    # Three rows:
    #  - the XLA chain (make_block_fn),
    #  - the same chain as a generic runtime Pipeline,
    #  - FLAGSHIP (final line): the production streaming path, the one
    #    run_file takes — the fused kernel where fused_chain_ok routes
    #    to it, else the XLA chain — state chained block to block.
    # Operands are whole blocks, never scan-sliced.
    iq = _device_u8((cfg.block, 2), seed=15)
    blk = fm_receiver.make_block_fn(cfg)
    pipe = fm_receiver.make_pipeline(cfg)
    pblk, pinit, path = _fm_production(cfg)

    def maker(step_fn):
        def make_step(state, iq):
            def body(c):
                st, acc = c
                y, st = step_fn(st, iq)
                s = acc + _cks(y)
                return (_chain(st, s), s)
            return (state, _f32(0)), body
        return make_step

    msps_x, best_x, R_x, ex_x = _measure_row(
        maker(blk), (fm_receiver.init_state(cfg), iq), per_pass, pilot_R=2)
    msps_pl, best_pl, R_pl, ex_pl = _measure_row(
        maker(pipe.step), (pipe.init_state(), iq), per_pass, pilot_R=2)
    msps_f, best_f, R_f, ex_f = _measure_row(
        maker(pblk), (pinit(), iq), per_pass, pilot_R=4)
    _row("fm_receiver_xla_throughput", msps_x / 1e6,
         {**ex_x, **_roof(best_x, bytes_pp, flops_pp, R_x)})
    _row("fm_receiver_pipeline_throughput", msps_pl / 1e6,
         {**ex_pl, **_roof(best_pl, bytes_pp, flops_pp, R_pl)})
    _row("fm_receiver_chain_throughput", msps_f / 1e6,
         {**ex_f, **_roof(best_f, bytes_pp, flops_pp, R_f,
                          peak="bf16_tflops"),
          "path": path})


def bench_fm_serving():
    """End-to-end SERVING row: the production FM chain driven by the
    runtime's StreamRunner — per-block host dispatch, device-generated
    source, a scalar per-block summary drained to the host through the
    depth-N prefetch window (the reference's free-running source/sink
    threads, node/mod.rs:275-284, become this loop).  Every block's
    summary IS fetched (honest completion); the depth-1 comparator
    shows what the prefetch window buys.  The audio itself is not
    drained here."""
    import jax
    import jax.numpy as jnp

    from comms_tpu.models import fm_receiver
    from comms_tpu.runtime import StreamRunner

    B = 16384 * fm_receiver.FUSED_BLOCK_QUANTUM      # 104.8M samples/block
    blk, init, _ = _fm_production(fm_receiver.FmReceiverConfig(block=B))

    iq = _device_u8((B, 2), seed=7)

    @jax.jit
    def step(st, x):
        y, st = blk(st, x)
        return y[0] + y[-1], st

    jax.block_until_ready(step(init(), iq))     # warm: compile

    def run_once(depth, S):
        sink_acc = []
        runner = StreamRunner(step, init(), [iq] * S,
                              sink=lambda a: sink_acc.append(float(a)),
                              samples_of=lambda x: B, depth=depth)
        t0 = time.perf_counter()
        runner.run()
        t = time.perf_counter() - t0
        assert len(sink_acc) == S
        return S * B / t

    for depth, S, runs, name in (
            (1, 12, 5, "fm_receiver_serving_depth1_throughput"),
            (16, 32, 3, "fm_receiver_serving_throughput")):
        vals = sorted(run_once(depth, S) for _ in range(runs))
        mid = vals[1:-1] if runs >= 5 else vals
        spread = (mid[-1] / mid[0] - 1.0) * 100.0
        extra = {"spread_pct": round(spread, 1), "depth": depth}
        if spread > 25.0:
            extra["stable"] = False
        _row(name, vals[runs // 2] / 1e6, extra)


def bench_serving_batched():
    """Batched multi-stream serving: B independent streams carried by
    ONE dispatch per round through ``runtime.BatchedStreamRunner`` —
    the analogue of the reference running N independent flowgraphs as
    N thread sets (node/mod.rs:275-284).  A single stream served at a
    realistic per-client block size pays one program launch per block;
    batching B streams amortizes it B ways.

    Each row reports the AGGREGATE Msps across the batch plus the
    single-stream comparator at the SAME per-stream block size and
    depth (``single_stream_msps``) and their ratio (``scaling_x``).
    Per-stream states stay independent (bit-equal to B separate runs
    in mode='map' — tests/test_serving_batched.py)."""
    import jax
    import jax.numpy as jnp

    from comms_tpu.models import fm_receiver, qpsk_rx, qpsk_rx_stream
    from comms_tpu.runtime import BatchedStreamRunner, StreamRunner

    B, DEPTH = 8, 16

    def _serve_pair(name, step, init_state, make_block, n_stream,
                    mode, S, RUNS=5):
        """Measure single-stream vs B-stream-batched serving of the
        same step at the same per-stream block size; emit one row —
        the median of ``RUNS`` runs with spread over the middle
        three."""
        xb = make_block()                       # batched [B, ...] pytree
        x1 = jax.tree_util.tree_map(lambda a: a[0], xb)

        def run_single():
            sink_acc = []
            r = StreamRunner(step, init_state(), [x1] * S,
                             sink=lambda a: sink_acc.append(float(a)),
                             samples_of=lambda x: n_stream, depth=DEPTH)
            t0 = time.perf_counter()
            r.run()
            t = time.perf_counter() - t0
            assert len(sink_acc) == S
            return S * n_stream / t

        def run_batched():
            sink_acc = []
            r = BatchedStreamRunner(
                step, [init_state() for _ in range(B)],
                batched_source=[xb] * S,
                sinks=None, mode=mode, depth=DEPTH,
                samples_of=lambda x: B * n_stream)
            # drain each round's [B] summary vector through one host
            # readback (honest completion, one fetch per round)
            r.sink = lambda y: sink_acc.append(np.asarray(y).sum())
            t0 = time.perf_counter()
            r.run()
            t = time.perf_counter() - t0
            assert len(sink_acc) == S
            return S * B * n_stream / t

        run_single(); run_batched()             # warm: compile + drain
        singles = sorted(run_single() for _ in range(RUNS))
        batches = sorted(run_batched() for _ in range(RUNS))
        single = singles[RUNS // 2]
        agg = batches[RUNS // 2]
        mid = batches[1:-1] if RUNS >= 5 else batches
        spread = (mid[-1] / mid[0] - 1.0) * 100.0
        extra = {"spread_pct": round(spread, 1), "B": B, "depth": DEPTH,
                 "mode": mode,
                 "block_per_stream": n_stream,
                 "single_stream_msps": round(single / 1e6, 2),
                 "scaling_x": round(agg / single, 2)}
        if spread > 25.0:
            extra["stable"] = False
        _row(name, agg / 1e6, extra)

    # ---- FM chain: 8 radio clients, 1.6384M samples each per round.
    n_fm = 256 * fm_receiver.FUSED_BLOCK_QUANTUM
    fblk, finit, _ = _fm_production(fm_receiver.FmReceiverConfig(block=n_fm))

    def fm_step(st, x):
        y, st = fblk(st, x)
        return y[0] + y[-1], st

    _serve_pair("fm_receiver_serving_batched", fm_step, finit,
                lambda: _device_u8((B, n_fm, 2), seed=3), n_fm,
                mode="unroll", S=96)

    # ---- QPSK streaming receiver: 8 clients, 4.19M samples each; one
    # dispatch then carries the same 33.5M samples as the one-shot row.
    n_q = 32 * (1 << 17)
    qcfg = qpsk_rx.QpskRxConfig()
    qstep0 = qpsk_rx_stream.make_stream_fast_fn(qcfg)

    def q_step(st, x):
        sym, st = qstep0(st, x[0], x[1])
        return sym[0, 0] + sym[1, -1], st

    @jax.jit
    def q_gen(key):
        k1, k2 = jax.random.split(key)

        def f(k):
            return jax.random.normal(k, (B, n_q), jnp.float32)
        return f(k1), f(k2)

    _serve_pair("qpsk_rx_serving_batched", q_step,
                lambda: qpsk_rx_stream.init_state_fast(qcfg),
                lambda: q_gen(jax.random.PRNGKey(5)), n_q,
                mode="unroll", S=24)


def main():
    from comms_tpu.runtime import metrics
    from comms_tpu.runtime.compile_cache import enable_compile_cache

    enable_compile_cache()
    # No fallback: a device without published peaks (the CPU, an
    # unknown card) stops the suite here.
    _PEAKS.update(metrics.device_peaks())
    _DEVICE.update(_device_info())
    print(json.dumps({"metric": "device", **_DEVICE,
                      "peaks": _PEAKS}), flush=True)
    for name, fn, unit, spec in (
            ("measured_copy_bandwidth", _measure_copy_gbps, "GB/s",
             _PEAKS["hbm_gbps"]),
            ("measured_matmul_f32_tflops",
             lambda: _measure_matmul_tflops(bf16=False), "TFLOP/s",
             _PEAKS["f32_tflops"]),
            ("measured_matmul_bf16_tflops",
             lambda: _measure_matmul_tflops(bf16=True), "TFLOP/s",
             _PEAKS["bf16_tflops"])):
        try:
            v = fn()
            print(json.dumps({"metric": name, "value": round(v, 1),
                              "unit": unit, "of_peak": round(v / spec, 3),
                              **_DEVICE}), flush=True)
        except Exception as e:  # a broken row must not hide the rest
            print(json.dumps({"metric": name, "error": str(e)}), flush=True)
    for bench in (bench_bpsk_tx, bench_qpsk_tx, bench_qpsk_rx,
                  bench_channelizer, bench_band_monitor,
                  bench_wideband_psd, bench_kernels, bench_fm_serving,
                  bench_serving_batched, bench_fm_receiver):
        try:
            bench()
        except Exception as e:  # a broken row must not hide the rest
            print(json.dumps({"metric": bench.__name__, "error": str(e)}),
                  flush=True)


if __name__ == "__main__":
    main()
