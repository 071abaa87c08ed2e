"""FM broadcast receiver: the reference's flagship Rx pipeline.

Chain parity with ``/root/reference/examples/fm_radio.rs:144-168``
(10 threads, 9 channel hops there; ONE jitted function here):

    u8 IQ (262,144/block @ 1.14 Msps) -> (x-127.5)/127.5
    -> 63-tap LPF (FIR) -> decimate /5 -> FM quadrature demod
    -> 63-tap LPF (FIR) -> decimate /5 -> 45.6 kHz audio f32

The SDR source is replaced by recorded IQ (BASELINE config:
"recorded rtl-sdr IQ file -> FIR decimate -> FM quadrature demod ->
audio-rate resample"); the audio device sink becomes a PCM buffer /
WAV writer.  The FIR+decimate pairs fuse into banded-Toeplitz GEMMs;
carried state = 62-sample FIR tails + 1-sample FM prev.

The 63 LPF coefficients are the data constants from fm_radio.rs:29-55.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

from comms_tpu.kernels import fm_chain_pallas as _K
from comms_tpu.ops import demodulation, fir

__all__ = ["FM_LPF_TAPS", "FmReceiverConfig", "make_block_fn",
           "make_pipeline", "make_scan_fn", "init_state", "run_file",
           "make_fused_block_fn", "fused_init_state", "fused_chain_ok",
           "FUSED_BLOCK_QUANTUM", "FUSED_TAIL_SAMPLES",
           "fused_ctx_from_raw_tail"]

# Low-pass filter coefficients from the reference example
# (fm_radio.rs:29-55) — data, symmetric 63-tap LPF.
FM_LPF_TAPS = np.array([
    -0.01801270027742274, -0.004656920885448867, -0.002648852132912597,
    0.0008677368918448623, 0.005009212152225975, 0.008526175375849215,
    0.010172968340398776, 0.00912437509989248, 0.005334905990231011,
    -0.0003335859703032652, -0.0063014158102353, -0.01064075999239304,
    -0.011581891677991056, -0.008341954525032592, -0.0012824780121151447,
    0.007845515892673058, 0.016328062816332187, 0.021185546181771774,
    0.02007654361670823, 0.01217403940591024, -0.0013140567851934943,
    -0.017152074443356792, -0.030621606809715814, -0.03659663988110718,
    -0.030901697984472332, -0.01147126195667417, 0.02079513703320541,
    0.06194329755943689, 0.10559594630001239, 0.14421303245485026,
    0.17074726962322123, 0.18019648556329151, 0.17074726962322123,
    0.14421303245485026, 0.10559594630001239, 0.06194329755943689,
    0.02079513703320541, -0.01147126195667417, -0.030901697984472332,
    -0.03659663988110718, -0.030621606809715814, -0.017152074443356792,
    -0.0013140567851934943, 0.01217403940591024, 0.02007654361670823,
    0.021185546181771774, 0.016328062816332187, 0.007845515892673058,
    -0.0012824780121151447, -0.008341954525032592, -0.011581891677991056,
    -0.01064075999239304, -0.0063014158102353, -0.0003335859703032652,
    0.005334905990231011, 0.00912437509989248, 0.010172968340398776,
    0.008526175375849215, 0.005009212152225975, 0.0008677368918448623,
    -0.002648852132912597, -0.004656920885448867, -0.01801270027742274,
], dtype=np.float64)


class FmReceiverConfig:
    """Block 262,144 samples (the rtl-sdr read granularity,
    rtlsdr_radio.rs:74-77); decimations 5 and 5 (fm_radio.rs:148-151).

    Two compute paths, selected by block divisibility:

    * **polyphase** (block % (dec1*dec2) == 0): decimating FIRs compute
      only the kept outputs — T MACs per *output*, a dec-x saving over
      filter-then-discard, with continuous decimation stride across
      blocks (streaming-correct).
    * **dense** (reference-parity): full-rate banded-Toeplitz FIR then
      per-block-reset stride, byte-matching the reference's chain for
      its exact 2^18 block size (which 5 does not divide).
    """

    def __init__(self, block: int = 262144, dec1: int = 5, dec2: int = 5):
        self.block = int(block)
        self.dec1 = int(dec1)
        self.dec2 = int(dec2)
        self.num_taps = len(FM_LPF_TAPS)
        self.polyphase = (self.block % (dec1 * dec2) == 0
                          and dec1 > 1 and dec2 > 1)
        if self.polyphase:
            self.Hb_iq = fir.decimating_branch_taps(
                FM_LPF_TAPS.astype(np.complex64), dec1)
            self.Hb_audio = fir.decimating_branch_taps(
                FM_LPF_TAPS.astype(np.float32), dec2)
        else:
            self.B_iq = fir.banded_tap_matrix(FM_LPF_TAPS.astype(np.complex64))
            self.B_audio = fir.banded_tap_matrix(
                FM_LPF_TAPS.astype(np.float32))

    @property
    def audio_per_block(self) -> int:
        # Per-block-reset decimation keeps ceil(n/rate) samples
        # (resample_node.rs:53-65), so 2^18 blocks are fine.  Same
        # double ceil-div as the causal tail rule: a full block is the
        # valid_out of its own length.
        return _tail_valid_out(self, self.block)

    @property
    def ctx1_len(self) -> int:
        return (self.Hb_iq.size - 1 if self.polyphase
                else self.num_taps - 1)

    @property
    def ctx2_len(self) -> int:
        return (self.Hb_audio.size - 1 if self.polyphase
                else self.num_taps - 1)


def init_state(cfg: FmReceiverConfig):
    """Boundary-safe state: complex FIR tail as f32 pairs."""
    return (
        jnp.zeros((cfg.ctx1_len, 2), dtype=jnp.float32),  # IQ FIR ctx
        jnp.zeros((2,), dtype=jnp.float32),               # FM prev
        jnp.zeros((cfg.ctx2_len,), dtype=jnp.float32),    # audio FIR ctx
    )


def make_block_fn(cfg: FmReceiverConfig):
    """jitted ``(state, iq_u8_pairs[N, 2]) -> (audio_f32[M], new_state)``.

    Input rows are raw rtl-sdr bytes (re, im) as uint8, exactly the
    recorded file layout.
    """
    # numpy closures: host constants baked into the program
    if cfg.polyphase:
        F1, F2 = cfg.Hb_iq, cfg.Hb_audio
    else:
        F1, F2 = cfg.B_iq, cfg.B_audio

    @jax.jit
    def block(state, iq_u8):
        ctx_pairs, prev_pair, actx = state
        # ConvertNode (fm_radio.rs:77-91): u8 -> (x - 127.5) / 127.5
        f = (iq_u8.astype(jnp.float32) - 127.5) / 127.5
        x = jax.lax.complex(f[:, 0], f[:, 1])

        ctx = jax.lax.complex(ctx_pairs[:, 0], ctx_pairs[:, 1])
        if cfg.polyphase:
            y, ctx = fir.fir_decimate_poly(x, F1, ctx)
        else:
            y, ctx = fir.fir_block(x, F1, ctx)
            y = y[:: cfg.dec1]

        prev = jax.lax.complex(prev_pair[0], prev_pair[1])
        # polynomial atan2 (5e-7 rad vs the chain's 2e-4 oracle
        # budget): exact jnp.angle alone was ~40% of this chain's time
        d, prev = demodulation.fm_demod_block(y, prev, fast=True)

        if cfg.polyphase:
            audio, actx = fir.fir_decimate_poly(d, F2, actx)
        else:
            a, actx = fir.fir_block(d, F2, actx)
            audio = a[:: cfg.dec2]

        new_state = (
            jnp.stack([jnp.real(ctx), jnp.imag(ctx)], axis=-1),
            jnp.stack([jnp.real(prev), jnp.imag(prev)]),
            actx,
        )
        return audio, new_state

    return block


def make_pipeline(cfg: Optional[FmReceiverConfig] = None):
    """The same chain expressed on the generic runtime layer — a
    :class:`comms_tpu.runtime.Pipeline` of `BlockOp`s (the reference
    builds every example on its node layer, fm_radio.rs:144-168; this
    is the equivalent program here).

    ``pipe.run(pipe.init_state(), blocks)`` matches
    :func:`make_scan_fn` sample-for-sample (polyphase path — block
    must divide by dec1*dec2) and benches within noise of it
    (``fm_receiver_pipeline_throughput`` row): the abstraction is
    free, because the Pipeline compiles to the same fused XLA program.
    """
    from comms_tpu.runtime import FirDecimate, FmDemod, Lambda, Pipeline

    cfg = cfg or FmReceiverConfig()

    def convert(iq_u8):
        f = (iq_u8.astype(jnp.float32) - 127.5) / 127.5
        return jax.lax.complex(f[:, 0], f[:, 1])

    return Pipeline([
        Lambda(convert, result_dtype=jnp.complex64),
        FirDecimate.make(FM_LPF_TAPS.astype(np.complex64), cfg.dec1),
        FmDemod(fast=True),       # matches make_block_fn's demod
        FirDecimate.make(FM_LPF_TAPS.astype(np.float32), cfg.dec2),
    ])


def make_scan_fn(cfg: FmReceiverConfig):
    """Multi-block driver: ``(state, iq_u8[num_blocks, block, 2]) ->
    (audio[num_blocks, M], state)`` as ONE jitted ``lax.scan`` — a
    single dispatch processes the whole super-block with state carried
    on device (the host never touches the stream between blocks)."""
    block = make_block_fn(cfg)

    @jax.jit
    def scan(state, blocks):
        def body(carry, xb):
            audio, carry = block(carry, xb)
            return carry, audio

        state2, audio = jax.lax.scan(body, state, blocks)
        return audio, state2

    return scan


def _tail_valid_out(cfg: FmReceiverConfig, v: int) -> int:
    """Audio samples of a length-``v`` ragged tail that are exact
    samples of the infinite stream.  The whole chain is causal —
    audio[j] depends only on inputs <= j*dec1*dec2 — so zero-padding
    the tail to a full block and truncating to this count reproduces
    the unchopped stream exactly (SURVEY.md section 7, ragged tails)."""
    mid = -(-v // cfg.dec1)
    return -(-mid // cfg.dec2)


def _append_tail(block_fn, state, tail_iq: np.ndarray,
                 cfg: FmReceiverConfig, chunks: list) -> None:
    """Process a final ragged block: pad to the full static block
    shape (reusing the already-compiled step — no retrace) and keep
    only the causally-valid prefix of the audio."""
    v = int(tail_iq.shape[0])
    if v == 0:
        return
    pad = np.zeros((cfg.block - v, 2), np.uint8)
    audio, _ = block_fn(state, jnp.asarray(np.concatenate([tail_iq, pad])))
    chunks.append(np.asarray(audio)[: _tail_valid_out(cfg, v)])


# --------------------------------------------------------------- fused path
# The single-kernel chain (kernels/fm_chain_pallas.py): interleaved u8
# IQ in, audio out, nothing else written.  The block length must be a
# multiple of the kernel's per-program quantum; the carried state is the
# previous block's last ``FUSED_TAIL_SAMPLES`` input samples, centred.

FUSED_BLOCK_QUANTUM = _K.BLOCK_QUANTUM
FUSED_TAIL_SAMPLES = _K.CTX


def fused_ctx_from_raw_tail(iq_u8_tail):
    """:func:`make_fused_block_fn`'s carried state from the last
    ``>= FUSED_TAIL_SAMPLES`` raw ``[n, 2]`` u8 samples preceding a
    block boundary (also each shard's left context in
    :mod:`comms_tpu.parallel.fused_wideband`)."""
    if iq_u8_tail.shape[0] < FUSED_TAIL_SAMPLES:
        raise ValueError(
            f"need >= {FUSED_TAIL_SAMPLES} raw tail samples, "
            f"got {iq_u8_tail.shape[0]}")
    return _K.centered_ctx(iq_u8_tail[-FUSED_TAIL_SAMPLES:])


def fused_init_state():
    """Stream-start state for :func:`make_fused_block_fn`."""
    return _K.zero_ctx()


def make_fused_block_fn(cfg: Optional[FmReceiverConfig] = None,
                        interpret: bool = False):
    """jitted ``(state, iq_u8[N, 2]) -> (audio[N/25], state)`` running
    the fused kernel — the same signature as :func:`make_block_fn`,
    with the state of :func:`fused_init_state`.  N = cfg.block must be
    a multiple of FUSED_BLOCK_QUANTUM.  Output matches
    :func:`make_block_fn`'s polyphase path to f32 rounding (both FIRs
    in f32, the same polynomial atan2).  ``interpret`` runs the Pallas
    interpreter (CPU tests)."""
    cfg = cfg or FmReceiverConfig(block=1024 * FUSED_BLOCK_QUANTUM)
    if cfg.block % FUSED_BLOCK_QUANTUM:
        raise ValueError(
            f"fused chain needs block % {FUSED_BLOCK_QUANTUM} == 0, "
            f"got {cfg.block}")
    if cfg.dec1 != 5 or cfg.dec2 != 5:
        raise ValueError("fused chain is specialized to dec1 = dec2 = 5")

    @jax.jit
    def block(state, iq_u8):
        audio = _K.fm_chain_fused(iq_u8, state, FM_LPF_TAPS, FM_LPF_TAPS,
                                  interpret=interpret)
        return audio, fused_ctx_from_raw_tail(iq_u8)

    return block


def fused_chain_ok(cfg: FmReceiverConfig) -> bool:
    """Routing: the fused kernel runs where it compiles (a GPU) and
    the configuration fits it; everything else runs the XLA chain."""
    return (cfg.polyphase and cfg.block % FUSED_BLOCK_QUANTUM == 0
            and cfg.dec1 == 5 and cfg.dec2 == 5
            and jax.default_backend() == "gpu")


def _fused_to_xla_state(cfg: FmReceiverConfig, fstate):
    """Map the fused state (centred input tail) onto make_block_fn's
    state, for the ragged-tail XLA block: the FIR context is the tail
    itself; the demod ``prev`` and the audio-FIR context are recomputed
    from the last 510 samples (a multiple of dec1, so the mid-rate
    phase lines up; the last 64 demod values need only the last 387)."""
    x = fstate[:, -510:] / 127.5
    mid, _ = fir.fir_decimate_poly(
        jax.lax.complex(x[0], x[1]), cfg.Hb_iq,
        jnp.zeros((cfg.ctx1_len,), jnp.complex64))
    d, prev = demodulation.fm_demod_block(
        mid, jnp.zeros((), jnp.complex64), fast=True)
    return (
        (fstate[:, -cfg.ctx1_len:] / 127.5).T,
        jnp.stack([jnp.real(prev), jnp.imag(prev)]),
        d[-cfg.ctx2_len:],
    )


def run_file(iq_path, cfg: Optional[FmReceiverConfig] = None,
             out_path=None, fused: Optional[bool] = None) -> np.ndarray:
    """Demodulate a recorded u8-IQ file; returns (and optionally
    writes, as f32 PCM) the audio stream.  A final partial block is
    zero-padded to the static block shape and masked to its
    causally-valid length, so a capture of ANY length demodulates to
    the exact sample (no dropped tail).

    ``fused``: run full blocks through the fused kernel (requires
    cfg.block % FUSED_BLOCK_QUANTUM == 0).  Default: auto
    (:func:`fused_chain_ok`).  The ragged tail always runs through the
    XLA block (its state is derived from the fused state), so the
    output is the same either way to f32 rounding."""
    cfg = cfg or FmReceiverConfig()
    if fused is None:
        fused = fused_chain_ok(cfg)
    block = make_block_fn(cfg)
    if fused:
        process = make_fused_block_fn(cfg)
        state = fused_init_state()

        def tail_state(state):
            return _fused_to_xla_state(cfg, state)
    else:
        process = block
        state = init_state(cfg)

        def tail_state(state):
            return state

    chunks = []
    nbytes = cfg.block * 2
    # Native double-buffered reader when available: a C++ thread
    # prefetches the next block while the device crunches the current
    # one.  Only the reader CONSTRUCTION is allowed to fall back —
    # once streaming starts, any error must propagate (a mid-stream
    # retry would duplicate blocks with advanced state).
    reader = None
    try:
        from comms_tpu.native import NativeBlockReader

        reader = NativeBlockReader(iq_path, block_bytes=nbytes,
                                   dtype=np.uint8, shape=(-1, 2))
    except (RuntimeError, OSError):
        reader = None
    if reader is not None:
        with reader as rd:
            while True:
                iq = rd.next_block()
                if iq is None:
                    break
                if iq.shape[0] < cfg.block:
                    # borrowed buffer: copy before the ring reclaims it
                    _append_tail(block, tail_state(state), np.array(iq),
                                 cfg, chunks)
                    break
                audio, state = process(state, jnp.asarray(iq))
                chunks.append(np.asarray(audio))
    else:  # no C++ toolchain: plain python IO
        with open(iq_path, "rb") as f:
            while True:
                data = f.read(nbytes)
                if len(data) < nbytes:
                    iq = np.frombuffer(
                        data[: 2 * (len(data) // 2)], dtype=np.uint8
                    ).reshape(-1, 2)
                    _append_tail(block, tail_state(state), iq, cfg, chunks)
                    break
                iq = np.frombuffer(data, dtype=np.uint8).reshape(-1, 2)
                audio, state = process(state, jnp.asarray(iq))
                chunks.append(np.asarray(audio))
    audio = np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
    if out_path is not None:
        audio.astype(np.float32).tofile(out_path)
    return audio
