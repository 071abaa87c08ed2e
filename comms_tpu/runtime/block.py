"""The Block-op protocol: the replacement for `Node`.

The reference runs each `Node` in its own OS thread, blocking on
crossbeam channels (``/root/reference/src/node/mod.rs:94-98``,
``node_derive/src/lib.rs:199-211``).  Here a node becomes a **pure
block transform**

    apply(state, x) -> (y, new_state)

over a fixed-size sample block, with all per-sample carried state
(FIR tail, mixer phase, FM ``prev``, LFSR register, PRNG key) held in
an explicit pytree.  A pipeline of ops composes into one function that
``jax.jit`` fuses into a single XLA program — the reference's
``single_thread_*`` examples prove this is the semantically identical
"no runtime" shape of the same graph (examples/single_thread_bpsk.rs).

Rate semantics: each op declares a static rational rate
(``out_per_in`` as a Fraction) so the composer can check that block
sizes stay integral at trace time — the reference's `#[aggregate]`
variable-rate nodes become fixed-ratio reblocking (SURVEY.md section 7).
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Any, Callable

import numpy as np

import jax.numpy as jnp

from comms_tpu.ops import demodulation as _demod
from comms_tpu.ops import fft as _fft
from comms_tpu.ops import fir as _fir
from comms_tpu.ops import mixer as _mixer
from comms_tpu.ops import prns as _prns
from comms_tpu.ops import pulse as _pulse
from comms_tpu.ops import random as _random
from comms_tpu.ops import resample as _resample

__all__ = [
    "BlockOp",
    "Lambda",
    "Fir",
    "FirDecimate",
    "Mixer",
    "Nco",
    "FmDemod",
    "Decimate",
    "Upsample",
    "RationalResample",
    "PulseShape",
    "Fft",
    "Ifft",
    "BpskMod",
    "QpskMod",
    "PrnSource",
    "UniformSource",
    "NormalSource",
    "RandomBitSource",
]


@dataclasses.dataclass(frozen=True)
class BlockOp:
    """Base class: stateless passthrough with unit rate.

    Subclasses override ``init_state`` / ``apply`` and ``rate``.
    ``halo``: number of carried *input* samples the op needs from the
    previous block (drives halo exchange when time-sharded).
    """

    @property
    def rate(self) -> Fraction:
        return Fraction(1, 1)

    @property
    def halo(self) -> int:
        return 0

    def out_len(self, n: int) -> int:
        """Output block length for input length ``n``.  Defaults to
        the rational rate; ops with non-rational length rules (e.g.
        per-block-reset decimation's ceil) override."""
        out = Fraction(n) * self.rate
        if out.denominator != 1:
            raise ValueError(
                f"block size {n} is not integral through {self} "
                f"(rate {self.rate})"
            )
        return int(out)

    def init_state(self, dtype=jnp.complex64) -> Any:
        return ()

    def out_dtype(self, in_dtype):
        """Stream dtype after this op (drives per-op state dtypes in
        Pipeline.init_state).  Default: unchanged."""
        return in_dtype

    def apply(self, state, x):
        return x, state

    # --------- sharding hooks (Pipeline.make_sharded_step) ---------
    # Ops with halo > 0 follow the overlap-save protocol: their state
    # IS the carried input tail, so under time-sharding each shard
    # receives its left neighbor's tail via ppermute and calls apply()
    # unchanged; the stream context is the global input tail.

    def state_to_halo(self, state):
        """Carried state -> [halo] input-tail array (identity for
        tail-state ops; override when state is not literally the
        tail)."""
        return state

    def halo_to_state(self, halo_arr):
        """[halo] tail array -> the state apply() expects."""
        return halo_arr

    def shard_apply(self, state, x_local, axis: str):
        """Per-shard apply inside shard_map.  Default handles the two
        common cases: stateless (halo 0, empty state) and
        tail-state/overlap-save ops.  Returns (y_local, new_state)
        with new_state replicated (the global stream state).
        Ops needing shard-dependent parameters (e.g. Mixer's phase
        ramp offset) override."""
        from comms_tpu.parallel import sharding as _sh

        h = self.halo
        if h == 0:
            y, new_state = self.apply(state, x_local)
            return y, new_state
        halo_in = _sh.halo_exchange(
            x_local, self.state_to_halo(state), h, axis)
        y, _ = self.apply(self.halo_to_state(halo_in), x_local)
        new_tail = _sh.collect_ctx(x_local, h, axis)
        return y, self.halo_to_state(new_tail)


@dataclasses.dataclass(frozen=True)
class Lambda(BlockOp):
    """Wrap any stateless elementwise/shape-preserving function —
    the ConvertNode pattern in the reference examples
    (examples/fm_radio.rs:63-143)."""

    fn: Callable
    out_per_in: Fraction = Fraction(1, 1)
    result_dtype: Any = None  # set when fn changes the stream dtype

    @property
    def rate(self) -> Fraction:
        return Fraction(self.out_per_in)

    def out_dtype(self, in_dtype):
        return self.result_dtype if self.result_dtype is not None \
            else in_dtype

    def apply(self, state, x):
        return self.fn(x), state


@dataclasses.dataclass(frozen=True)
class Fir(BlockOp):
    """Streaming FIR (reference FirNode/BatchFirNode,
    src/filter/fir_node.rs:43-221)."""

    taps: tuple  # hashable; stored as tuple of complex
    _B: Any = dataclasses.field(default=None, repr=False, compare=False)

    @staticmethod
    def make(taps) -> "Fir":
        taps = np.asarray(taps)
        B = _fir.banded_tap_matrix(taps)
        return Fir(tuple(np.asarray(taps).tolist()), B)

    @property
    def num_taps(self) -> int:
        return len(self.taps)

    @property
    def halo(self) -> int:
        return self.num_taps - 1

    def init_state(self, dtype=jnp.complex64):
        return _fir.init_ctx(self.num_taps, dtype=dtype)

    def __post_init__(self):
        if self._B is None:  # direct construction without make()
            object.__setattr__(
                self, "_B",
                _fir.banded_tap_matrix(np.asarray(self.taps)))

    def apply(self, state, x):
        y, new_ctx = _fir.fir_block(x, self._B, state)
        return y, new_ctx


@dataclasses.dataclass(frozen=True)
class FirDecimate(BlockOp):
    """Fused FIR + decimate (the fm_radio hot pair, fm_radio.rs:144-150)
    via the polyphase decimating core — T MACs per kept output.
    Carried context is M*dec - 1 input samples (M = ceil(T/dec))."""

    taps: tuple
    dec: int
    _C: Any = dataclasses.field(default=None, repr=False, compare=False)

    @staticmethod
    def make(taps, dec: int) -> "FirDecimate":
        taps = np.asarray(taps)
        if dec <= 1:
            return FirDecimate(tuple(taps.tolist()), int(dec),
                               _fir.banded_tap_matrix(taps))
        return FirDecimate(tuple(taps.tolist()), int(dec),
                           _fir.decimating_branch_taps(taps, dec))

    def __post_init__(self):
        if self._C is None:
            t = np.asarray(self.taps)
            object.__setattr__(
                self, "_C",
                _fir.banded_tap_matrix(t) if self.dec <= 1
                else _fir.decimating_branch_taps(t, self.dec))

    @property
    def rate(self) -> Fraction:
        return Fraction(1, max(self.dec, 1))

    @property
    def halo(self) -> int:
        if self.dec <= 1:
            return len(self.taps) - 1
        return self._C.size - 1

    def init_state(self, dtype=jnp.complex64):
        if self.dec <= 1:
            return _fir.init_ctx(len(self.taps), dtype=dtype)
        return jnp.zeros((self._C.size - 1,), dtype=dtype)

    def apply(self, state, x):
        if self.dec <= 1:
            return _fir.fir_block(x, self._C, state)
        return _fir.fir_decimate_poly(x, self._C, state)


@dataclasses.dataclass(frozen=True)
class Mixer(BlockOp):
    """Closed-form complex mixer (reference MixerNode, mixer.rs:91-148).

    The unit ramp is precomputed per block length at pipeline build
    time (host float64) and cached.
    """

    dphase: float
    phase0: float = 0.0

    def init_state(self, dtype=jnp.complex64):
        # Only dphase is normalized at construction (mixer.rs:43-51);
        # the initial phase is taken as given.  Carried as 64-bit
        # fixed-point (drift-free for unbounded streams).
        return _mixer.phase_fix_init(self.phase0)

    def out_dtype(self, in_dtype):
        return jnp.result_type(in_dtype, jnp.complex64)

    def apply(self, state, x):
        ramp, _ = _ramp_cache(self.dphase, int(x.shape[0]),
                              _mix_cdtype(x.dtype))
        adv_fix = _mixer.advance_fix(int(x.shape[0]), self.dphase)
        return _mixer.mixer_block_fix(x, state, ramp, adv_fix)

    def shard_apply(self, state, x_local, axis: str):
        # Shard s starts s * local_n samples into the block: offset
        # its fixed-point phase by s * advance (exact uint32 adds in
        # a tiny fori_loop over the shard index); the global phase
        # advances by n_shards * advance.
        from jax import lax as _lax

        ramp, _ = _ramp_cache(self.dphase, int(x_local.shape[0]),
                              _mix_cdtype(x_local.dtype))
        adv_fix = _mixer.advance_fix(int(x_local.shape[0]), self.dphase)
        idx = _lax.axis_index(axis)
        n = _lax.axis_size(axis)
        local_p = _lax.fori_loop(
            0, idx, lambda _, s: _mixer.add_fix(s, adv_fix), state)
        y, _ = _mixer.mixer_block_fix(x_local, local_p, ramp, adv_fix)
        new_p = _lax.fori_loop(
            0, n, lambda _, s: _mixer.add_fix(s, adv_fix), state)
        return y, new_p


def _mix_cdtype(in_dtype):
    """Ramp dtype matching the mixer's output promotion rule."""
    return np.dtype(jnp.result_type(in_dtype, jnp.complex64))


_RAMPS: dict = {}


def _ramp_cache(dphase: float, n: int, cdtype):
    key = (float(dphase), n, str(cdtype))
    hit = _RAMPS.get(key)
    if hit is None:
        hit = _mixer.mixer_ramp(n, dphase, dtype=cdtype)
        _RAMPS[key] = hit
    return hit


@dataclasses.dataclass(frozen=True)
class Nco(BlockOp):
    """NCO over a block of phase errors (reference NcoNode,
    nco.rs:84-134)."""

    dphase: float
    phase0: float = 0.0

    def init_state(self, dtype=jnp.complex64):
        return jnp.asarray(self.phase0, dtype=jnp.float32)

    def out_dtype(self, in_dtype):
        return jnp.result_type(in_dtype, jnp.complex64)

    def apply(self, state, perr):
        return _mixer.nco_block(perr, state, self.dphase)

    def shard_apply(self, state, perr_local, axis: str):
        # The NCO phase is the cumulative sum of dphase steps plus ALL
        # previous phase errors (nco.rs:71-78) — a cross-shard prefix
        # sum.  Each shard's starting phase = carried phase
        # + s * (local_n * dphase mod 2pi)            [host-exact f64]
        # + sum of every earlier shard's perr total   [one all_gather
        #   of n scalars; the masked sum is the prefix].
        from jax import lax as _lax

        local_n = int(perr_local.shape[0])
        adv = float(np.mod(
            np.float64(local_n)
            * np.float64(_mixer.normalize_dphase(self.dphase)),
            2.0 * np.pi))
        n = _lax.axis_size(axis)
        idx = _lax.axis_index(axis)
        t = jnp.sum(perr_local)
        all_t = _lax.all_gather(t, axis)                    # [n]
        prefix = jnp.sum(
            jnp.where(jnp.arange(n) < idx, all_t, 0.0).astype(t.dtype))
        phase_s = jnp.mod(
            state
            + jnp.mod(idx.astype(jnp.float32) * jnp.float32(adv),
                      jnp.float32(2.0 * np.pi))
            + prefix,
            jnp.float32(2.0 * np.pi))
        y, _ = _mixer.nco_block(perr_local, phase_s, self.dphase)
        new_phase = jnp.mod(
            state + jnp.float32(np.mod(n * np.float64(adv), 2.0 * np.pi))
            + jnp.sum(all_t),
            jnp.float32(2.0 * np.pi)).astype(state.dtype)
        return y, new_phase


@dataclasses.dataclass(frozen=True)
class FmDemod(BlockOp):
    """Quadrature FM demod (reference FMDemodNode,
    modulation/analog_node.rs:18-52).  Complex in, real out.
    ``fast`` selects the polynomial atan2 (5e-7 rad, ~4x the VPU
    rate); default exact."""

    fast: bool = False

    @property
    def halo(self) -> int:
        return 1

    def init_state(self, dtype=jnp.complex64):
        return _demod.fm_demod_init(dtype=dtype)

    def apply(self, state, x):
        return _demod.fm_demod_block(x, state, fast=self.fast)

    def state_to_halo(self, state):
        return state[None]

    def halo_to_state(self, halo_arr):
        return halo_arr[0]

    def out_dtype(self, in_dtype):
        return jnp.zeros((), in_dtype).real.dtype


@dataclasses.dataclass(frozen=True)
class Decimate(BlockOp):
    """Keep every rate-th sample.  ``streaming=False`` resets the
    stride each block (reference DecimateNode semantics,
    resample_node.rs:53-65); ``streaming=True`` carries the phase."""

    dec: int
    streaming: bool = False

    @property
    def rate(self) -> Fraction:
        return Fraction(1, max(self.dec, 1))

    def out_len(self, n: int) -> int:
        if self.dec in (0, 1):
            return n
        if self.streaming:
            if n % self.dec:
                raise ValueError(
                    f"streaming decimation needs n % dec == 0, got "
                    f"{n} % {self.dec}"
                )
            return n // self.dec
        # per-block reset keeps ceil(n/dec) (resample_node.rs:53-65).
        return -(-n // self.dec)

    def init_state(self, dtype=jnp.complex64):
        return _resample.decimate_stream_init() if self.streaming else ()

    def apply(self, state, x):
        if self.streaming:
            return _resample.decimate_stream(x, state, self.dec)
        return _resample.decimate_block(x, self.dec), state

    def shard_apply(self, state, x_local, axis: str):
        # Per-shard stride reset only equals the single-device
        # per-BLOCK reset when each shard's length divides by dec.
        if self.dec > 1 and x_local.shape[0] % self.dec:
            raise ValueError(
                f"Decimate(dec={self.dec}) under time-sharding needs "
                f"per-shard length % dec == 0, got {x_local.shape[0]}"
            )
        return self.apply(state, x_local)


@dataclasses.dataclass(frozen=True)
class Upsample(BlockOp):
    """Zero-stuff (reference UpsampleNode, resample_node.rs:120-131)."""

    ups: int

    @property
    def rate(self) -> Fraction:
        return Fraction(max(self.ups, 1), 1)

    def apply(self, state, x):
        return _resample.upsample_block(x, self.ups), state


@dataclasses.dataclass(frozen=True)
class RationalResample(BlockOp):
    """Polyphase P/Q rational resampler (beyond the reference's
    integer up/down; ops/resample.rational_*).  State is the carried
    input tail, so the overlap-save sharding protocol applies."""

    taps: tuple
    up: int
    down: int
    _mats: Any = dataclasses.field(default=None, repr=False, compare=False)
    _offsets: Any = dataclasses.field(default=None, repr=False,
                                      compare=False)
    _P: int = dataclasses.field(default=0, repr=False, compare=False)

    @staticmethod
    def make(taps, up: int, down: int) -> "RationalResample":
        return RationalResample(tuple(np.asarray(taps).tolist()),
                                int(up), int(down))

    def __post_init__(self):
        if self._mats is None:
            mats, offs, P = _resample.rational_taps(
                np.asarray(self.taps), self.up, self.down)
            object.__setattr__(self, "_mats", mats)
            object.__setattr__(self, "_offsets", offs)
            object.__setattr__(self, "_P", P)

    @property
    def rate(self) -> Fraction:
        return Fraction(self.up, self.down)

    @property
    def halo(self) -> int:
        return max(m.size - 1 for m in self._mats)

    def init_state(self, dtype=jnp.complex64):
        return _resample.rational_resample_init(self._mats, dtype=dtype)

    def apply(self, state, x):
        return _resample.rational_resample_block(
            x, self._mats, self._offsets, self._P, state)


@dataclasses.dataclass(frozen=True)
class PulseShape(BlockOp):
    """Polyphase pulse shaping (reference PulseNode, pulse.rs:36-93):
    symbols in, sps samples per symbol out."""

    taps: tuple
    sps: int
    _H: Any = dataclasses.field(default=None, repr=False, compare=False)

    @staticmethod
    def make(taps, sps: int) -> "PulseShape":
        taps = np.asarray(taps)
        return PulseShape(tuple(taps.tolist()), int(sps),
                          _pulse.polyphase_taps(taps, sps))

    def __post_init__(self):
        if self._H is None:
            object.__setattr__(
                self, "_H",
                _pulse.polyphase_taps(np.asarray(self.taps), self.sps))

    @property
    def rate(self) -> Fraction:
        return Fraction(self.sps, 1)

    @property
    def halo(self) -> int:
        # carried input-SYMBOL tail (overlap-save in the symbol domain)
        return max(-(-len(self.taps) // self.sps) - 1, 0)

    def init_state(self, dtype=jnp.complex64):
        return _pulse.pulse_init_ctx(len(self.taps), self.sps, dtype=dtype)

    def apply(self, state, x):
        return _pulse.pulse_shape_block(x, self._H, state)


@dataclasses.dataclass(frozen=True)
class Fft(BlockOp):
    """Per-block FFT (reference FFTBatchNode, fft/fft_node.rs:26-84)."""

    fft_size: int

    def out_dtype(self, in_dtype):
        return jnp.result_type(in_dtype, jnp.complex64)

    def apply(self, state, x):
        return _fft.fft_block(x, self.fft_size), state


@dataclasses.dataclass(frozen=True)
class Ifft(BlockOp):
    """Per-block IFFT, rustfft-unnormalized by default."""

    fft_size: int
    normalize: bool = False

    def apply(self, state, x):
        return _fft.ifft_block(x, self.fft_size, self.normalize), state


@dataclasses.dataclass(frozen=True)
class BpskMod(BlockOp):
    """Bits -> BPSK symbols.  ``example_convention`` selects the
    examples' 2b-1 map over digital.rs's 1-2b map."""

    example_convention: bool = False
    dtype: Any = jnp.complex64

    def out_dtype(self, in_dtype):
        return self.dtype

    def apply(self, state, bits):
        from comms_tpu.ops import modulation as _m
        fn = (_m.bpsk_bit_mod_example if self.example_convention
              else _m.bpsk_bit_mod)
        return fn(bits, dtype=self.dtype), state


@dataclasses.dataclass(frozen=True)
class QpskMod(BlockOp):
    """Bit pairs -> QPSK symbols (2 bits in per symbol out)."""

    example_convention: bool = False
    dtype: Any = jnp.complex64

    @property
    def rate(self) -> Fraction:
        return Fraction(1, 2)

    def out_dtype(self, in_dtype):
        return self.dtype

    def apply(self, state, bits):
        from comms_tpu.ops import modulation as _m
        if self.example_convention:
            return _m.qpsk_bits_mod_example(bits, dtype=self.dtype), state
        pairs = bits.reshape(-1, 2)
        vals = pairs[:, 0].astype(jnp.int32) + 2 * pairs[:, 1].astype(jnp.int32)
        return _m.qpsk_bit_mod(vals, dtype=self.dtype), state


# ----------------------------------------------------------------- sources

@dataclasses.dataclass(frozen=True)
class _SourceOp(BlockOp):
    """Base for free-running sources.

    Under time-sharding every shard regenerates the full block (the
    threefry draw is a pure function of the carried key) and slices
    its own chunk — bit-exact parity with the single-device sequence.
    Generation is replicated, not distributed, but sources are VPU
    noise-making, never the bottleneck; the downstream pipeline still
    scales.  ``PrnSource`` overrides with a truly distributed form
    (per-shard GF(2) advance matrices)."""

    def shard_apply(self, state, x_local, axis: str):
        from jax import lax as _lax

        y_full, new_state = self.apply(state, None)
        n = _lax.axis_size(axis)
        if n == 1:
            return y_full, new_state
        B = int(y_full.shape[0])
        if B % n:
            raise ValueError(
                f"{type(self).__name__} block {B} not divisible "
                f"across {n} shards")
        local = B // n
        idx = _lax.axis_index(axis)
        y = _lax.dynamic_slice_in_dim(y_full, idx * local, local, axis=0)
        return y, new_state


@dataclasses.dataclass(frozen=True)
class PrnSource(_SourceOp):
    """LFSR bit source (reference PrnsNode, prns.rs:93-134)."""

    spec: Any = dataclasses.field(compare=False)
    seed: int = 0x01

    @staticmethod
    def make(poly_mask: int, seed: int, width: int, block: int) -> "PrnSource":
        return PrnSource(_prns.PrnSpec.make(poly_mask, width, block), seed)

    def init_state(self, dtype=jnp.complex64):
        return self.spec.init_state(self.seed)

    def apply(self, state, _x=None):
        return _prns.prn_block(self.spec, state)

    def shard_apply(self, state, x_local, axis: str):
        # Distributed exact form: shard s generates bits
        # [s*local, (s+1)*local) from register A^(s*local) @ s0 —
        # per-shard work is 1/n of the block and the concatenated
        # output is bit-identical to the single-device sequence.
        from jax import lax as _lax

        n = _lax.axis_size(axis)
        if n == 1:
            return self.apply(state)
        spec = self.spec
        local = spec.block // n
        shift = _prns.shard_shift_matrices(spec, n)       # [n, W, W]
        idx = _lax.axis_index(axis)
        A_s = jnp.take(jnp.asarray(shift, jnp.int32), idx, axis=0)
        s32 = state.astype(jnp.int32)
        s_shard = jnp.mod(A_s @ s32, 2)
        M_local = jnp.asarray(spec.out_matrix[:local], jnp.int32)
        bits = jnp.mod(M_local @ s_shard, 2).astype(jnp.int8)
        A_blk = jnp.asarray(spec.adv_matrix, jnp.int32)
        new_state = jnp.mod(A_blk @ s32, 2).astype(jnp.int8)
        return bits, new_state


@dataclasses.dataclass(frozen=True)
class UniformSource(_SourceOp):
    """Uniform random source (reference UniformNode, rand_node.rs:25-75)."""

    block: int
    start: float = 0.0
    end: float = 1.0
    seed: int = 0
    dtype: Any = jnp.float32

    def init_state(self, dtype=jnp.complex64):
        return _random.source_init(self.seed)

    def apply(self, state, _x=None):
        x, key = _random.uniform_block(state, self.block, self.start,
                                       self.end, self.dtype)
        return x, key


@dataclasses.dataclass(frozen=True)
class NormalSource(_SourceOp):
    """Normal random source (reference NormalNode, rand_node.rs:97-139)."""

    block: int
    mu: float = 0.0
    std_dev: float = 1.0
    seed: int = 0
    dtype: Any = jnp.float32

    def init_state(self, dtype=jnp.complex64):
        return _random.source_init(self.seed)

    def apply(self, state, _x=None):
        x, key = _random.normal_block(state, self.block, self.mu,
                                      self.std_dev, self.dtype)
        return x, key


@dataclasses.dataclass(frozen=True)
class RandomBitSource(_SourceOp):
    """random_bit() source (rand_node.rs:150-152)."""

    block: int
    seed: int = 0

    def init_state(self, dtype=jnp.complex64):
        return _random.source_init(self.seed)

    def apply(self, state, _x=None):
        bits, key = _random.random_bits_block(state, self.block)
        return bits, key
