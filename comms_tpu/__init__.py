"""comms_tpu — a software-radio pipeline framework in JAX.

A from-scratch re-design of the capabilities of ostrosco/comms-rs
(a threaded Rust dataflow-node DSP framework) for accelerators:

* the thread-per-node channel-passing runtime (reference
  ``src/node/mod.rs``) becomes **pure functions over batched sample
  blocks compiled once with ``jax.jit``** — a whole flowgraph fuses
  into a single XLA program per time block;
* per-sample carried state (FIR tail, FM ``prev``, mixer phase, LFSR
  register) becomes an **explicit state pytree** threaded through
  every block step, making streams resumable/checkpointable and
  block-size invariant;
* multi-core pipeline parallelism becomes **time-block sharding over a
  ``jax.sharding.Mesh``** with overlap-save halo exchange via
  ``ppermute``; channelized workloads shard the channel axis
  (``all_to_all`` corner turns);
* the FM receive chain has a hand-written GPU kernel (Pallas through
  Triton) in :mod:`comms_tpu.kernels`; every other op is plain XLA.

Layout
------
``ops``       pure DSP math: taps, FIR, FFT, mixer/NCO, PRNS,
              modulation/demodulation, resampling, estimators,
              channelizer, random sources.
``runtime``   Block/state protocol, pipeline composer, node-graph API,
              streaming driver, checkpointing, metrics.
``parallel``  mesh helpers, time-block sharding with halo exchange,
              channel sharding, distributed FFT, multi-host init.
``kernels``   the fused FM-chain kernel for NVIDIA GPUs.
``io``        raw IQ file I/O, socket/ZMQ transport, audio sink.
``hardware``  radio source/sink protocols, file-replay radio, rtl-sdr.
``models``    end-to-end flagship pipelines (the reference's
              ``examples/``): BPSK/QPSK tx, FM receiver, 64-channel
              channelizer, multi-device wideband chain.
"""

__version__ = "0.1.0"

from comms_tpu import errors, ops  # noqa: F401

# Heavier layers (runtime, parallel, io, hardware, kernels, models,
# native) import on demand: `from comms_tpu.models import fm_receiver`.
