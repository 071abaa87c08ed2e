"""Block/state runtime: the replacement for the reference's
thread-per-node graph runtime (src/node/)."""

from comms_tpu.runtime.block import (  # noqa: F401
    BlockOp,
    BpskMod,
    Decimate,
    Fft,
    Fir,
    FirDecimate,
    FmDemod,
    Ifft,
    Lambda,
    Mixer,
    Nco,
    NormalSource,
    PrnSource,
    PulseShape,
    QpskMod,
    RationalResample,
    RandomBitSource,
    UniformSource,
    Upsample,
)
from comms_tpu.runtime.graph import Graph, GraphNotConnectedError  # noqa: F401
from comms_tpu.runtime.pipeline import Pipeline  # noqa: F401
from comms_tpu.runtime.stream import (  # noqa: F401
    BatchedStreamRunner, StreamRunner)
