"""End-to-end flagship pipelines — the reference's ``examples/`` as
jitted programs (SURVEY.md section 1, L4)."""

from comms_tpu.models import (  # noqa: F401
    bpsk_tx,
    channelizer,
    fm_band_monitor,
    fm_receiver,
    play_audio,
    qpsk_rx_stream,
    qpsk_stream,
    qpsk_tx,
)
