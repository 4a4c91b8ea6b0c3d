"""Mean device time of a first-segment vocoder batch, ms: the engine's
`vocode.device.seg_first` device spans (the program's replay and its
staging; CUDA-event time) over the traced part of the window, those that
shared the stream with another span left out (tracing.device_shared)."""
from portbench import readers


def read(rec):
    return readers.span_mean_ms(rec, "vocode.device.seg_first")
