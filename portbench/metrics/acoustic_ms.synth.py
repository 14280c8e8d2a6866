"""The acoustic stage (encoder, durations, the solver's U-Net passes,
replayed from graphs or eager): the device's busy plus idle time credited to
the span `matcha.synth.acoustic` in the profiled job (`lib/spans.py`), in ms
a device call."""

from portbench.lib.readers import span_ms


def read(run):
    return span_ms(run, "matcha.synth.acoustic", "calls")
