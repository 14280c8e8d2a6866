"""The frame bucket's stage (`predict_frame_bucket`: the encoder pass and
the host's read of the longest length): the device's busy plus idle time
credited to the span `matcha.synth.frame_bucket` in the profiled job
(`lib/spans.py`), in ms a device call."""

from portbench.lib.readers import span_ms


def read(run):
    return span_ms(run, "matcha.synth.frame_bucket", "calls")
