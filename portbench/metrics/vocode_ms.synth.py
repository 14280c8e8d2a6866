"""The vocoder stage (vocoder, denoiser, `pack_pcm`): the device's busy plus
idle time credited to the span `matcha.synth.vocode` in the profiled job
(`lib/spans.py`), in ms a device call."""

from portbench.lib.readers import span_ms


def read(run):
    return span_ms(run, "matcha.synth.vocode", "calls")
