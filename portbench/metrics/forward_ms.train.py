"""The training step's forward and losses, MAS inside: the device's busy
plus idle time credited to the span `matcha.train.forward` in the profiled
steps (`lib/spans.py`), in ms a step."""

from portbench.lib.readers import span_ms


def read(run):
    return span_ms(run, "matcha.train.forward", "steps")
