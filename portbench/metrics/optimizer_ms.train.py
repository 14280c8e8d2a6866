"""The training step's global norm, clip and Adam: the device's busy plus
idle time credited to the span `matcha.train.optimizer` in the profiled
steps (`lib/spans.py`), in ms a step."""

from portbench.lib.readers import span_ms


def read(run):
    return span_ms(run, "matcha.train.optimizer", "steps")
