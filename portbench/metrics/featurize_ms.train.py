"""The batch's upload and log-mel (`featurize_batch`): the device's busy
plus idle time credited to the span `matcha.train.featurize` in the profiled
steps (`lib/spans.py`), in ms a step."""

from portbench.lib.readers import span_ms


def read(run):
    return span_ms(run, "matcha.train.featurize", "steps")
