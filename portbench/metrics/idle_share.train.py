"""1 - (union of kernel, copy and set intervals on the card) / (the
profiled steps' wall time), in %."""

from portbench.lib.readers import idle_share


def read(run):
    return idle_share(run)
