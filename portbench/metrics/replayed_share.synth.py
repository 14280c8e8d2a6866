"""Solver steps of the acoustic stage replayed from CUDA graphs over all its
solver steps in the window, in %: 100 x graph_replays / (graph_replays +
eager_steps) of `Synthesizer.stats`, differenced over the window.  A call
that falls back to eager steps lowers it."""


def read(run):
    c = run.get("counters", {})
    if "graph_replays" not in c or "eager_steps" not in c:
        return None
    steps = c["graph_replays"] + c["eager_steps"]
    return 100.0 * c["graph_replays"] / steps if steps else None
