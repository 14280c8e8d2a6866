"""True mel frames of the batches stepped in the window (the sum of
`y_lengths`, not padding) over the window's wall time, the input pipeline
inside it.  Host clock."""


def read(run):
    if "frames" not in run or run.get("window_s", 0) <= 0:
        return None
    return run["frames"] / run["window_s"]
