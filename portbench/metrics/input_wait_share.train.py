"""Time the step loop waited in `next()` on the prefetch iterator over the
window's wall time, in %.  Host clock."""


def read(run):
    if "input_wait_s" not in run or run.get("window_s", 0) <= 0:
        return None
    return 100.0 * run["input_wait_s"] / run["window_s"]
