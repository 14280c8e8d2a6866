"""The MAS kernel against its roofline in the profiled steps, in %.  The
bound is bytes over 3.35 TB/s: each row's t_x x t_y float32 log-prior read
once and its float32 path written once, at the row's true lengths; it is
divided by the summed device time of the kernels that `csrc/mas.cu`
declares `__global__`."""

from portbench.lib import counts
from portbench.lib.readers import kernel_pattern


def read(run):
    prof = run.get("profile")
    if not prof or not prof.get("work"):
        return None
    seconds = prof["trace"].kernel_seconds(kernel_pattern("mas"))
    if seconds <= 0:
        return None
    nbytes = sum(2 * 4 * n_x * n_y for n_x, n_y in prof["work"])
    return 100.0 * counts.roofline_seconds(0, nbytes) / seconds
