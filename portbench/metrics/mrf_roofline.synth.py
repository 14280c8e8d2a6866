"""HiFi-GAN's MRF kernels against their roofline in the profiled job, in %.

The bound is the larger of FLOPs / 989 TFLOP/s and bytes / 3.35 TB/s, for
the work levels 1-3 need at each utterance's own frame count
(`counts.mrf_kernel_work`), plus the levels' bf16 weights read once per
device call; it is divided by the summed device time of the kernels whose
names `csrc/mrf.cu` declares `__global__`."""

from portbench.lib import counts
from portbench.lib.readers import kernel_pattern


def read(run):
    prof = run.get("profile")
    cfg = run.get("config")
    if not prof or cfg is None or cfg["vocoder_family"] != "hifigan":
        return None
    seconds = prof["trace"].kernel_seconds(kernel_pattern("mrf"))
    if seconds <= 0:
        return None
    flops = nbytes = 0
    for _, n_y in prof["work"]:
        f, b = counts.mrf_kernel_work(cfg["vocoder"], n_y)
        flops += f
        nbytes += b
    nbytes += prof["calls"] * counts.mrf_weight_bytes(cfg["vocoder"])
    return 100.0 * counts.roofline_seconds(flops, nbytes) / seconds
