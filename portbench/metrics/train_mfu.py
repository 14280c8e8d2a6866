"""Model FLOPs of the window's steps that the profiler did not record, over
their wall time x 989 TFLOP/s (bf16 dense peak of an H100 SXM), in %: 3 x
the forward FLOPs of the encoder with the duration predictor and of one
U-Net pass, at each row's true token and frame counts (`lib/counts.py`).
Padding, MAS, the losses and the optimizer are not counted.  The profiled
steps are left out: the profiler's own host work stretches them."""

from portbench.lib import counts


def read(run):
    plain = run.get("untraced")
    if not plain or plain["seconds"] <= 0 or not plain["work"]:
        return None
    m = run["config"]["matcha"]
    macs = sum(counts.encoder_macs(m, n_x) + counts.unet_macs(m, n_y)
               for n_x, n_y in plain["work"])
    return 100.0 * 3 * 2 * macs / (plain["seconds"] * counts.PEAK_BF16_FLOPS)
