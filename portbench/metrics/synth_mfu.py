"""Model FLOPs of the utterances of the window's jobs that the profiler did
not record, at their own token and frame counts (encoder and duration
predictor, n_timesteps U-Net passes, the vocoder; `lib/counts.py`), over
those jobs' wall time x 989 TFLOP/s (bf16 dense peak of an H100 SXM), in %.
The profiled job is left out: the profiler's own host work stretches it."""

from portbench.lib import counts


def read(run):
    plain = run.get("untraced")
    if not plain or plain["seconds"] <= 0 or not plain["work"]:
        return None
    cfg = run["config"]
    steps = cfg["serving"]["n_timesteps"]
    flops = sum(counts.synthesis_flops(cfg, n_x, n_y, steps) for n_x, n_y in plain["work"])
    return 100.0 * flops / (plain["seconds"] * counts.PEAK_BF16_FLOPS)
