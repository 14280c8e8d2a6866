"""The work a forward pass needs, counted from its shapes.

Counts are multiply-accumulates of the convolutions, linear maps and
attention products at an utterance's own token count `n_x` and frame count
`n_y` (FLOPs are twice that).  Norms, activations, the FFTs of the iSTFT
and the denoiser, and the gather that expands the encoder's output by the
durations are not counted: `torch.utils.flop_counter.FlopCounterMode` does
not count them either, and `tests/test_portbench_counts.py` holds these
functions to it on the reference at small sizes.  A transposed conv is
counted per input position (in x out x width), as FlopCounterMode does.

Peaks of one H100 SXM (NVIDIA's data sheet, dense): 989 TFLOP/s bf16 (the
cells compute in bf16), 3.35 TB/s HBM.
"""

from __future__ import annotations

import math
from typing import Tuple

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def encoder_macs(cfg: dict, n_x: int) -> int:
    """Text encoder, prenet and duration predictor at n_x tokens."""
    enc, dp = cfg["encoder"], cfg["duration_predictor"]
    c, f, k = enc["n_channels"], enc["filter_channels"], enc["kernel_size"]
    macs = 0
    if enc["prenet"]:
        macs += 3 * n_x * c * c * 5 + n_x * c * c
    per_layer = 4 * n_x * c * c + 2 * n_x * n_x * c + 2 * n_x * c * f * k
    macs += enc["n_layers"] * per_layer
    macs += n_x * c * enc["n_feats"]
    fd, kd = dp["filter_channels_dp"], dp["kernel_size"]
    macs += n_x * c * fd * kd + n_x * fd * fd * kd + n_x * fd
    return macs


def _resnet(t: int, cin: int, cout: int, time_dim: int) -> int:
    return t * cin * cout * 3 + time_dim * cout + t * cout * cout * 3 + t * cin * cout


def _transformer(t: int, dim: int, inner: int) -> int:
    return 3 * t * dim * inner + 2 * t * t * inner + t * inner * dim + 2 * t * dim * 4 * dim


def unet_macs(cfg: dict, n_y: int) -> int:
    """One pass of the U-Net vector field at n_y frames."""
    dec = cfg["decoder"]
    chans = list(dec["channels"])
    n_feats = cfg["encoder"]["n_feats"]
    cin0 = 2 * n_feats
    time_dim = chans[0] * 4
    inner = dec["num_heads"] * dec["attention_head_dim"]
    nb = dec["n_blocks"]
    macs = cin0 * time_dim + time_dim * time_dim
    ts = [n_y]
    cin = cin0
    for i, ch in enumerate(chans):
        t = ts[-1]
        macs += _resnet(t, cin, ch, time_dim) + nb * _transformer(t, ch, inner)
        last = i == len(chans) - 1
        t_next = t if last else math.ceil(t / 2)
        macs += t_next * ch * ch * 3
        ts.append(t_next)
        cin = ch
    t_mid = ts[-1]
    for _ in range(dec["num_mid_blocks"]):
        macs += _resnet(t_mid, chans[-1], chans[-1], time_dim) + nb * _transformer(
            t_mid, chans[-1], inner)
    rev = chans[::-1] + [chans[0]]
    level_ts = ts[:-1][::-1]  # the skip lengths, deepest first
    for i in range(len(chans)):
        t = level_ts[i]
        cin, cout = 2 * rev[i], rev[i + 1]
        macs += _resnet(t, cin, cout, time_dim) + nb * _transformer(t, cout, inner)
        if i < len(chans) - 1:
            macs += t * cout * cout * 4  # transposed conv, per input position
        else:
            macs += t * cout * cout * 3
    macs += n_y * chans[-1] * chans[-1] * 3 + n_y * chans[-1] * n_feats
    return macs


def _mrf_taps(cfg: dict) -> int:
    """Conv taps per sample of one MRF level: each resblock's two convs per
    dilation (126 for V1's kernels 3, 7, 11 at dilations 1, 3, 5)."""
    return 2 * sum(k * len(d) for k, d in zip(cfg["resblock_kernel_sizes"],
                                              cfg["resblock_dilation_sizes"]))


def hifigan_macs(cfg: dict, n_y: int) -> int:
    """HiFi-GAN V1 at n_y frames."""
    c0 = cfg["upsample_initial_channel"]
    macs = n_y * cfg["num_mels"] * c0 * 7
    taps = _mrf_taps(cfg)
    t = n_y
    for i, (u, k) in enumerate(zip(cfg["upsample_rates"], cfg["upsample_kernel_sizes"])):
        cin, cout = c0 // 2 ** i, c0 // 2 ** (i + 1)
        macs += t * cin * cout * k
        t *= u
        macs += taps * cout * cout * t
    return macs + t * (c0 // 2 ** len(cfg["upsample_rates"])) * 7


def vocos_macs(cfg: dict, n_y: int) -> int:
    """Vocos at n_y frames (the iSTFT's FFTs not counted)."""
    d, inter, k = cfg["dim"], cfg["intermediate_dim"], cfg["kernel_size"]
    per_block = n_y * d * k + 2 * n_y * d * inter
    return n_y * cfg["num_mels"] * d * k + cfg["num_layers"] * per_block \
        + n_y * d * (cfg["n_fft"] + 2)


def vocoder_macs(family: str, cfg: dict, n_y: int) -> int:
    return hifigan_macs(cfg, n_y) if family == "hifigan" else vocos_macs(cfg, n_y)


def synthesis_flops(cfg: dict, n_x: int, n_y: int, n_steps: int) -> int:
    """One utterance: encoder, n_steps U-Net passes and the vocoder."""
    voc = vocoder_macs(cfg["vocoder_family"], cfg["vocoder"], n_y)
    return 2 * (encoder_macs(cfg["matcha"], n_x) + n_steps * unet_macs(cfg["matcha"], n_y)
                + voc)


def mrf_kernel_work(cfg: dict, n_y: int, elem_bytes: int = 2) -> Tuple[int, int]:
    """(FLOPs, bytes) of HiFi-GAN V1's levels 1-3 as the MRF kernels run them
    in bf16: level 1's MRF after a plain upsample, levels 2 and 3 with their
    stride-2 upsample fused, and level 3 with the tail (conv_post, tanh).
    Bytes: each level's input read once and output written once."""
    c0 = cfg["upsample_initial_channel"]
    taps = _mrf_taps(cfg)
    rates, kernels = cfg["upsample_rates"], cfg["upsample_kernel_sizes"]
    t = n_y * rates[0]
    macs = nbytes = 0
    for i in range(1, len(rates)):
        cin, cout = c0 // 2 ** i, c0 // 2 ** (i + 1)
        t_in = t
        t *= rates[i]
        if i == 1:
            nbytes += t * cout * elem_bytes  # the plain upsample's output, read
        else:
            macs += t_in * cin * cout * kernels[i]
            nbytes += t_in * cin * elem_bytes
        macs += taps * cout * cout * t
        if i == len(rates) - 1:
            macs += t * cout * 7
            nbytes += t * elem_bytes  # the wav
        else:
            nbytes += t * cout * elem_bytes
    return 2 * macs, nbytes


def mrf_weight_bytes(cfg: dict, elem_bytes: int = 2) -> int:
    """The levels' weights, read at least once per device call."""
    c0 = cfg["upsample_initial_channel"]
    taps = _mrf_taps(cfg)
    out = 0
    for i in range(1, len(cfg["upsample_rates"])):
        cout = c0 // 2 ** (i + 1)
        out += taps * cout * cout * elem_bytes
        if i > 1:
            out += c0 // 2 ** i * cout * cfg["upsample_kernel_sizes"][i] * elem_bytes
    return out


def roofline_seconds(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / peak_flops, nbytes / PEAK_HBM_BYTES)
