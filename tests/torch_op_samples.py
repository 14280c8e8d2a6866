"""Sample arguments for the port's kernel ops (`matcha_torch::*`, registered
by `ops/mrf_cuda.py`, `attn_cuda.py` and `unet_cuda.py`), at shapes each
kernel takes, for `torch.library.opcheck` on the CPU
(`tests/test_torch_export.py`) and on a card (`tests/test_torch_cuda.py`).
Imports no JAX, so that the card's tests can use it."""

import torch

from matcha_tts_tpu_torch.ops import attn_cuda, mrf_cuda, unet_cuda

SAMPLE_NAMES = ("mrf", "mrf_int8", "mrf_tap", "mrf_up", "mrf_up_post", "mrf_up_int8_post",
                "vmem", "flash", "flash_stats", "block1d", "resnet1d")


def _level(c, g):
    convs = [(torch.randn(c, c, k, generator=g) * k ** -0.5 * c ** -0.5,
              torch.randn(c, generator=g) * 0.01)
             for k in mrf_cuda.KERNEL_SIZES for _ in range(2 * len(mrf_cuda.DILATIONS))]
    return convs


def kernel_op_sample(name: str, device):
    """(op, args) of one sample, drawn from a fixed seed, on `device`."""
    g = torch.Generator().manual_seed(SAMPLE_NAMES.index(name))
    dev = torch.device(device)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev)

    if name.startswith("mrf"):
        c = 32
        convs = _level(c, g)
        if "int8" in name:
            w, b, ws = (t.to(dev) for t in mrf_cuda.pack_level_int8(convs))
        else:
            w, b = (t.to(dev) for t in mrf_cuda.pack_level(convs, torch.float32))
            ws = None
        if name in ("mrf", "mrf_int8"):
            return mrf_cuda._mrf_op.op, (randn(2, 512, c), w, b, ws)
        if name == "mrf_tap":
            return mrf_cuda._mrf_tap_op.op, (randn(1, 4096, c), w, b)
        wup, bup = (t.to(dev) for t in mrf_cuda.pack_upsample(
            torch.randn(2 * c, c, 4, generator=g) * 0.1, torch.randn(c, generator=g) * 0.01,
            torch.float32))
        wpost = bpost = None
        if name.endswith("post"):
            wpost, bpost = (t.to(dev) for t in mrf_cuda.pack_post(
                torch.randn(1, c, 7, generator=g) * 0.1, torch.randn(1, generator=g) * 0.01,
                torch.float32))
        return mrf_cuda._mrf_up_op.op, (randn(2, 256, 2 * c), wup, bup, w, b, wpost, bpost, ws)
    if name in ("vmem", "flash", "flash_stats"):
        b, t, heads = 2, 128, 2
        mask = torch.ones(b, t)
        mask[1, 77:] = 0
        q, k, v = (randn(b, t, heads * 64) for _ in range(3))
        return attn_cuda._attention_op.op, (q, k, v, mask.to(dev), heads, 0.125,
                                            name != "vmem", name == "flash_stats")
    b, t, c_in, c_out = 2, 64, 16, 32
    mask = torch.ones(b, t)
    mask[0, 50:] = 0
    x, mask = randn(b, t, c_in), mask.to(dev)
    gn = (randn(c_out, scale=0.1) + 1.0, randn(c_out, scale=0.1))
    if name == "block1d":
        return unet_cuda._block1d_op.op, (x, mask, randn(c_out, c_in, 3, scale=0.2),
                                          randn(c_out, scale=0.1), *gn)
    return unet_cuda._resnet1d_op.op, (
        x, mask, randn(b, c_out), randn(c_out, c_in, 3, scale=0.2), randn(c_out, scale=0.1),
        *gn, randn(c_out, c_out, 3, scale=0.2), randn(c_out, scale=0.1), *gn,
        randn(c_out, c_in, 1, scale=0.2), randn(c_out, scale=0.1))
