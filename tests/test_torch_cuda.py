"""The port's kernels against their plain versions on a CUDA card (marker
`gpu`; they skip where there is no card): the MRF levels (with T around
the tile, batch 3, a misaligned bf16 or fp32 weight base; fp32 bitwise
repeatable, at C = 128 also the same bits on every cluster split), MAS (identical
paths), the fused Block1D / ResnetBlock1D (forward and gradients; the
tiled bf16 kernels at T over several tiles, ragged C_in, batch 1, two
channel slices, bitwise repeatable), the
attention kernels (with ragged T, items of length 0, flash's row
statistics and a misaligned bf16 or fp32 base), the flash backward (dq, dk/dv,
with a misaligned fp32 base: fp32 max |diff| <=
1e-5 of each gradient's max |value|, bf16 relative L2 <= 1e-2 against the
fp32 plain backward on the same rounded operands, bitwise repeatable), the
MRF levels at batch 32, the streaming vocoder against the full pass, and an
exported `use_pallas=True` serving graph (the fused-block ops) replayed
against the eager call and the live one, whose solver steps are CUDA graph
replays.  Run
on a machine with one (`--noconftest`: tests/conftest.py imports JAX, which
the port does not need):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Small shapes with ragged tiles and sequence ends inside a tile; fp32 kernel
vs fp32 plain (TF32 off) max |diff| <= 1e-4 (of the output's scale for the
U-Net blocks), bf16 kernel vs fp32 plain on the same rounded operands,
relative L2 <= 1e-2, block gradients relative L2 <= 1e-4.  chip_smoke.py
runs the same checks at the paths' shapes.
"""

import ctypes

import pytest
import torch

from matcha_tts_tpu_torch.ops import mrf_cuda
from torch_op_samples import SAMPLE_NAMES, kernel_op_sample

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _operands(c_in, t_in, c, up, post, dev):
    g = torch.Generator(device=dev).manual_seed(c_in + t_in)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev)  # noqa: E731
    a = {"x": rnd(2, t_in, c_in),
         "w": torch.cat([rnd(k, c, c) * (0.5 / (k * c) ** 0.5)
                         for k in mrf_cuda.KERNEL_SIZES for _ in range(6)]),
         "b": rnd(mrf_cuda.N_CONVS, c) * 0.1}
    if up:
        a["wup"], a["bup"] = rnd(4, c, c_in) / (2 * c_in) ** 0.5, rnd(c) * 0.1
    if post:
        a["wpost"], a["bpost"] = rnd(7, c) / (7 * c) ** 0.5, rnd(1) * 0.1
    return a


def _run(fn, a, up):
    if up:
        return fn(a["x"], a["wup"], a["bup"], a["w"], a["b"], a.get("wpost"), a.get("bpost"))
    return fn(a["x"], a["w"], a["b"])


@pytest.mark.parametrize("c_in,t_in,c,up,post", [
    (128, 333, 128, False, False), (64, 200, 64, False, False),
    (32, 77, 32, False, False), (128, 150, 64, True, False),
    (64, 301, 32, True, False), (64, 99, 32, True, True)])
def test_kernel_matches_plain(cuda, c_in, t_in, c, up, post):
    a = _operands(c_in, t_in, c, up, post, cuda)
    kern, plain = ((mrf_cuda.mrf_up, mrf_cuda.mrf_up_plain) if up
                   else (mrf_cuda.mrf, mrf_cuda.mrf_plain))
    n0 = dict(mrf_cuda.LAUNCHES)
    got = _run(kern, a, up)
    torch.cuda.synchronize()
    assert sum(mrf_cuda.LAUNCHES.values()) == sum(n0.values()) + 1
    ref = _run(plain, a, up)
    assert float((got - ref).abs().max()) <= 1e-4
    a16 = {k: v.bfloat16() for k, v in a.items()}
    got16 = _run(kern, a16, up).float()
    ref16 = _run(plain, {k: v.float() for k, v in a16.items()}, up)
    assert float((got16 - ref16).norm() / ref16.norm()) <= 1e-2


# The exact levels around the tile the kernel picks at each C (64, 128 and 256
# frames at C = 128, 64, 32; mrf_up takes C in {64, 32}): T one frame above
# and below a multiple of it (two frames for mrf_up, whose T is even), T
# shorter than the smallest tile, batch 3, and the conv_post tail.
@pytest.mark.parametrize("up,c,t_out,batch,post", [
    (False, 128, 3 * 64 + 1, 1, False), (False, 128, 3 * 64 - 1, 1, False),
    (False, 128, 10, 1, False), (False, 128, 130, 3, False),
    (False, 64, 2 * 128 + 1, 1, False), (False, 64, 2 * 128 - 1, 1, False),
    (False, 64, 10, 1, False), (False, 64, 250, 3, False),
    (False, 32, 2 * 256 + 1, 1, False), (False, 32, 2 * 256 - 1, 1, False),
    (False, 32, 10, 1, False), (False, 32, 300, 3, False),
    (True, 64, 2 * 128 + 2, 1, False), (True, 64, 2 * 128 - 2, 1, False),
    (True, 64, 10, 1, False), (True, 64, 260, 3, False), (True, 64, 2 * 128 + 2, 1, True),
    (True, 32, 2 * 256 + 2, 1, False), (True, 32, 2 * 256 - 2, 1, True),
    (True, 32, 2 * 256 + 2, 1, True), (True, 32, 10, 1, True), (True, 32, 520, 3, True)])
def test_level_kernel_tile_edges(cuda, up, c, t_out, batch, post):
    c_in = 2 * c if up else c
    a = _operands(c_in, t_out // 2 if up else t_out, c, up, post, cuda)
    a["x"] = torch.randn(batch, *a["x"].shape[1:], generator=torch.Generator(device=cuda)
                         .manual_seed(t_out), device=cuda)
    kern, plain = ((mrf_cuda.mrf_up, mrf_cuda.mrf_up_plain) if up
                   else (mrf_cuda.mrf, mrf_cuda.mrf_plain))
    key = "mrf_up" if up else "mrf"
    for dtype in (torch.float32, torch.bfloat16):
        ad = {k: v.to(dtype) for k, v in a.items()}
        n0 = dict(mrf_cuda.LAUNCHES)
        got = _run(kern, ad, up).float()
        torch.cuda.synchronize()
        assert mrf_cuda.LAUNCHES[key] == n0[key] + 1
        assert sum(mrf_cuda.LAUNCHES.values()) == sum(n0.values()) + 1
        ref = _run(plain, {k: v.float() for k, v in ad.items()}, up)
        assert got.shape == ref.shape == ((batch, t_out) if post else (batch, t_out, c))
        if dtype == torch.float32:
            assert float((got - ref).abs().max()) <= 1e-4
        else:
            assert float((got - ref).norm() / ref.norm()) <= 1e-2


def test_level_kernel_refuses_misaligned_bf16_weights(cuda):
    a = {k: v.bfloat16() for k, v in _operands(64, 64, 64, False, False, cuda).items()}
    w = torch.empty(a["w"].numel() + 1, dtype=torch.bfloat16, device=cuda)[1:].view(a["w"].shape)
    w.copy_(a["w"])
    n0 = mrf_cuda.LAUNCHES["mrf"]
    with pytest.raises(RuntimeError, match="misaligned"):
        mrf_cuda.mrf(a["x"], w, a["b"])
    assert mrf_cuda.LAUNCHES["mrf"] == n0


def test_wrapper_rejects_bad_operands(cuda):
    a = _operands(32, 64, 32, False, False, cuda)
    with pytest.raises(ValueError):
        mrf_cuda.mrf(a["x"], a["w"].bfloat16(), a["b"])
    with pytest.raises(ValueError):
        mrf_cuda.mrf(a["x"], a["w"][:-1], a["b"])


# ---------------------------------------------------------------------------
# MAS: the kernel's paths equal the plain version's bit for bit
# ---------------------------------------------------------------------------


def _mas_case(b, t_x, t_y, seed, dev):
    g = torch.Generator(device="cpu").manual_seed(seed)
    value = torch.randn(b, t_x, t_y, generator=g) * 3.0
    tx = torch.randint(1, t_x + 1, (b,), generator=g)
    ty = torch.randint(1, t_y + 1, (b,), generator=g)
    tx[0], ty[0] = t_x, t_y          # a full item
    if b > 2:
        tx[1], ty[1] = t_x, max(1, t_x // 2)  # t_y < t_x
        tx[2], ty[2] = 1, 1
    mask = ((torch.arange(t_x)[None, :, None] < tx[:, None, None])
            & (torch.arange(t_y)[None, None, :] < ty[:, None, None])).float()
    return value.to(dev), mask.to(dev)


# T_x of 1, 31, 33 (a lane's rows past a word), T_y rows that are not
# 16-byte aligned (staged by plain loads), B above the SM count, the largest
# training bucket (512, 2048), and T_x = 1000 (32 rows a lane; at fp32 the
# bits in device memory)
@pytest.mark.parametrize("b,t_x,t_y", [(5, 7, 19), (6, 33, 70), (4, 64, 256), (3, 130, 300),
                                       (5, 1, 40), (6, 31, 100), (4, 33, 96), (140, 64, 256),
                                       (2, 512, 2048), (2, 1000, 1200)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mas_kernel_equals_plain(cuda, b, t_x, t_y, dtype):
    from matcha_tts_tpu_torch.ops import mas, mas_cuda

    value, mask = _mas_case(b, t_x, t_y, t_x * 1000 + t_y, cuda)
    value = value.to(dtype)
    n0 = mas_cuda.LAUNCHES["mas"]
    got = mas.maximum_path(value, mask)
    torch.cuda.synchronize()
    assert mas_cuda.LAUNCHES["mas"] == n0 + 1
    ref = mas.maximum_path_plain(value, mask)
    assert got.dtype == dtype
    assert torch.equal(got, ref)
    oracle = mas.maximum_path_numpy(value.float().cpu().numpy(), mask.cpu().numpy())
    assert (got.float().cpu().numpy() == oracle).all()


def test_mas_kernel_values_below_the_fill(cuda):
    """Values so negative that sums pass the -1e30 fill, with an item of
    t_y = t_x (the diagonal path): the kernel still equals the plain
    version (the walk's x == y rule, row 0 never left)."""
    from matcha_tts_tpu_torch.ops import mas

    value, mask = _mas_case(6, 40, 96, 11, cuda)
    value = value * 6e27
    for i, (tx, ty) in enumerate([(40, 40), (34, 96), (38, 96)]):
        mask[3 + i] = 0.0
        mask[3 + i, :tx, :ty] = 1.0
    for dtype in (torch.float32, torch.bfloat16):
        v = value.to(dtype)
        assert torch.equal(mas.maximum_path(v, mask), mas.maximum_path_plain(v, mask))


def test_mas_kernel_mask_layouts(cuda):
    """The kernel counts t_x, t_y from the mask's column 0 and row 0 at its
    strides: a bf16 mask, a bool mask and a transposed view give the same
    paths as the contiguous fp32 mask."""
    from matcha_tts_tpu_torch.ops import mas, mas_cuda

    value, mask = _mas_case(6, 40, 96, 7, cuda)
    ref = mas.maximum_path_plain(value, mask)
    for m in (mask.bfloat16(), mask.bool(), mask.transpose(1, 2).contiguous().transpose(1, 2)):
        assert torch.equal(mas_cuda.maximum_path_cuda(value, m), ref)


@pytest.mark.parametrize("t_x,t_y", [(1025, 16), (16, 16385)])
def test_mas_kernel_raises_beyond_its_limits(cuda, t_x, t_y):
    from matcha_tts_tpu_torch.ops import mas_cuda

    value = torch.zeros(1, t_x, t_y, device=cuda)
    n0 = mas_cuda.LAUNCHES["mas"]
    with pytest.raises(ValueError, match="T_x <= 1024 and 1 <= T_y <= 16384"):
        mas_cuda.maximum_path_cuda(value, torch.ones_like(value))
    assert mas_cuda.LAUNCHES["mas"] == n0


def test_mas_kernel_rejects_cpu_and_bad_shapes(cuda):
    from matcha_tts_tpu_torch.ops import mas_cuda

    value, mask = _mas_case(2, 8, 16, 0, cuda)
    with pytest.raises(ValueError):
        mas_cuda.maximum_path_cuda(value.cpu(), mask.cpu())
    with pytest.raises(ValueError):
        mas_cuda.maximum_path_cuda(value, mask[:, :, :-1])


# ---------------------------------------------------------------------------
# fused Block1D / ResnetBlock1D: kernel vs plain, forward and gradients
# ---------------------------------------------------------------------------


def _block_params(c_in, c_out, dev, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    p = {"w1": rnd(c_out, c_in, 3) / (3 * c_in) ** 0.5, "b1": rnd(c_out) * 0.1,
         "g1": 1 + 0.1 * rnd(c_out), "be1": 0.1 * rnd(c_out),
         "w2": rnd(c_out, c_out, 3) / (3 * c_out) ** 0.5, "b2": rnd(c_out) * 0.1,
         "g2": 1 + 0.1 * rnd(c_out), "be2": 0.1 * rnd(c_out),
         "wr": rnd(c_out, c_in, 1) / c_in ** 0.5, "br": rnd(c_out) * 0.1}
    return {k: v.to(dev) for k, v in p.items()}


def _x_mask(b, t, c_in, dev, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(b, t, c_in, generator=g)
    lengths = torch.linspace(t // 2, t, b).long()
    mask = (torch.arange(t)[None] < lengths[:, None]).float()
    return x.to(dev), mask.to(dev)


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))


# The tiled kernels (bf16): T over several 128-frame tiles with a ragged last
# one, C_in not a multiple of the 32-channel chunk (24, 40), batch 1, C_out
# 64 / 128 / 256 and 512 (two 256-channel slices); (2, 50, 24, 16) runs the
# per-group kernel.
BLOCK_EDGE_SHAPES = [(3, 1000, 256, 256), (2, 333, 512, 256), (2, 100, 24, 64),
                     (2, 130, 40, 128), (1, 300, 160, 256), (2, 150, 256, 512)]


@pytest.mark.parametrize("b,t,c_in,c_out", [(2, 77, 160, 256), (3, 200, 64, 64),
                                            (2, 33, 512, 256), (2, 50, 24, 16)]
                         + BLOCK_EDGE_SHAPES)
def test_block1d_kernel_matches_plain(cuda, b, t, c_in, c_out):
    from matcha_tts_tpu_torch.ops import unet_cuda as U

    p = _block_params(c_in, c_out, cuda, t)
    x, mask = _x_mask(b, t, c_in, cuda, t + 1)
    args = (p["w1"], p["b1"], p["g1"], p["be1"])
    n0 = U.LAUNCHES["block1d"]
    got = U.block1d(x, mask, *args)
    torch.cuda.synchronize()
    assert U.LAUNCHES["block1d"] == n0 + 1
    ref = U.block1d_plain(x, mask, *args)
    assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    x16 = x.bfloat16()
    got16 = U.block1d(x16, mask, *args)
    ref16 = U.block1d_plain(x16.float(), mask, *(a.bfloat16().float() for a in args))
    assert got16.dtype == torch.bfloat16 and _rel(got16.float(), ref16) <= 1e-2


@pytest.mark.parametrize("b,t,c_in,c_out", [(2, 77, 160, 256), (2, 45, 512, 256),
                                            (3, 130, 64, 64)] + BLOCK_EDGE_SHAPES)
def test_resnet1d_kernel_matches_plain(cuda, b, t, c_in, c_out):
    from matcha_tts_tpu_torch.ops import unet_cuda as U

    p = _block_params(c_in, c_out, cuda, t)
    x, mask = _x_mask(b, t, c_in, cuda, t + 1)
    temb = torch.randn(b, c_out, device=cuda)
    names = ("w1", "b1", "g1", "be1", "w2", "b2", "g2", "be2", "wr", "br")
    args = [p[k] for k in names]
    n0 = U.LAUNCHES["resnet1d"]
    got = U.resnet1d(x, mask, temb, *args)
    torch.cuda.synchronize()
    assert U.LAUNCHES["resnet1d"] == n0 + 1
    ref = U.resnet1d_plain(x, mask, temb, *args)
    assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    x16 = x.bfloat16()
    got16 = U.resnet1d(x16, mask, temb.bfloat16(), *args)
    ref16 = U.resnet1d_plain(x16.float(), mask, temb.bfloat16().float(),
                             *(a.bfloat16().float() for a in args))
    assert _rel(got16.float(), ref16) <= 1e-2


def test_tiled_resnet1d_is_bitwise_repeatable(cuda):
    """The GroupNorm partials are merged in a fixed order (no atomics)."""
    from matcha_tts_tpu_torch.ops import unet_cuda as U

    b, t, c_in, c_out = 2, 333, 512, 256
    assert U.tile_frames(c_in, c_out, torch.bfloat16) > 0
    p = _block_params(c_in, c_out, cuda, 9)
    x, mask = _x_mask(b, t, c_in, cuda, 10)
    temb = torch.randn(b, c_out, device=cuda).bfloat16()
    names = ("w1", "b1", "g1", "be1", "w2", "b2", "g2", "be2", "wr", "br")
    runs = [U.resnet1d(x.bfloat16(), mask, temb, *(p[k] for k in names)) for _ in range(2)]
    blocks = [U.block1d(x.bfloat16(), mask, p["w1"], p["b1"], p["g1"], p["be1"])
              for _ in range(2)]
    # a view at an odd offset: the wrapper copies it to an aligned base
    xv = torch.empty(b * t * c_in + 1, dtype=torch.bfloat16, device=cuda)[1:].view(b, t, c_in)
    xv.copy_(x)
    runs.append(U.resnet1d(xv, mask, temb, *(p[k] for k in names)))
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])
    assert torch.equal(blocks[0], blocks[1])


def test_fused_block_gradients_match_plain(cuda):
    from matcha_tts_tpu_torch.ops import unet_cuda as U

    b, t, c_in, c_out = 2, 61, 160, 256
    p = _block_params(c_in, c_out, cuda, 5)
    x, mask = _x_mask(b, t, c_in, cuda, 6)
    temb = torch.randn(b, c_out, device=cuda)
    gout = torch.randn(b, t, c_out, device=cuda)
    names = ("w1", "b1", "g1", "be1", "w2", "b2", "g2", "be2", "wr", "br")

    def grads(fn, blk):
        leaves = [x.clone().requires_grad_(), temb.clone().requires_grad_()] + [
            p[k].clone().requires_grad_() for k in names]
        if blk:
            out = fn(leaves[0], mask, *leaves[2:6])
            used = [leaves[0]] + leaves[2:6]
        else:
            out = fn(leaves[0], mask, leaves[1], *leaves[2:])
            used = leaves
        return torch.autograd.grad(out, used, gout)

    for blk, kern, plain in ((True, U.block1d, U.block1d_plain),
                             (False, U.resnet1d, U.resnet1d_plain)):
        for gk, gp in zip(grads(kern, blk), grads(plain, blk)):
            assert _rel(gk, gp) <= 1e-4


# ---------------------------------------------------------------------------
# int8 MRF levels: kernel vs plain version at the kernel's own window
# ---------------------------------------------------------------------------


def _int8_operands(c_in, t_in, c, up, post, dtype, dev, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    convs = [(rnd(c, c, k) * (0.5 / (k * c) ** 0.5), rnd(c) * 0.1)
             for k in mrf_cuda.KERNEL_SIZES for _ in range(6)]
    codes, b, ws = (t.to(dev) for t in mrf_cuda.pack_level_int8(convs))
    a = {"x": rnd(2, t_in, c_in).to(dev, dtype), "w": codes, "b": b, "ws": ws}
    if up:
        a["wup"] = (rnd(4, c, c_in) / (2 * c_in) ** 0.5).to(dev, dtype)
        a["bup"] = (rnd(c) * 0.1).to(dev, dtype)
    if post:
        a["wpost"] = (rnd(7, c) / (7 * c) ** 0.5).to(dev, dtype)
        a["bpost"] = (rnd(1) * 0.1).to(dev, dtype)
    return a


def _run_int8(a, up, plain):
    c = a["w"].shape[1]
    t_out = a["x"].shape[1] * (2 if up else 1)
    if up:
        args = (a["x"], a["wup"], a["bup"], a["w"], a["b"], a["ws"], a.get("wpost"), a.get("bpost"))
        if plain:
            tile, halo = mrf_cuda.int8_window(c, t_out, True, "wpost" in a)
            return mrf_cuda.mrf_up_int8_plain(*args, tile=tile, halo=halo)
        return mrf_cuda.mrf_up(*args[:5], args[6], args[7], ws=args[5])
    if plain:
        return mrf_cuda.mrf_int8_plain(a["x"], a["w"], a["b"], a["ws"],
                                       *mrf_cuda.int8_window(c, t_out))
    return mrf_cuda.mrf(a["x"], a["w"], a["b"], a["ws"])


# T (batch 2) on the JAX kernels' tiles, with the cluster plan it gives
# (`mrf_cuda.int8_plan`): window tile + 2 halo frames, CTAs x rows
@pytest.mark.parametrize("c_in,t_in,c,up,post", [
    (128, 384, 128, False, False),   # tile 128, 3 windows a row of 256 rows: 2 x 128
    (128, 768, 128, False, False),   # tile 256: 3 x 128
    (128, 6144, 128, False, False),  # tile 2048, 3 windows of 2176 rows: 8 x 272, 6 m-tiles
    (128, 8448, 128, False, False),  # tile 256, 33 windows a row: 3 x 128
    (128, 7808, 128, False, False),  # tile 128, 61 windows a row: 2 x 128
    (64, 768, 64, False, False), (32, 1536, 32, False, False),  # 2 x 224, 2 x 384
    (256, 384, 256, False, False), (256, 3072, 256, False, False),  # C = 256: 2 x 128, 8 x 144
    (128, 384, 64, True, False),     # 768 frames: tile 256 + 2 x 96, 2 x 224
    (128, 512, 64, True, False),     # 1024 frames: tile 1024 + 2 x 96, 5 x 244
    (64, 768, 32, True, False), (64, 768, 32, True, True)])  # 2 x 384, 2 x 448
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_kernel_matches_plain(cuda, c_in, t_in, c, up, post, dtype):
    """The same codes: relative L2 <= 1e-5 and max |diff| <= 1e-3 of the
    output's max |value| (room for a rare flip at a rounding boundary)."""
    a = _int8_operands(c_in, t_in, c, up, post, dtype, cuda, c_in * 7 + t_in)
    key = "mrf_up_int8" if up else "mrf_int8"
    n0 = mrf_cuda.LAUNCHES[key]
    got = _run_int8(a, up, plain=False)
    torch.cuda.synchronize()
    assert mrf_cuda.LAUNCHES[key] == n0 + 1 and got.dtype == dtype
    ref = _run_int8(a, up, plain=True)
    assert _rel(got.float(), ref.float()) <= 1e-5
    assert float((got.float() - ref.float()).abs().max()) <= 1e-3 * float(ref.float().abs().max())


@pytest.mark.parametrize("c_in,c,up,post", [
    (128, 128, False, False), (64, 64, False, False), (32, 32, False, False),
    (256, 256, False, False), (128, 64, True, False), (64, 32, True, False),
    (64, 32, True, True)])
def test_int8_kernel_takes_every_jax_window(cuda, c_in, c, up, post):
    """The kernel takes the plan `int8_plan` picks for every JAX window (tiles
    of 128 super-rows to the cap), within the card's shared memory and with
    the m-tiles the plan's rows need; a slice past the built instances'
    m-tiles is refused."""
    r = max(1, 128 // c)
    tp = 128
    while tp <= (1024 if up or c == 256 else 2048):
        t_out = tp * r
        x = torch.empty((1, t_out // 2 if up else t_out, c_in), dtype=torch.bfloat16,
                        device=cuda)
        info = mrf_cuda.int8_info(x, c, up, post)
        assert info["smem"] <= 232448 and info["max_active_clusters"] >= 1, info
        assert info["m_tiles"] * mrf_cuda.int8_mtile_rows(c) >= info["rows"], info
        assert info["m_tiles"] <= mrf_cuda.int8_max_mtiles(c, up), info
        tp *= 2
    lib = mrf_cuda._lib()
    rows = (mrf_cuda.int8_max_mtiles(c, up) * mrf_cuda.int8_mtile_rows(c)) + 16
    out = (ctypes.c_int * 5)()
    err = lib.mrf_level_int8(None, 1, rows, rows, c, int(up), int(post), 1, rows - 2 * 64, 64,
                             1, rows, None, None, None, None, None, None, None, None, None, None,
                             None, out)
    assert err != 0


def test_int8_wrapper_rejects_bad_operands(cuda):
    a = _int8_operands(64, 64, 64, False, False, torch.float32, cuda, 1)
    with pytest.raises(ValueError):
        mrf_cuda.mrf(a["x"], a["w"].float(), a["b"], a["ws"])
    with pytest.raises(ValueError):
        mrf_cuda.mrf(a["x"], a["w"], a["b"], a["ws"][:-1])


# The fp32 level on the tensor cores (three TF32 terms) at C = 32 and 64,
# whose tiles are 256 and 128 frames: T below one tile, T not a multiple of
# the tile, T over several tiles; two launches on one input are bitwise equal.
@pytest.mark.parametrize("t,c", [(77, 32), (333, 32), (2048, 32), (100, 64), (333, 64),
                                 (4096, 64)])
def test_tap_kernel_matches_plain(cuda, t, c):
    a = _operands(c, t, c, False, False, cuda)
    n0 = mrf_cuda.LAUNCHES["mrf_tap"]
    got = mrf_cuda.mrf_tap(a["x"], a["w"], a["b"])
    again = mrf_cuda.mrf_tap(a["x"], a["w"], a["b"])
    torch.cuda.synchronize()
    assert mrf_cuda.LAUNCHES["mrf_tap"] == n0 + 2
    assert mrf_cuda.pick_tile(c, False, False, torch.float32, 1 << 20) == 8192 // c
    assert float((got - mrf_cuda.mrf_plain(a["x"], a["w"], a["b"])).abs().max()) <= 1e-4
    assert torch.equal(got, again)
    with pytest.raises(ValueError):
        mrf_cuda.mrf_tap(a["x"].bfloat16(), a["w"].bfloat16(), a["b"].bfloat16())


# fp32 mrf and mrf_up at C = 32 and 64, with and without the upsample and
# the tail, and fp32 mrf at C = 128 (the cluster kernel: T = 200 on tiles of
# 128 frames over 2 CTAs; 700 and 1500 with a partial last tile of 512
# frames over 5 CTAs; 20, shorter than one slice of 68 rows): within 1e-4 of
# the plain version, bitwise repeatable; batch 2 throughout.
@pytest.mark.parametrize("c_in,t_in,c,up,post", [
    (32, 700, 32, False, False), (64, 300, 64, False, False), (128, 200, 128, False, False),
    (128, 700, 128, False, False), (128, 1500, 128, False, False), (128, 20, 128, False, False),
    (64, 300, 32, True, False), (64, 140, 32, True, True), (128, 150, 64, True, False),
    (128, 70, 64, True, True)])
def test_fp32_level_matches_plain_and_repeats(cuda, c_in, t_in, c, up, post):
    a = _operands(c_in, t_in, c, up, post, cuda)
    kern, plain = ((mrf_cuda.mrf_up, mrf_cuda.mrf_up_plain) if up
                   else (mrf_cuda.mrf, mrf_cuda.mrf_plain))
    got = _run(kern, a, up)
    again = _run(kern, a, up)
    torch.cuda.synchronize()
    assert float((got - _run(plain, a, up)).abs().max()) <= 1e-4
    assert torch.equal(got, again)


def test_fp32_tensor_core_level_refuses_misaligned_weights(cuda):
    a = _operands(64, 64, 64, False, False, cuda)
    w = torch.empty(a["w"].numel() + 1, device=cuda)[1:].view(a["w"].shape)
    w.copy_(a["w"])
    n0 = mrf_cuda.LAUNCHES["mrf_tap"]
    with pytest.raises(RuntimeError, match="misaligned"):
        mrf_cuda.mrf_tap(a["x"], w, a["b"])
    assert mrf_cuda.LAUNCHES["mrf_tap"] == n0


def test_fp32_cluster_level_refuses_misaligned_weights(cuda):
    a = _operands(128, 300, 128, False, False, cuda)
    w = torch.empty(a["w"].numel() + 1, device=cuda)[1:].view(a["w"].shape)
    w.copy_(a["w"])
    n0 = mrf_cuda.LAUNCHES["mrf"]
    with pytest.raises(RuntimeError, match="misaligned"):
        mrf_cuda.mrf(a["x"], w, a["b"])
    assert mrf_cuda.LAUNCHES["mrf"] == n0


def _fp32_level_at_tile(a, tile):
    """The fp32 C = 128 level through the C entry at a given tile."""
    lib = mrf_cuda._lib()
    x = a["x"]
    out = torch.empty_like(x)
    err = lib.mrf_level(x.data_ptr(), x.shape[0], x.shape[1], x.shape[1], 128, 0, 0, 0, tile,
                        None, None, a["w"].data_ptr(), a["b"].data_ptr(), None, None,
                        out.data_ptr(), None, torch.cuda.current_stream().cuda_stream)
    assert err == 0, lib.mrf_error_string(err).decode()
    return out


def test_fp32_cluster_level_is_one_function_of_every_split(cuda):
    """The fp32 C = 128 kernel on every tile the wrapper may pick (clusters
    of 5, 3, 2 CTAs) and on a tile of 8 frames (one CTA: the single-block
    evaluation) gives the same bits: a row's sums do not depend on the CTA
    that holds it.  The kernel's plan is the wrapper's `fp32_split`, within
    shared memory, and the card holds at least one such cluster."""
    a = _operands(128, 1100, 128, False, False, cuda)
    want = _fp32_level_at_tile(a, 8)
    for tile in mrf_cuda.TILES:
        info = mrf_cuda.fp32_cluster_info(tile)
        n, rows = mrf_cuda.fp32_split(tile)
        assert (info["n_cta"], info["rows"]) == (n, rows[2])
        assert info["smem"] <= 232448 and info["max_active_clusters"] >= 1
        assert torch.equal(_fp32_level_at_tile(a, tile), want), tile
    assert mrf_cuda.fp32_cluster_info(8)["n_cta"] == 1
    assert float((want - mrf_cuda.mrf_plain(a["x"], a["w"], a["b"])).abs().max()) <= 1e-4


# ---------------------------------------------------------------------------
# attention: kernels vs plain versions, padded rows included
# ---------------------------------------------------------------------------


def _attn_operands(b, t, heads, d, dtype, dev, seed, lengths=None):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v = (torch.randn(b, t, heads * d, generator=g).to(dev, dtype) for _ in range(3))
    if lengths is None:
        lengths = torch.linspace(max(1, t // 3), t, b).long()
    mask = (torch.arange(t)[None] < torch.as_tensor(lengths)[:, None]).float().to(dev)
    return q, k, v, mask


@pytest.mark.parametrize("impl,b,t,d", [("vmem", 2, 64, 64), ("vmem", 3, 200, 64),
                                        ("vmem", 2, 512, 128), ("flash", 2, 128, 64),
                                        ("flash", 3, 256, 128)])
def test_attention_kernel_matches_plain(cuda, impl, b, t, d):
    from matcha_tts_tpu_torch.ops import attn_cuda

    kern = getattr(attn_cuda, f"{impl}_mha")
    plain = getattr(attn_cuda, f"{impl}_mha_plain")
    heads, scale = 2, d ** -0.5
    q, k, v, mask = _attn_operands(b, t, heads, d, torch.float32, cuda, t + d)
    n0 = attn_cuda.LAUNCHES[f"{impl}_mha"]
    got = kern(q, k, v, mask, heads, scale)
    torch.cuda.synchronize()
    assert attn_cuda.LAUNCHES[f"{impl}_mha"] == n0 + 1
    ref = plain(q, k, v, mask, heads, scale)
    assert torch.isfinite(got).all()
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())  # every row
    q16, k16, v16, _ = _attn_operands(b, t, heads, d, torch.bfloat16, cuda, t + d)
    got16 = kern(q16, k16, v16, mask, heads, scale)
    ref16 = plain(q16.float(), k16.float(), v16.float(), mask, heads, scale)
    assert got16.dtype == torch.bfloat16 and _rel(got16.float(), ref16) <= 1e-2
    qq = q.clone().requires_grad_()
    if impl == "vmem":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            kern(qq, k, v, mask, heads, scale).sum().backward()
    else:  # the flash backward runs its kernels (held to the plain version below)
        n0 = attn_cuda.LAUNCHES["flash_mha_bwd"]
        kern(qq, k, v, mask, heads, scale).sum().backward()
        torch.cuda.synchronize()
        assert attn_cuda.LAUNCHES["flash_mha_bwd"] == n0 + 1 and torch.isfinite(qq.grad).all()


# The bf16 forward takes 128 query rows per block and streams 64-key tiles
# (vmem twice): T = 72 and 200 end inside a tile, with items of length 0;
# 320 and 192 give an odd number of key tiles, so the ring's phase crosses
# vmem's pass boundary mid-round; (9, 1024) and (20, 1024) launch 144 and
# 320 blocks, more than the card's 132 SMs, the others fewer.  The fp32
# forward takes 64 query rows per block and streams the same tiles through a
# 2-stage cp.async ring: with an odd tile count (T = 320, 192, 40) vmem's
# second pass starts on the other stage; T = 40 is one tile (flash leaves
# the second stage empty); at T = 24 and 16 most of the only tile lies past
# the end; (16, 512) and (16, 256) are distillation's shapes.
@pytest.mark.parametrize("impl,b,t,d,lengths", [
    ("vmem", 3, 72, 64, (0, 41, 72)), ("flash", 3, 72, 64, (0, 41, 72)),
    ("vmem", 3, 200, 64, (200, 0, 131)), ("flash", 3, 200, 64, (200, 0, 131)),
    ("vmem", 2, 320, 64, None), ("vmem", 1, 192, 128, (100,)),
    ("vmem", 2, 200, 128, (0, 77)), ("flash", 2, 384, 128, (0, 384)),
    ("vmem", 9, 1024, 64, None), ("flash", 20, 1024, 64, None),
    ("flash", 2, 320, 64, (0, 250)), ("flash", 2, 200, 128, (0, 77)),
    ("vmem", 2, 40, 64, (0, 17)), ("flash", 2, 40, 128, (40, 0)),
    ("flash", 2, 24, 64, (24, 0)), ("vmem", 2, 16, 128, (9, 16)),
    ("vmem", 16, 512, 64, None), ("flash", 16, 512, 64, None),
    ("vmem", 16, 256, 64, None), ("flash", 16, 256, 64, None)])
def test_attention_forward_edges(cuda, impl, b, t, d, lengths):
    """Both types against the plain version at every row (fp32 max |diff| <=
    1e-5 of the output's scale, bf16 relative L2 <= 1e-2 against the fp32
    plain version on the same rounded operands); flash also writes its fp32
    row statistics m, l within 1e-5 of the plain version's scale, and the
    same output with or without them."""
    from matcha_tts_tpu_torch.ops import attn_cuda

    kern = getattr(attn_cuda, f"{impl}_mha")
    plain = getattr(attn_cuda, f"{impl}_mha_plain")
    scale = d ** -0.5
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, mask = _attn_operands(b, t, 2, d, dtype, cuda, t + b, lengths)
        got = kern(q, k, v, mask, 2, scale)
        torch.cuda.synchronize()
        ref = plain(q.float(), k.float(), v.float(), mask, 2, scale)
        assert got.dtype == dtype and torch.isfinite(got).all()
        if dtype == torch.float32:
            assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
        else:
            assert _rel(got.float(), ref) <= 1e-2
        if impl == "flash":
            o, m, l = attn_cuda.flash_mha_fwd(q, k, v, mask, 2, scale)
            _, pm, pl = attn_cuda.flash_mha_plain(q.float(), k.float(), v.float(), mask, 2,
                                                  scale, return_stats=True)
            assert torch.equal(o, got)
            for a, want in ((m, pm), (l, pl)):
                assert float((a - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_attention_forward_refuses_misaligned_bf16(cuda):
    """A bf16 operand whose base is not 16-byte aligned cannot be a TMA
    source: the launch fails and the wrapper raises (no fallback)."""
    from matcha_tts_tpu_torch.ops import attn_cuda

    q, k, v, mask = _attn_operands(1, 128, 2, 64, torch.bfloat16, cuda, 0)
    buf = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)
    shifted = buf[1:].view(q.shape)
    shifted.copy_(q)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    for fn in (attn_cuda.vmem_mha, attn_cuda.flash_mha):
        n0 = dict(attn_cuda.LAUNCHES)
        with pytest.raises(RuntimeError, match="launch failed"):
            fn(shifted, k, v, mask, 2, 0.125)
        assert attn_cuda.LAUNCHES == n0


def test_attention_forward_refuses_misaligned_fp32(cuda):
    """The fp32 forward stages q, k and v with 16-byte cp.async: an fp32
    operand whose base is not 16-byte aligned fails the launch and the
    wrapper raises (no fallback), in both modes."""
    from matcha_tts_tpu_torch.ops import attn_cuda

    q, k, v, mask = _attn_operands(1, 128, 2, 64, torch.float32, cuda, 0)
    for i in range(3):
        x = (q, k, v)[i]
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
        shifted = buf[1:].view(x.shape)
        shifted.copy_(x)
        assert shifted.is_contiguous() and shifted.data_ptr() % 16
        ops = [q, k, v]
        ops[i] = shifted
        for fn in (attn_cuda.vmem_mha, attn_cuda.flash_mha):
            n0 = dict(attn_cuda.LAUNCHES)
            with pytest.raises(RuntimeError, match="launch failed"):
                fn(*ops, mask, 2, 0.125)
            assert attn_cuda.LAUNCHES == n0


def test_attention_wrapper_rejects_bad_operands(cuda):
    from matcha_tts_tpu_torch.ops import attn_cuda

    q, k, v, mask = _attn_operands(1, 64, 2, 64, torch.float32, cuda, 0)
    with pytest.raises(ValueError):
        attn_cuda.vmem_mha(q, k.transpose(1, 2).contiguous().transpose(1, 2), v, mask, 2, 0.125)
    with pytest.raises(ValueError):
        attn_cuda.flash_mha(q, k, v, mask, 4, 0.125)  # head dim 32


def _flash_bwd_case(b, t, d, dtype, dev, seed, lengths=None):
    """Operands, the forward's residuals and a non-zero output gradient at
    every row, padded rows included; `lengths` replaces the default ragged
    key mask."""
    from matcha_tts_tpu_torch.ops import attn_cuda

    q, k, v, mask = _attn_operands(b, t, 2, d, dtype, dev, seed)
    if lengths is not None:
        mask = (torch.arange(t)[None] < torch.tensor(lengths)[:, None]).float().to(dev)
    g = torch.Generator(device="cpu").manual_seed(seed + 1)
    do = torch.randn(b, t, 2 * d, generator=g).to(dev, dtype)
    o, m, l = attn_cuda.flash_mha_fwd(q, k, v, mask, 2, d ** -0.5)
    return q, k, v, mask, o, m, l, do


# The bf16 kernels take 128 rows (dq) or keys (dk/dv) per block in two
# 64-row warpgroups and stream 64-row tiles: (2, 1024) is the training
# shape; 640 gives an odd number of 128-row blocks; 200 ends inside a tile
# (the wrapper takes it by a direct call); lengths pad one item over whole
# tiles and leave one unpadded.  The fp32 kernels stream 64-row tiles
# through a 2-stage cp.async ring that zero-fills rows past t: (16, 256) is
# distillation's shape with ragged lengths; 100 ends inside the second
# tile; 40 is a single tile (the ring's second stage stays empty).
@pytest.mark.parametrize("b,t,d,lengths", [
    (1, 128, 64, None), (3, 384, 64, None), (3, 128, 128, None), (1, 384, 128, None),
    (2, 1024, 64, None), (3, 640, 64, None), (1, 200, 64, None), (2, 512, 128, None),
    (3, 384, 64, (384, 40, 300)), (2, 640, 128, (100, 640)),
    (16, 256, 64, None), (2, 100, 64, (100, 37)), (2, 40, 128, (40, 17))])
def test_flash_backward_kernels_match_plain(cuda, b, t, d, lengths):
    from matcha_tts_tpu_torch.ops import attn_cuda

    scale = d ** -0.5
    case = _flash_bwd_case(b, t, d, torch.float32, cuda, t + d, lengths)
    n0 = attn_cuda.LAUNCHES["flash_mha_bwd"]
    got = attn_cuda.flash_mha_bwd(*case, 2, scale)
    torch.cuda.synchronize()
    assert attn_cuda.LAUNCHES["flash_mha_bwd"] == n0 + 1
    want = attn_cuda.flash_mha_bwd_plain(*case, 2, scale)
    for name, gk, gp in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(gk).all(), name
        assert float((gk - gp).abs().max()) <= 1e-5 * float(gp.abs().max()), name
    again = attn_cuda.flash_mha_bwd(*case, 2, scale)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))  # bit for bit
    # bf16: its own forward's residuals; the plain backward in fp32 on them
    c16 = _flash_bwd_case(b, t, d, torch.bfloat16, cuda, t + d, lengths)
    got16 = attn_cuda.flash_mha_bwd(*c16, 2, scale)
    want16 = attn_cuda.flash_mha_bwd_plain(*(x.float() for x in c16), 2, scale)
    for name, gk, gp in zip(("dq", "dk", "dv"), got16, want16):
        assert gk.dtype == torch.bfloat16 and _rel(gk.float(), gp) <= 1e-2, name
    again16 = attn_cuda.flash_mha_bwd(*c16, 2, scale)
    assert all(torch.equal(a, b_) for a, b_ in zip(got16, again16))


def test_flash_backward_refuses_misaligned_fp32(cuda):
    """The fp32 backward stages its operands with 16-byte cp.async (and dq
    reads o with 16-byte loads): an fp32 operand whose base is not 16-byte
    aligned fails the launch and the wrapper raises (no fallback)."""
    from matcha_tts_tpu_torch.ops import attn_cuda

    case = list(_flash_bwd_case(1, 128, 64, torch.float32, cuda, 5))
    for i, name in ((0, "q"), (2, "v"), (4, "o"), (7, "do")):
        x = case[i]
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
        shifted = buf[1:].view(x.shape)
        shifted.copy_(x)
        assert shifted.is_contiguous() and shifted.data_ptr() % 16
        n0 = dict(attn_cuda.LAUNCHES)
        with pytest.raises(RuntimeError, match="launch failed"):
            attn_cuda.flash_mha_bwd(*case[:i], shifted, *case[i + 1:], 2, 0.125)
        assert attn_cuda.LAUNCHES == n0, name


def test_flash_autograd_takes_strided_gradients(cuda):
    """Through autograd, against autograd of the plain version; the output
    gradient arrives as a transposed view."""
    from matcha_tts_tpu_torch.ops import attn_cuda

    q, k, v, mask = _attn_operands(2, 256, 2, 64, torch.float32, cuda, 9)
    gout = torch.randn(2, 128, 256, device=cuda).transpose(1, 2)  # (2, 256, 128), strided

    def grads(fn):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        return torch.autograd.grad(fn(*leaves, mask, 2, 0.125), leaves, gout)

    for gk, gp in zip(grads(attn_cuda.flash_mha), grads(attn_cuda.flash_mha_plain)):
        assert float((gk - gp).abs().max()) <= 1e-5 * float(gp.abs().max())


def test_flash_backward_refuses_bad_operands(cuda):
    from matcha_tts_tpu_torch.ops import attn_cuda

    q, k, v, mask, o, m, l, do = _flash_bwd_case(1, 128, 64, torch.float32, cuda, 3)
    for cast in (torch.Tensor.half, torch.Tensor.int):  # float16, and not a float at all
        with pytest.raises(ValueError):
            attn_cuda.flash_mha_bwd(*(cast(x) for x in (q, k, v)), mask, cast(o), m, l, cast(do),
                                    2, 0.125)
    with pytest.raises(ValueError):
        attn_cuda.flash_mha_bwd(q, k, v, mask, o, m, l, do, 4, 0.125)  # head dim 32
    with pytest.raises(ValueError):
        attn_cuda.flash_mha_bwd(q, k, v, mask, o, m.double(), l, do, 2, 0.125)
    with pytest.raises(ValueError):
        attn_cuda.flash_mha_bwd(q, k, v, mask, o, m, l, do.bfloat16(), 2, 0.125)


# ---------------------------------------------------------------------------
# the serving layer's shapes: batch 32, streaming windows
# ---------------------------------------------------------------------------


# batch 32, as `synthesize_batch` gives the levels, at T one tile past a
# multiple of the tile (so every item ends inside a partial tile): the batch
# index runs through the grid's y or z dimension, and each item is its own
# sequence (the last item alone gives the same rows)
@pytest.mark.parametrize("c_in,t_in,c,up,post", [
    (128, 3 * 64 + 1, 128, False, False), (128, 128 + 1, 64, True, False),
    (64, 256 + 1, 32, True, True)])
def test_level_kernels_at_batch_32(cuda, c_in, t_in, c, up, post):
    a = _operands(c_in, t_in, c, up, post, cuda)
    a["x"] = torch.randn(32, t_in, c_in, generator=torch.Generator(device=cuda).manual_seed(32),
                         device=cuda)
    kern, plain = ((mrf_cuda.mrf_up, mrf_cuda.mrf_up_plain) if up
                   else (mrf_cuda.mrf, mrf_cuda.mrf_plain))
    for dtype in (torch.float32, torch.bfloat16):
        ad = {k: v.to(dtype) for k, v in a.items()}
        n0 = dict(mrf_cuda.LAUNCHES)
        got = _run(kern, ad, up).float()
        torch.cuda.synchronize()
        assert mrf_cuda.LAUNCHES["mrf_up" if up else "mrf"] == n0["mrf_up" if up else "mrf"] + 1
        ref = _run(plain, {k: v.float() for k, v in ad.items()}, up)
        assert got.shape[0] == 32 and got.shape == ref.shape
        if dtype == torch.float32:
            assert float((got - ref).abs().max()) <= 1e-4
        else:
            assert float((got - ref).norm() / ref.norm()) <= 1e-2
        # every item is its own sequence: the last item alone gives its row
        last = _run(kern, {k: (v[-1:] if k == "x" else v) for k, v in ad.items()}, up).float()
        assert float((last[0] - got[-1]).abs().max()) <= (1e-5 if dtype == torch.float32
                                                          else 1e-2)


def _unit_gain_generator(cuda):
    """HiFi-GAN V1 with every conv redrawn at unit gain (HiFi-GAN's own init
    is near-silent), so the comparison sees real samples."""
    from matcha_tts_tpu_torch.config import HiFiGANConfig
    from matcha_tts_tpu_torch.models.hifigan import HiFiGANGenerator

    hcfg = HiFiGANConfig()
    gen = HiFiGANGenerator(hcfg, seed=1, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(5)
    with torch.no_grad():
        for name, p in gen.named_parameters():
            if name.endswith("weight"):
                fan_in = (p.shape[0] * p.shape[2] / hcfg.upsample_rates[int(name.split(".")[1])]
                          if name.startswith("ups.") else p.shape[1] * p.shape[2])
                p.normal_(generator=g).mul_(fan_in ** -0.5)
        gen.conv_post.weight.mul_(0.1)
    return gen, hcfg


def test_streaming_vocoder_replays_the_full_pass(cuda):
    """`StreamingVocoder` at chunk 64 growing to 256, depth 2 and 0, on a
    300-frame mel: every window launches one `mrf` and two `mrf_up`, and
    the joined chunks equal the full pass (fp32 max |diff| <= 2e-4, bf16
    relative L2 <= 1e-2)."""
    import numpy as np

    from matcha_tts_tpu_torch.inference.streaming import StreamingVocoder
    from matcha_tts_tpu_torch.models.vocoder import generate

    gen, hcfg = _unit_gain_generator(cuda)
    mel = torch.randn(300, 80, generator=torch.Generator(device=cuda).manual_seed(3), device=cuda)
    for dtype, name in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16")):
        with torch.no_grad():
            full = torch.clamp(generate(gen, mel[None].to(dtype), hcfg).float(), -1, 1)[0].cpu()
        for depth in (2, 0):
            sv = StreamingVocoder(gen, hcfg, 64, compute_dtype=name, max_chunk_frames=256,
                                  pipeline_depth=depth, device=cuda)
            n0 = dict(mrf_cuda.LAUNCHES)
            chunks = list(sv.stream(mel))
            n = len(chunks)
            assert [len(c) // 256 for c in chunks] == [64, 128, 108]
            assert mrf_cuda.LAUNCHES["mrf"] - n0["mrf"] == n
            assert mrf_cuda.LAUNCHES["mrf_up"] - n0["mrf_up"] == 2 * n
            got = torch.from_numpy(np.concatenate(chunks))
            assert got.shape == full.shape and float(full.abs().max()) > 0.05
            if dtype == torch.float32:
                assert float((got - full).abs().max()) <= 2e-4
            else:
                assert float((got - full).norm() / full.norm()) <= 1e-2


@pytest.mark.parametrize("name", SAMPLE_NAMES)
def test_kernel_ops_pass_opcheck_on_the_card(cuda, name):
    """Each kernel op (`matcha_torch::*`, the launches behind the wrappers and
    behind an exported graph's nodes) passes `torch.library.opcheck` on CUDA
    tensors: its schema, its fake implementation against the kernel's
    output, no output aliasing an input or another output, tracing."""
    op, args = kernel_op_sample(name, cuda)
    torch.library.opcheck(op, args)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exported_fused_blocks_replay_the_live_call(cuda, dtype):
    """A `use_pallas=True` decoder in an exported serving graph
    (`inference/export.py`) at a small config, replayed on the card: the
    graph holds the `block1d` and `resnet1d` ops (one resnet a transformer
    level, one final block an Euler step) with `mrf` and two `mrf_up`; a
    replay launches each of those kernels as often as the eager call
    (`model.synthesize` and `_vocode_packed`), and equals it and the live
    `_synthesize_packed` on the same z bit for bit: the same kernels on the
    same inputs.  The live call replays its solver steps from CUDA graphs
    (`inference/graphs.py`), which the wrappers' launch counters do not
    see, so it is held to the eager call by its output."""
    from matcha_tts_tpu_torch import config as C
    from matcha_tts_tpu_torch.inference import export
    from matcha_tts_tpu_torch.inference.synthesizer import Synthesizer
    from matcha_tts_tpu_torch.models.matcha import MatchaTTS
    from matcha_tts_tpu_torch.ops import unet_cuda

    nfe, t_x, t_y, batch = 2, 32, 128, 2
    cfg = C.MatchaConfig(
        encoder=C.EncoderConfig(n_channels=64, filter_channels=128, n_heads=2, n_layers=1),
        duration_predictor=C.DurationPredictorConfig(filter_channels_dp=64),
        decoder=C.DecoderConfig(channels=(64, 64), attention_head_dim=32, num_heads=2,
                                n_blocks=1, num_mid_blocks=1, use_pallas=True))
    model = MatchaTTS(cfg, seed=4, device=cuda)
    voc, hcfg = _unit_gain_generator(cuda)
    syn = Synthesizer(model, cfg, voc, hcfg, compute_dtype=dtype, denoise_strength=0.00025,
                      device=cuda)
    program = export.export_program(model, cfg, voc, hcfg, batch=batch, text_bucket=t_x,
                                    frame_bucket=t_y, n_timesteps=nfe, compute_dtype=dtype,
                                    denoise_strength=0.00025)
    want_ops = {"resnet1d": nfe * 5, "block1d": nfe, "mrf": 1, "mrf_up": 2}
    assert export.kernel_ops(program) == want_ops
    g = torch.Generator().manual_seed(6)
    x = torch.randint(1, cfg.n_vocab, (batch, t_x), generator=g)
    xl = torch.tensor([t_x, 19])
    x[1, 19:] = 0
    x, xl = x.to(cuda), xl.to(cuda)
    z = export.noise(7, batch, t_y, cfg.encoder.n_feats, cuda)

    def counted(fn):
        for counts in (mrf_cuda.LAUNCHES, unet_cuda.LAUNCHES):
            for k in counts:
                counts[k] = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {k: v for k, v in {**mrf_cuda.LAUNCHES, **unet_cuda.LAUNCHES}.items() if v}

    (packed, mel, _, dur, y_lengths), replayed = counted(lambda: program.module()(
        model.state_dict(), voc.state_dict(), z, x, xl, syn._denoiser.bias_spec))
    def eager():
        out = model.synthesize(x, xl, n_timesteps=nfe, t_y_max=t_y, temperature=0.667,
                               compute_dtype=dtype, z=z)
        return syn._vocode_packed(out.mel, out.y_lengths), out

    (want_packed, want), live = counted(eager)
    assert replayed == live == want_ops
    graphed_packed, graphed = syn._synthesize_packed(x, xl, t_y, nfe, 0.667, 1.0, None, 0,
                                                     None, z=z)
    assert syn.stats["graph_replays"] == nfe and syn.stats["eager_steps"] == 0
    assert torch.equal(graphed_packed, want_packed) and torch.equal(graphed.mel, want.mel)
    assert torch.equal(y_lengths, want.y_lengths) and torch.equal(dur, want.durations)
    diffs = (int((packed.int() - want_packed.int()).abs().max()),
             float((mel.float() - want.mel.float()).abs().max()))
    assert torch.equal(packed, want_packed) and torch.equal(mel, want.mel), diffs
    assert float(want.mel.abs().max()) > 0
