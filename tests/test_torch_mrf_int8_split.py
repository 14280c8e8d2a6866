"""A CPU model of how the int8 MRF kernel (`csrc/mrf.cu`, `mrf_int8_kernel`)
spreads one window over a thread-block cluster, held bit for bit to the
plain version (`mrf_cuda.mrf_int8_plain`, `mrf_up_int8_plain`).

The kernel cuts a window of W rows into n_cta slices of `rows` rows (the
last one padded past the window).  For every conv each slice takes the max
of |lrelu(v)| over its in-sequence rows, the window's scale is the max of
the slices' maxima, each slice quantises its own rows, and its conv input is
those rows with HALO_ROWS = 25 rows of each neighbour's codes on either
side (zeros at the window's edges), enough for the widest conv (k = 11,
d = 5).  The tail takes 3 rows of each neighbour's level output.  The model
below does the same in PyTorch, slice by slice, for the plan `int8_split`
picks for every JAX kernel window, and for the smallest window (256 rows)
in every cluster size from 1 (a window of one slice) to 8; many of the
slices are not a multiple of 16 rows.  The channels are cut to 8: the split
does not depend on them.  The kernel's bf16/fp32 rounding steps are the
plain version's (`tests/test_torch_cuda.py` and `chip_smoke.py` phase 10
hold it to the same codes on the card).
"""

import pytest
import torch
import torch.nn.functional as F

from matcha_tts_tpu_torch.ops import mrf_cuda

PAD = mrf_cuda.HALO_ROWS
C = 8


@pytest.fixture(autouse=True)
def _one_thread():
    """Hundreds of small ops a plan: one thread runs them fastest, and beside
    other test processes it keeps them from fighting over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plans():
    """(W, n_cta, rows, C, up, post, tile, halo): the wrapper's plan for each
    JAX window of every level kind at tiles of 128-2048 super-rows, and the
    256-row window in 1 to 8 slices."""
    plans = set()
    for c, up, post in [(32, False, False), (64, False, False), (128, False, False),
                        (256, False, False), (64, True, False), (32, True, False),
                        (32, True, True)]:
        r = max(1, 128 // c)
        tp = 128
        while tp <= (1024 if up or c == 256 else 2048):
            tile, halo = mrf_cuda.int8_window(c, tp * r, up, post)
            w = tile + 2 * halo
            plans.add((w, *mrf_cuda.int8_split(c, w, up), c, up, post, tile, halo))
            for n_cta in range(1, mrf_cuda.MAX_CLUSTER + 1) if w == 256 else ():
                plans.add((w, n_cta, -(-w // n_cta), c, up, post, tile, halo))
            tp *= 2
    return sorted(plans)


PLANS = _plans()


def test_plans_cover_the_edges():
    """The slices cover each window with no empty slice and none beside a
    neighbour has fewer than PAD rows; the wrapper's pick for each window
    holds no more rows than the kernel's warps do (its shared memory is
    checked on the card: `tests/test_torch_cuda.py`) and is the smallest cluster whose
    slices fit 3 m-tiles a warp, 8 at most; the plans include every cluster
    size and slices off the 16-row m-tiles."""
    assert {p[1] for p in PLANS} == set(range(1, mrf_cuda.MAX_CLUSTER + 1))
    assert any(p[2] % 16 for p in PLANS)
    for w, n, rows, *_ in PLANS:
        assert n * rows >= w > (n - 1) * rows
        assert n == 1 or rows >= PAD
    for w, _, _, c, up, post, tile, halo in PLANS:
        n, rows = mrf_cuda.int8_split(c, w, up)
        assert (w, n, rows, c, up, post, tile, halo) in PLANS
        rows_3 = 3 * mrf_cuda.int8_mtile_rows(c)
        assert rows <= mrf_cuda.int8_max_mtiles(c, up) * mrf_cuda.int8_mtile_rows(c)
        assert rows <= rows_3 or n == mrf_cuda.MAX_CLUSTER
        assert n == 1 or -(-w // (n - 1)) > rows_3


def _weights(seed):
    g = torch.Generator().manual_seed(seed)
    convs = [(torch.randn(C, C, k, generator=g) * (0.5 / (k * C) ** 0.5),
              torch.randn(C, generator=g) * 0.1)
             for k in mrf_cuda.KERNEL_SIZES for _ in range(6)]
    return mrf_cuda.pack_level_int8(convs)


def _slices(t, n_cta, rows):
    """(N, W, ...) -> n_cta slices (N, rows, ...), the last padded with zeros."""
    extra = n_cta * rows - t.shape[1]
    return list(F.pad(t, (0, 0) * (t.dim() - 2) + (0, extra)).split(rows, 1))


def _with_neighbours(q, j, pad):
    """Slice j's rows with `pad` rows of each neighbour (zeros at the ends)."""
    zero = torch.zeros_like(q[j][:, :pad])
    top = q[j - 1][:, -pad:] if j > 0 else zero
    bottom = q[j + 1][:, :pad] if j + 1 < len(q) else zero
    return torch.cat([top, q[j], bottom], 1)


def _split_level(win, mask, codes, b, ws, n_cta, rows):
    """`_level_int8` as the cluster computes it: windows (N, W, C) fp32 and
    their in-sequence mask -> the branch mean (N, W, C)."""
    xs = _slices(win, n_cta, rows)
    ms = _slices(mask[:, :, None], n_cta, rows)  # pad rows: masked
    acc = None
    tap = conv = 0
    for k in mrf_cuda.KERNEL_SIZES:
        xb = xs
        for d in mrf_cuda.DILATIONS:
            v = xb
            for which, dd in enumerate((d, 1)):
                a = [F.leaky_relu(vj, mrf_cuda.SLOPE) * mj for vj, mj in zip(v, ms)]
                m = torch.stack([aj.abs().amax(dim=(1, 2)) for aj in a]).amax(0)
                inv, s_act = mrf_cuda._act_scale(m)
                q = [torch.clamp(torch.round(aj * inv[:, None, None]), -127, 127) for aj in a]
                half = (k - 1) // 2 * dd
                wk = codes[tap:tap + k].double().permute(1, 2, 0)
                out = []
                for j in range(n_cta):
                    rows_in = _with_neighbours(q, j, PAD)[:, PAD - half:PAD + rows + half]
                    s = F.conv1d(rows_in.double().transpose(1, 2), wk, dilation=dd)
                    out.append(mrf_cuda._dequant(s.transpose(1, 2), ws[conv], s_act, b[conv]))
                tap += k
                conv += 1
                v = out if which == 0 else [xj + yj for xj, yj in zip(xb, out)]
            xb = v
        acc = xb if acc is None else [aj + xj for aj, xj in zip(acc, xb)]
    return [aj / torch.full_like(aj, 3.0) for aj in acc]


def _windows(w, seed):
    """Two windows of W rows at a sequence's edges (frames outside [0, T)
    masked), and level weights."""
    g = torch.Generator().manual_seed(seed)
    win = torch.randn(2, w, C, generator=g)
    mask = torch.ones(2, w)
    mask[0, : w // 7] = 0  # the first window of a sequence
    mask[1, w - w // 5:] = 0  # the last
    return win, mask, _weights(seed)


@pytest.mark.parametrize("w", sorted({p[0] for p in PLANS}))
def test_split_chain_equals_plain(w):
    """Every plan of window W: the sliced chain equals `_level_int8` (the
    plain version's chain over whole windows) bit for bit."""
    win, mask, (codes, b, ws) = _windows(w, w)
    ref = mrf_cuda._level_int8(win, mask, codes, b, ws)
    for _, n_cta, rows, *_ in [p for p in PLANS if p[0] == w]:
        got = torch.cat(_split_level(win, mask, codes, b, ws, n_cta, rows), 1)[:, :w]
        assert torch.equal(got, ref), (w, n_cta, rows)


@pytest.mark.parametrize("w", sorted({p[0] for p in PLANS if p[5]}))
def test_split_tail_equals_plain(w):
    """The conv_post tail from slices, each with 3 rows of its neighbours'
    level output: LeakyReLU(0.01) of the mean on the rows [halo - 3, halo +
    tile + 3) inside the sequence, a float64 sum rounded once, tanh, on the
    slices' rows inside the centre tile; bit for bit the plain version's."""
    win, mask, (codes, b, ws) = _windows(w, w + 1)
    g = torch.Generator().manual_seed(w + 2)
    wpost, bpost = torch.randn(7, C, generator=g) / (7 * C) ** 0.5, torch.randn(1, generator=g)
    lvl = mrf_cuda._level_int8(win, mask, codes, b, ws)
    for _, n_cta, rows, _, _, _, tile, halo in [p for p in PLANS if p[0] == w and p[5]]:
        p = (mrf_cuda.POST_K - 1) // 2
        keep = slice(halo - p, halo + tile + p)
        a = F.leaky_relu(lvl[:, keep] * mask[:, keep, None], mrf_cuda.POST_SLOPE)
        y = F.conv1d(a.double().transpose(1, 2), wpost.double().t().unsqueeze(0), bpost.double())
        ref = torch.tanh(y[:, 0].float())  # the plain version's tail
        parts = _split_level(win, mask, codes, b, ws, n_cta, rows)
        wrow = torch.arange(n_cta * rows).reshape(n_cta, rows)
        stage = []
        for j, part in enumerate(parts):
            ok = ((wrow[j] >= halo - p) & (wrow[j] < halo + tile + p)).float()
            inside = F.pad(mask, (0, n_cta * rows - w))[:, wrow[j]]
            stage.append(F.leaky_relu(part * (ok * inside)[:, :, None], mrf_cuda.POST_SLOPE))
        got = torch.zeros_like(ref)
        for j in range(n_cta):
            rows_in = _with_neighbours(stage, j, p)
            y = F.conv1d(rows_in.double().transpose(1, 2), wpost.double().t().unsqueeze(0),
                         bpost.double())
            wav = torch.tanh(y[:, 0].float())  # slice rows 0 .. rows - 1
            centre = (wrow[j] >= halo) & (wrow[j] < halo + tile)
            got[:, wrow[j][centre] - halo] = wav[:, centre]
        assert torch.equal(got, ref), (w, n_cta, rows)


@pytest.mark.parametrize("plan", [p for p in PLANS if p[4]], ids=str)
def test_upsample_staging_rows(plan):
    """The float64 upsample of a slice (`upsample_f64`): the input rows it
    stages, [in0, in0 + n_in) with in0 = floor((f0 - 2) / 2) and n_in =
    floor((f0 + rows + 1) / 2) - in0 + 1, hold every row that an output
    frame f0 + r (r < rows) reads, (t + p - 2) / 2 and the next (p = t's
    parity), and fit the rows / 2 + 4 the shared memory holds, at every
    slice of every window."""
    w, n_cta, rows, _, _, _, tile, halo = plan
    for t0 in (0, tile, 2 * tile):
        for rank in range(n_cta):
            f0 = t0 - halo + rank * rows
            in0 = (f0 - 2) // 2
            n_in = (f0 + rows + 1) // 2 - in0 + 1
            assert n_in <= rows // 2 + 4
            for t in range(f0, f0 + rows):
                s0 = (t + (t & 1) - 2) // 2 - in0
                assert 0 <= s0 and s0 + 1 < n_in, (plan, f0, t)


def test_dequant_rounds_once():
    """`_dequant` rounds fp32(acc) * scale + bias once, as the kernel's fp32
    FMA and XLA's do: acc = 2^23 + 1, scale = (1 - 2^-23) 2^-47, bias = 1 +
    2^-23 make the exact value 1 + 2^-23 + 2^-24 - 2^-70, just below the
    midpoint of two fp32 neighbours.  Once: 1 + 2^-23.  Through float64 to
    nearest, it lands on the midpoint and then on the even neighbour, 1 +
    2^-22."""
    acc = torch.tensor([[[2.0 ** 23 + 1]]], dtype=torch.float64)
    ws = torch.tensor([(1 - 2.0 ** -23) * 2.0 ** -47])
    bias = torch.tensor([1 + 2.0 ** -23])
    got = mrf_cuda._dequant(acc, ws, torch.ones(1), bias)
    assert got.item() == 1 + 2.0 ** -23
    twice = (acc.float().double() * ws.double() + bias.double()).float()
    assert twice.item() == 1 + 2.0 ** -22
