"""A CPU model of the MAS kernel's plan (`csrc/mas.cu`), held to the plain
version and to the JAX package exactly.

The model does what the kernel's warps do, in numpy: the lengths as fp32
sums of the mask's column 0 and row 0, truncated; the values staged through
a ring of 16-column chunks whose 16-byte units are swizzled per row, rows
at or past t_x left holding whatever the ring held before (here: garbage
and NaNs); the column recurrence with lane l holding rows l + 32 r, the
down neighbour by a shuffle from lane l - 1 with lane 0 taking lane 31's
row of r - 1, and one ballot word of backtrack bits (dp[x-1, y-1] >
dp[x, y-1]) per r; the walk that cuts, for 32 columns at once, the 32 rows
it can visit out of the words and adds the diagonal (x == y) itself;
zeros, then the scattered ones.  Its paths must equal
`maximum_path_plain`, JAX's `maximum_path(impl="scan")` and
`maximum_path_pallas(interpret=True)` bit for bit on ragged batches with
t_y < t_x, t_x = 1 and T_x of 1, 31, 32, 33 and 70.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matcha_tts_tpu.ops.mas import maximum_path as jmaximum_path
from matcha_tts_tpu.ops.pallas.mas import maximum_path_pallas
from matcha_tts_tpu_torch.ops import mas, mas_cuda

NEG = np.float32(-1e30)
CHUNK = 16  # columns in a ring stage
INSTANCES = (1, 2, 4, 6, 8, 12, 16, 24, 32)  # rows a lane holds (csrc/mas.cu kRowsPerLane)
LANES = np.arange(32)


def rows_per_lane(t_x):
    return next(r for r in INSTANCES if 32 * r >= t_x)


def swizzle(x, units):
    """The 16-byte unit a row's unit u lies at is u ^ swizzle(x)."""
    return (x // (8 // units)) & (units - 1)


def stage_chunk(stage, v, tx, ty, y0, elem):
    """Warp 1: columns y0 .. y0 + 15 of rows [0, t_x) into the stage (rows
    of `units` 16-byte units, units swizzled), columns past t_y zero."""
    units, vec = elem, 16 // elem
    for x in range(tx):
        for u in range(units):
            cols = y0 + u * vec + np.arange(vec)
            vals = np.where(cols < ty, v[x, np.minimum(cols, v.shape[1] - 1)], 0)
            stage[x, (u ^ swizzle(x, units)) * vec + np.arange(vec)] = vals


def read_unit(stage, r_count, g, elem):
    """Warp 0's 16-byte shared load of unit g of rows lane + 32 r: (R, 32, vec)."""
    units, vec = elem, 16 // elem
    rows = LANES[None, :] + 32 * np.arange(r_count)[:, None]
    pos = (g ^ swizzle(rows, units))[..., None] * vec + np.arange(vec)
    return stage[rows[..., None], pos]


def recurrence(v, tx, ty, r_count, elem, rng, table=None):
    """The column recurrence of one item: the bits as (t_y, R) uint32 words;
    the dp columns of rows [0, t_x) into `table` (t_x, t_y) if given."""
    span = np.uint32(ty - tx)
    x = LANES[None, :] + 32 * np.arange(r_count)[:, None]  # (R, 32)
    dp = np.full((r_count, 32), NEG, np.float32)
    bits = np.zeros((ty, r_count), np.uint32)
    # the ring's stage before any copy: garbage, NaNs among it
    stage = rng.standard_normal((32 * r_count, CHUNK)).astype(np.float32) * 1e3
    stage[rng.random(stage.shape) < 0.1] = np.nan
    y = 0
    for y0 in range(0, ty, CHUNK):
        stage_chunk(stage, v, tx, ty, y0, elem)
        for g in range(elem):
            q = read_unit(stage, r_count, g, elem)
            for c in range(16 // elem):
                if y0 + g * (16 // elem) + c >= ty:
                    break
                rot = np.roll(dp, 1, axis=1)  # lane l gets lane l - 1's row (lane 0: lane 31's)
                down = rot.copy()
                down[1:, 0] = rot[:-1, 0]     # lane 0: lane 31's row of r - 1
                down[0, 0] = 0.0 if y == 0 else NEG
                d = y - x
                with np.errstate(invalid="ignore"):
                    ballot = down > dp  # x == y: the walk's own test
                bits[y] = (ballot.astype(np.uint64) << LANES.astype(np.uint64)).sum(axis=1)
                cell = q[:, :, c] + np.maximum(dp, down)
                y_unit = y0 + g * (16 // elem)  # a unit inside [t_x - 1, span] skips the band
                if tx - 1 <= y_unit and y_unit + 16 // elem - 1 <= ty - tx:
                    dp = cell.astype(np.float32)
                else:
                    dp = np.where(d.astype(np.uint32) <= span, cell, NEG).astype(np.float32)
                if table is not None:
                    table[:, y] = dp.reshape(-1)[:tx]  # row lane + 32 r at [r, lane]
                y += 1
    return bits


def walk(bits, tx, ty):
    """The reverse walk, 32 columns a pass: the path's row per column.  A
    pass from row `index` visits rows index - 31 .. index; lane j cuts
    column top - j's bits of them out of two words (a clamped funnel shift),
    sets the diagonal row's bit and clears row 0's (the walk stays there)."""
    idx = np.zeros(ty, np.int64)
    index = tx - 1
    for top in range(ty - 1, -1, -32):
        base = index - 31
        win = np.zeros(32, np.uint64)
        for j in range(32):
            y = top - j
            if y < 0:
                continue
            wh = index >> 5
            lo = int(bits[y, wh - 1]) if wh > 0 else 0
            pair = (int(bits[y, wh]) << 32) | lo
            win[j] = (pair >> min((index & 31) + 1, 32)) & 0xFFFFFFFF
            if 0 <= y - base < 32:
                win[j] |= 1 << (y - base)
            if -32 < base <= 0:
                win[j] &= ~np.uint64(1 << -base)  # row 0 never steps down
        s = 31
        for j in range(32):
            if top - j >= 0:
                idx[top - j] = base + s
            s -= (int(win[j]) >> s) & 1
        index = base + s
    return idx


def warp_model(value, mask, seed=0, elem=4):
    """The kernel's plan over a batch in the ring layout of fp32 (elem 4)
    or bf16 (elem 2) values: (B, T_x, T_y) one-hot paths."""
    rng = np.random.default_rng(seed)
    b, t_x, t_y = value.shape
    out = np.full(value.shape, np.nan, np.float32)  # the path as torch.empty leaves it
    r_count = rows_per_lane(t_x)
    m = mask.astype(np.float32)
    for i in range(b):
        tx = min(max(int(np.float32(m[i, :, 0].sum(dtype=np.float32))), 0), t_x)
        ty = min(max(int(np.float32(m[i, 0, :].sum(dtype=np.float32))), 0), t_y)
        out[i] = 0.0  # warp 1, a slice after each chunk
        if tx == 0:
            continue
        if ty >= tx:
            idx = walk(recurrence(value[i].astype(np.float32), tx, ty, r_count, elem, rng), tx, ty)
        else:  # no cell in the band
            idx = np.full(ty, tx - 1)
        out[i, idx, np.arange(ty)] = 1.0
    return out


def _case(b, t_x, t_y, seed):
    rng = np.random.default_rng(seed)
    value = (rng.standard_normal((b, t_x, t_y)) * 3.0 - 50.0).astype(np.float32)
    tx = rng.integers(1, t_x + 1, b)
    ty = np.minimum(tx + rng.integers(0, t_y, b), t_y)
    tx[0], ty[0] = t_x, t_y                    # a full item
    tx[1], ty[1] = t_x, max(1, t_x - 1)        # t_y < t_x (t_y = t_x at T_x = 1)
    tx[2], ty[2] = 1, rng.integers(1, t_y + 1)  # t_x = 1
    tx[3], ty[3] = max(1, t_x // 2), max(1, t_x // 4)  # t_y < t_x
    mask = ((np.arange(t_x)[None, :, None] < tx[:, None, None])
            & (np.arange(t_y)[None, None, :] < ty[:, None, None])).astype(np.float32)
    return value, mask


CASES = [(5, 1, 9, 0), (5, 31, 70, 1), (6, 32, 75, 2), (5, 33, 80, 3), (5, 70, 150, 4)]


@functools.lru_cache(maxsize=None)
def _jax_paths():
    """JAX's scan and Pallas (interpret) paths of every case, from one call
    each on all cases' items zero-padded into one (B, 70, 150) batch: the
    lengths come from the mask, so the padding changes no path."""
    b_all = sum(c[0] for c in CASES)
    t_x, t_y = max(c[1] for c in CASES), max(c[2] for c in CASES)
    value = np.zeros((b_all, t_x, t_y), np.float32)
    mask = np.zeros_like(value)
    at = 0
    for b, cx, cy, seed in CASES:
        value[at:at + b, :cx, :cy], mask[at:at + b, :cx, :cy] = _case(b, cx, cy, seed)
        at += b
    scan = np.asarray(jmaximum_path(jnp.asarray(value), jnp.asarray(mask), impl="scan"))
    pallas = np.asarray(maximum_path_pallas(jnp.asarray(value), jnp.asarray(mask),
                                            interpret=True))
    out, at = {}, 0
    for b, cx, cy, seed in CASES:
        out[seed] = (scan[at:at + b, :cx, :cy], pallas[at:at + b, :cx, :cy])
        assert not scan[at:at + b, cx:].any() and not scan[at:at + b, :, cy:].any()
        at += b
    return out


@pytest.mark.parametrize("b,t_x,t_y,seed", CASES)
def test_warp_model_equals_plain_and_jax(b, t_x, t_y, seed):
    value, mask = _case(b, t_x, t_y, seed)
    got = warp_model(value, mask, seed)
    plain = mas.maximum_path_plain(torch.from_numpy(value), torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, plain)
    scan, pallas = _jax_paths()[seed]
    np.testing.assert_array_equal(got, scan)
    np.testing.assert_array_equal(got, pallas)


def test_warp_model_bf16_layout_equals_plain():
    """bf16 values in their ring layout (two units of eight columns a row)."""
    value, mask = _case(5, 70, 150, 6)
    v16 = torch.from_numpy(value).bfloat16()
    got = warp_model(v16.float().numpy(), mask, elem=2)
    np.testing.assert_array_equal(
        got, mas.maximum_path_plain(v16, torch.from_numpy(mask)).float().numpy())


def test_warp_model_walk_crosses_words():
    """A path that falls through several 32-row words within one pass of
    32 columns, and one that meets x == y (t_y = t_x): the plain path."""
    value, mask = _case(4, 100, 100, 5)
    mask[2:] = 1.0  # two more full items of t_y = t_x = 100 (a diagonal path)
    np.testing.assert_array_equal(
        warp_model(value, mask),
        mas.maximum_path_plain(torch.from_numpy(value), torch.from_numpy(mask)).numpy())


@pytest.mark.parametrize("seed", range(7, 13))
def test_warp_model_values_below_the_fill(seed):
    """Values so negative that sums pass the -1e30 fill: the band mask, the
    diagonal rule (step down where x == y) and row 0's guard decide the
    path there."""
    value, mask = _case(6, 40, 90, seed)
    value = value * np.float32(6e27)
    mask[4] = 0.0
    mask[4, :40, :40] = 1.0  # t_y = t_x: the path is the diagonal
    mask[5] = 0.0
    mask[5, :38, :41] = 1.0  # t_x = 38, t_y = t_x + 3
    np.testing.assert_array_equal(
        warp_model(value, mask),
        mas.maximum_path_plain(torch.from_numpy(value), torch.from_numpy(mask)).numpy())


@pytest.mark.parametrize("scale", [1.0, 6e27])
@pytest.mark.parametrize("elem", [2, 4])
def test_warp_model_dp_equals_plain_dp(elem, scale):
    """Every cell of rows below t_x, in the band and out of it, bit for bit
    the plain version's dp table: the band mask where it is applied and
    where a unit of columns goes without it."""
    value, mask = _case(6, 40, 90, 13)
    value = value * np.float32(scale)
    for i, (tx, ty) in enumerate([(34, 90), (38, 90), (38, 41)]):  # units from t_x - 2
        mask[3 + i] = 0.0
        mask[3 + i, :tx, :ty] = 1.0
    tx_all = mask[:, :, 0].sum(1).astype(int)
    ty_all = mask[:, 0, :].sum(1).astype(int)
    plain = mas._forward_dp(torch.from_numpy(value), torch.from_numpy(tx_all),
                            torch.from_numpy(ty_all)).numpy()
    rng = np.random.default_rng(0)
    for i, (tx, ty) in enumerate(zip(tx_all, ty_all)):
        if ty < tx:
            continue
        table = np.zeros((tx, ty), np.float32)
        recurrence(value[i], tx, ty, rows_per_lane(40), elem, rng, table)
        np.testing.assert_array_equal(table.view(np.uint32), plain[i, :tx, :ty].view(np.uint32))


@pytest.mark.parametrize("elem", [2, 4])
def test_ring_swizzle_is_a_bijection_and_conflict_free(elem):
    """Each row's units land on distinct slots, and every 8-lane phase of
    warp 0's 16-byte loads (rows lane + 32 r) and of warp 1's copies (32
    consecutive units) hits 8 distinct 16-byte bank groups."""
    units = elem
    for x in range(64):
        assert sorted(u ^ swizzle(x, units) for u in range(units)) == list(range(units))
    for r in range(4):
        for g in range(units):
            rows = LANES + 32 * r
            group = (rows * units + (g ^ swizzle(rows, units))) % 8
            for phase in range(4):
                assert len(set(group[8 * phase:8 * phase + 8])) == 8
    i = np.arange(32 * 8)
    x, u = i // units, i % units
    group = (x * units + (u ^ swizzle(x, units))) % 8
    for phase in range(len(i) // 8):
        assert len(set(group[8 * phase:8 * phase + 8])) == 8


@pytest.mark.parametrize("t_x,t_y", [(0, 8), (1025, 8), (8, 0), (8, 16385)])
def test_kernel_limits_raise(t_x, t_y):
    with pytest.raises(ValueError, match="T_x <= 1024 and 1 <= T_y <= 16384"):
        mas_cuda.check_shape(t_x, t_y)


def test_every_training_bucket_is_in_the_limits():
    from matcha_tts_tpu_torch.config import TrainConfig

    cfg = TrainConfig()
    for t_x in cfg.text_buckets:
        assert 32 * rows_per_lane(t_x) == t_x  # an instance of its own
        for t_y in cfg.frame_buckets:
            mas_cuda.check_shape(t_x, t_y)
