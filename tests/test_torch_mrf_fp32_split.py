"""A CPU model of how the fp32 MRF level kernel at C = 128 (`csrc/mrf.cu`,
`mrf_tc_cluster_kernel`) spreads a tile over a thread-block cluster, held
bit for bit to the level's chain over the whole sequence.

For a tile of `tile` frames the kernel runs each branch (k = 3, 7, 11) over
a window of tile + 2 reach rows (reach 12, 36, 60), cut into n_cta slices
of `rows` rows, the last one short (`mrf_cuda.fp32_split`).  A CTA keeps
its slice's residual and conv input, with HALO_ROWS = 25 rows of each
neighbour's conv input on either side.  Each conv computes the slice's rows
that the chain still needs (the valid window shrinks by the conv's reach at
every step) from the slice's rows and its halo rows; then each CTA writes
its conv output into its own rows and copies its first and last rows, as
many as the next conv's half-width, into its neighbours' halo rows.  No
row is read that this conv's inputs did not write: the rest of a CTA's
buffers hold what earlier convs, branches or tiles left there.  The branch
outputs of the tile's rows are summed in branch order through the output,
then divided by 3.

The model below does the same slice by slice: buffers that start with
random values, per-branch slices, the halo copies of exactly the rows the
kernel copies.  Its arithmetic is an exact stand-in: every value is an
integer modulo the prime P = 65537, a conv is sum(w a) + b mod P, the
LeakyReLU is a^3 mod P (0 stays 0, so the sequence's zero padding is the
same), the mean a product with 3's inverse mod P.  No order of a row's sums
changes a bit there, so the split matches the chain over the whole sequence
exactly if and only if every slice reads the right rows; one wrong or stale
row changes the result (it is P-ary noise).  The kernel's own sums of a row
run over the same weight slabs in the same order whatever CTA holds the
row; on the card, `tests/test_torch_cuda.py` holds it to the plain version
and every cluster size to the others, bit for bit.  Channels are cut to 8:
the split does not depend on them.
"""

import pytest
import torch

from matcha_tts_tpu_torch.ops import mrf_cuda

P = 65537
INV3 = pow(3, -1, P)
C = 8
HALO = mrf_cuda.HALO_ROWS
REACH = (12, 36, 60)  # per branch: 12 (k - 1) / 2


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _act(v):
    """The LeakyReLU's stand-in: v^3 mod P (0 -> 0)."""
    return v * v % P * v % P


def _conv_rows(a, w, b, k, d, lo, hi, off):
    """Rows [lo, hi) of a conv whose input row r sits at a[off + r] (rows
    lo - half .. hi + half - 1 are read): sum over taps of a[row + tap d -
    half] w[tap]^T + b, mod P."""
    half = (k - 1) // 2 * d
    acc = b.expand(max(hi - lo, 0), C).clone()
    for tap in range(k):
        s = off + lo + tap * d - half
        acc = (acc + a[s:s + hi - lo] @ w[tap].t()) % P
    return acc


def _chain(x, w, b):
    """The level over one whole sequence x (T, C): zero padding at its ends."""
    t = x.shape[0]
    acc = torch.zeros_like(x)
    tap = conv = 0
    for k in mrf_cuda.KERNEL_SIZES:
        xb = x
        for d in mrf_cuda.DILATIONS:
            xt = xb
            for dd in (d, 1):
                half = (k - 1) // 2 * dd
                a = torch.cat([torch.zeros(half, C, dtype=torch.int64), _act(xt),
                               torch.zeros(half, C, dtype=torch.int64)])
                xt = _conv_rows(a, w[tap:tap + k], b[conv], k, dd, 0, t, half)
                tap += k
                conv += 1
            xb = (xb + xt) % P
        acc = (acc + xb) % P
    return acc * INV3 % P


def _split(x, w, b, tile, n_cta, g, short=0):
    """The level of x (B, T, C) as the cluster kernel computes it, tile by
    tile, slice by slice (with `short`, each copy into the neighbours that
    many rows short)."""
    bsz, t_len, _ = x.shape
    out = torch.randint(0, P, x.shape, generator=g)  # the branch sum's passage
    most = max(-(-(tile + 2 * r) // n_cta) for r in REACH)
    for bi in range(bsz):
        for t0 in range(0, t_len, tile):
            # each CTA's residual and conv input ([HALO + rows + HALO]), as
            # earlier work left them
            xb = [torch.randint(0, P, (most, C), generator=g) for _ in range(n_cta)]
            act = [torch.randint(0, P, (HALO + most + HALO, C), generator=g)
                   for _ in range(n_cta)]
            tap = conv = 0
            for br, k in enumerate(mrf_cuda.KERNEL_SIZES):
                h, reach = (k - 1) // 2, REACH[br]
                wlen = tile + 2 * reach
                rows = -(-wlen // n_cta)
                own = [max(0, min(rows, wlen - j * rows)) for j in range(n_cta)]

                def push(nh):
                    nh -= short
                    for j in range(n_cta):
                        if j > 0:  # the first nh rows under the slice above
                            act[j - 1][HALO + rows:HALO + rows + nh] = act[j][HALO:HALO + nh]
                        if j + 1 < n_cta:  # the last nh rows over the slice below
                            act[j + 1][HALO - nh:HALO] = act[j][HALO + rows - nh:HALO + rows]

                for j in range(n_cta):
                    f = t0 - reach + j * rows + torch.arange(own[j])
                    ins = ((f >= 0) & (f < t_len))[:, None]
                    v = torch.where(ins, x[bi, f.clamp(0, t_len - 1)], 0)
                    xb[j][:own[j]] = v
                    act[j][HALO:HALO + own[j]] = _act(v)
                push(h)
                lo, hi = 0, wlen
                for sb, d in enumerate(mrf_cuda.DILATIONS):
                    for which, dd in enumerate((d, 1)):
                        lo, hi = lo + h * dd, hi - h * dd
                        last = which == 1 and sb == 2
                        ys = []
                        for j in range(n_cta):  # every CTA's products, then the epilogues
                            clo = max(lo - j * rows, 0)
                            chi = max(clo, min(hi - j * rows, own[j]))
                            ys.append((clo, chi, _conv_rows(act[j], w[tap:tap + k], b[conv],
                                                            k, dd, clo, chi, HALO)))
                        for j, (clo, chi, y) in enumerate(ys):
                            f = t0 - reach + j * rows + torch.arange(clo, chi)
                            ins = ((f >= 0) & (f < t_len))[:, None]
                            if which == 1:
                                y = (xb[j][clo:chi] + y) % P
                                if last:  # the tile's rows into the branch sum
                                    keep = (f >= t0) & (f < min(t0 + tile, t_len))
                                    fk, yk = f[keep], y[keep]
                                    s = yk if br == 0 else (out[bi, fk] + yk) % P
                                    out[bi, fk] = s * INV3 % P if br == 2 else s
                                    continue
                                xb[j][clo:chi] = y
                            act[j][HALO + clo:HALO + chi] = torch.where(ins, _act(y), 0)
                        tap += k
                        conv += 1
                        if not last:
                            push(h if which == 0 else h * (d + 2))
    return out


def _plans():
    """(tile, n_cta): the kernel's pick for every tile the wrapper may
    choose, and tiles of 512 and 256 frames in every cluster size whose
    slices hold a conv's halo (the kernel refuses a plan past its
    registers or shared memory: those are held on the card)."""
    plans = {(tile, mrf_cuda.fp32_split(tile)[0]) for tile in mrf_cuda.TILES}
    for tile in (512, 256):
        for n in range(1, mrf_cuda.MAX_CLUSTER + 1):
            plans.add((tile, n))
    return sorted(plans)


PLANS = _plans()


def test_plans_cover_the_edges():
    """The wrapper's plan for each tile: the fewest CTAs, at most
    MAX_CLUSTER, whose slices fit FP32_SLICE_ROWS (the kernel's registers: 2
    m-tiles of 16 rows for each of 4 warps across the rows) and its shared
    memory (`tc_layout`: residual, conv input with 2 x 25 halo rows, a 64 KB
    weight ring); no slice is empty, and a slice beside a neighbour holds
    the widest half-width of each branch (5, 15, 25 rows)."""
    for tile in mrf_cuda.TILES:
        n, rows = mrf_cuda.fp32_split(tile)
        assert 1 <= n <= mrf_cuda.MAX_CLUSTER
        assert rows[2] <= mrf_cuda.FP32_SLICE_ROWS
        assert rows[2] * 128 * 4 + (rows[2] + 2 * HALO) * 132 * 4 + 65536 <= 232448
        assert n == 1 or -(-(tile + 120) // (n - 1)) > mrf_cuda.FP32_SLICE_ROWS
        for reach, r in zip(REACH, rows):
            wlen = tile + 2 * reach
            assert n * r >= wlen > (n - 1) * r
            assert n == 1 or r >= 5 * reach // 12
    assert mrf_cuda.fp32_split(512) == (5, (108, 117, 127))
    assert {p[1] for p in PLANS} == set(range(1, mrf_cuda.MAX_CLUSTER + 1))


def _case(seed, bsz, t_len):
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(0, P, (bsz, t_len, C), generator=g)
    w = torch.randint(0, P, (mrf_cuda.N_TAPS, C, C), generator=g)
    b = torch.randint(0, P, (mrf_cuda.N_CONVS, C), generator=g)
    return x, w, b, g


@pytest.mark.parametrize("tile,n_cta", PLANS, ids=[f"{t}x{n}" for t, n in PLANS])
def test_split_equals_the_sequence_chain(tile, n_cta):
    """Two batch rows whose sequence ends inside the last cluster tile (2.5
    tiles), and a sequence shorter than one slice (and than the tile): the
    split gives the whole sequence's chain on every frame, bit for bit."""
    for t_len, bsz in ((2 * tile + tile // 2 + 3, 2), (min(20, tile - 3), 1)):
        x, w, b, g = _case(tile * 10 + n_cta + t_len, bsz, t_len)
        got = _split(x, w, b, tile, n_cta, g)
        for bi in range(bsz):
            assert torch.equal(got[bi], _chain(x[bi], w, b)), (tile, n_cta, t_len, bi)


def test_a_stale_halo_row_shows():
    """The check is sharp: a push one row short of the next conv's
    half-width leaves a stale halo row, and the result changes."""
    x, w, b, g = _case(7, 1, 600)
    want = _chain(x[0], w, b)
    assert torch.equal(_split(x, w, b, 256, 4, g)[0], want)
    assert not torch.equal(_split(x, w, b, 256, 4, g, short=1)[0], want)
