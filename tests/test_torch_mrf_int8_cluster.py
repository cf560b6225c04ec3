"""The int8 MRF kernel's cluster design (csrc/mrf_stage_int8.cu,
mrf_int8_cluster) on the CPU: its plan at the shipped stages
(``mrf_int8.int8_plan``), the tap layout its wgmma reads
(``pack_kernel_taps``), its quantization without a division (a product by
the reciprocal, the IEEE division only near a rounding boundary), and an
emulation of its partition of each TPU window over a cluster of CTAs,
held bit for bit against ``mrf_stage_int8_plain`` in f32 and bf16.

The kernel itself is held against the plain version on the card by
chip_smoke.py and scripts/probe_mrf_int8.py.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from tts_king_torch.config import TTSConfig
from tts_king_torch.ops.kernels import mrf_int8
from tts_king_torch.ops.kernels.mrf import LRELU_SLOPE, MrfStageWeights

KS = (3, 7, 11)
DIL = (1, 3, 5)
NEAR = 1.0 / 16384   # the kernel's kNear


def _stage(C, seed, kernel_sizes=KS, dilations=DIL):
    """Weights N(0, 1/(C k)) and biases N(0, 0.05^2), quantized."""
    rng = np.random.RandomState(seed)
    ws = [[torch.from_numpy((rng.randn(C, C, k) / np.sqrt(C * k))
                            .astype(np.float32))
           for _ in range(2 * len(dilations))] for k in kernel_sizes]
    bs = [[torch.from_numpy((0.05 * rng.randn(C)).astype(np.float32))
           for _ in range(2 * len(dilations))] for _ in kernel_sizes]
    return mrf_int8.quantize_mrf_stage(
        MrfStageWeights(tuple(kernel_sizes), tuple(dilations), ws, bs))


def _x(B, T, C, seed, gain=True):
    """(B, T, C) x of unit variance, scaled by 10^U(-1, 1) per 16 steps so
    that the windows' scales differ."""
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, C).astype(np.float32)
    if gain:
        g = 10.0 ** rng.uniform(-1, 1, (B, -(-T // 16), 1))
        x = x * np.repeat(g, 16, axis=1)[:, :T].astype(np.float32)
    return torch.from_numpy(x.astype(np.float32))


# (a) the plan


def _shipped_stages():
    return chip_smoke.fused_stages(TTSConfig(), chip_smoke.INT8_T)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("C,T", _shipped_stages())
def test_plan_at_the_shipped_stages(C, T, dtype):
    """Config 2b's stages (B = 8, T_mel = 1000): the k = 11 windows of
    1,144 / 2,180 / 4,248 rows, a cluster of at most 8 CTAs covering the
    widest window in whole passes, a reach that only the next CTA holds,
    the shared bytes within a CTA's 232,448, and one cluster a window."""
    B = chip_smoke.INT8_B
    r = mrf_int8.pack_factor(C, T)
    plan = mrf_int8.int8_plan(T, C, r, KS, DIL, B, dtype)
    Cp = mrf_int8.padded_channels(C)
    assert plan.window == {128: 1144, 64: 2180, 32: 4248}[C]
    assert plan.ts == r * 1024 and plan.n_tiles == 63
    assert 1 <= plan.cluster <= mrf_int8.MAX_CLUSTER
    assert plan.cluster * plan.rows >= plan.window
    assert (plan.cluster - 1) * plan.rows < plan.window   # no idle CTA
    assert plan.rows == plan.passes * mrf_int8.PASS_ROWS[Cp]
    assert plan.rows >= plan.cdmax == 25
    assert 2 <= plan.slots <= mrf_int8.MAX_SLOTS
    assert plan.smem <= 232448
    assert plan.grid == (plan.cluster, 63, B)


def test_plan_refuses_what_does_not_fit():
    """A TPU tile of 4,096 rows at C = 128 (4,216 window rows) needs more
    rows a CTA than shared memory holds: the plan raises, so the wrapper
    never launches it. C = 8 over a full tile at r = 8 (8,352 rows, the
    int8 golden's stage 1) fits in two passes."""
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="do not fit"):
            mrf_int8.int8_plan(8192, 128, 1, KS, DIL, 1, dtype, tile=4096)
    plan = mrf_int8.int8_plan(9600, 8, 8, KS, DIL, 2, torch.float32)
    assert plan.window == 8352 and plan.passes == 2 and plan.smem <= 232448


# (b) the tap layout


@pytest.mark.parametrize("C", [8, 32, 64, 128])
def test_kernel_taps_round_trip(C):
    """pack_kernel_taps puts tap j's (c_out, c_in) at [j][c_in / 16][c_out]
    [c_in % 16]; unpack_kernel_taps inverts it, and quantize_mrf_stage packs
    both layouts."""
    q = _stage(C, seed=C, kernel_sizes=(3, 5), dilations=(1, 2))
    Cp = mrf_int8.padded_channels(C)
    packed = mrf_int8.pack_kernel_taps(q.taps, Cp)
    assert torch.equal(packed, q.kernel_taps)
    assert torch.equal(mrf_int8.unpack_kernel_taps(packed, Cp), q.taps)
    n = q.taps.numel() // (Cp * Cp)
    t = q.taps.view(n, Cp, Cp)
    p = packed.view(n, Cp // 16, Cp, 16)
    for j, co, ci in ((n - 1, C - 1, C - 2), (0, 0, C - 1), (n // 2, 1, 0)):
        assert p[j, ci // 16, co, ci % 16] == t[j, co, ci]


# (c) the quantization without a division


def _q_ieee(a, sx):
    y = (a / sx).astype(np.float32) + np.float32(0.5)
    return np.clip(np.floor(y.astype(np.float32)), -127, 127)


def _q_fast(a, sx, check=True):
    """The kernel's quant_fast (x = a * rcp(sx) rounded to an integer n by
    adding 1.5 * 2^23), then quant where `near` is set; with check=False the
    product alone."""
    f32 = np.float32
    magic = f32(1.5 * 2 ** 23)
    x = (a * (f32(1) / sx)).astype(f32)
    t = (x + magic).astype(f32)
    d = (x - (t - magic).astype(f32)).astype(f32)
    q = (t.view(np.uint32).astype(np.int64) - 0x4B400000).astype(np.float64)
    near = ~(np.abs(d) <= f32(0.5 - NEAR))
    if check:
        q = np.where(near, _q_ieee(a, sx), q)
    return np.clip(q, -127, 127)


def _adversarial(sx, amax, rng):
    """Values whose quotient by sx lies within 4 ulps of every n + 1/2 for
    |n| <= 127 and of the +-127.5 clip, random values, and +-amax."""
    half = np.arange(-127, 128) + 0.5
    base = np.concatenate([half, -half, [127.5, -127.5]]) * np.float64(sx)
    vals = [base.astype(np.float32)]
    for direction in (np.inf, -np.inf):
        v = vals[0]
        for _ in range(4):
            v = np.nextafter(v, np.float32(direction))
            vals.append(v)
    vals.append((rng.uniform(-1, 1, 4096) * amax).astype(np.float32))
    vals.append(np.array([amax, -amax, 0.0], np.float32))
    a = np.concatenate(vals)
    return a[np.abs(a) <= amax]


@pytest.mark.parametrize("seed", range(4))
def test_fast_quantization_matches_ieee_division(seed):
    """Over scales from the 1e-6 / 127 floor to 1e4 / 127: the product by
    the reciprocal with the IEEE division near a boundary gives the
    division's q on every adversarial value; the product alone does not."""
    rng = np.random.RandomState(seed)
    amaxes = [np.float32(1e-6), np.float32(3e-7)] + [
        np.float32(10.0 ** e) for e in rng.uniform(-7, 4, 48)]
    misses = 0
    for amax in amaxes:
        sx = np.float32(np.maximum(amax, np.float32(1e-6)) / np.float32(127))
        a = _adversarial(sx, amax, rng)
        want = _q_ieee(a, sx)
        np.testing.assert_array_equal(_q_fast(a, sx), want)
        misses += int((_q_fast(a, sx, check=False) != want).sum())
    assert misses > 0


# (d) the partition of a window over a cluster


def _lrelu(v):
    return F.leaky_relu(v, LRELU_SLOPE)


def _quantize(a, sx):
    """The kernel's quantization of f32 values a with scale sx (N, 1, 1)."""
    magic = 1.5 * 2 ** 23
    x = a * (torch.ones_like(sx) / sx)
    t = x + magic
    d = x - (t - magic)
    near = ~(d.abs() <= 0.5 - NEAR)
    q = torch.where(near, torch.floor(a / sx + 0.5), t - magic)
    return q.clamp(-127.0, 127.0)


def _cluster_stage(x, q, r, tile, S, P):
    """The kernel's partition on (B, T, C) x: each TPU window's rows (row i
    at time t0 - lmax + i) split over S CTAs of P rows, each holding only
    its rows of h and conv 1's output (other rows hold NaN); before each
    conv a CTA quantizes its rows of the window and the reach from its
    neighbours' buffers (rows outside the window hold an arbitrary int8),
    multiplies over all P rows, and reduces the max of |lrelu| over its rows
    of the output window; the scale is the max over the S CTAs. The branch
    mean is accumulated over each CTA's rows of the tile."""
    B, T, C = x.shape
    dtype = x.dtype
    ts = r * mrf_int8.tile_rows(T, r, tile)
    n_tiles = -(-T // ts)
    halos = [mrf_int8.conv_halos(k, q.dilations, r) for k in q.kernel_sizes]
    lmax = max(sum(h) for h in halos)
    assert S * P >= ts + 2 * lmax
    N = B * n_tiles
    times = (torch.arange(n_tiles)[:, None] * ts - lmax
             + torch.arange(S * P)[None])                  # (n_tiles, S P)
    valid = ((times >= 0) & (times < T)).repeat(B, 1)[:, None]  # (N, 1, SP)
    xw = x.transpose(1, 2)[:, :, times.clamp(0, T - 1)]     # (B, C, n, SP)
    xw = xw.permute(0, 2, 1, 3).reshape(N, C, S * P)
    xw = torch.where(valid, xw, torch.zeros((), dtype=dtype))
    taps = q.conv_taps()
    chain = [dd for d in q.dilations for dd in (d, 1)]
    rows = [torch.arange(s * P, (s + 1) * P) for s in range(S)]
    nan = torch.full((N, C, P), float("nan"), dtype=dtype)
    acc = [None] * S
    n = 0
    for b, k in enumerate(q.kernel_sizes):
        lo, hi = lmax - sum(halos[b]), lmax + ts + sum(halos[b])

        def live(s, lo=None, hi=None):
            return ((rows[s] >= lo) & (rows[s] < hi))[None, None]

        h = [torch.where(live(s, lo, hi), xw[:, :, rows[s]], nan)
             for s in range(S)]
        sx = mrf_int8._div(torch.clamp(torch.stack(
            [torch.where(live(s, lo, hi), _lrelu(h[s]).float().abs(),
                         torch.zeros(())).amax(dim=(1, 2))
             for s in range(S)]).amax(0), min=1e-6), 127.0)[:, None, None]
        f = None
        for i, (hb, d) in enumerate(zip(halos[b], chain)):
            cd = (k - 1) // 2 * d
            src = h if i % 2 == 0 else f
            outs, m = [], []
            for s in range(S):
                left = src[s - 1][:, :, P - cd:] if s > 0 else nan[:, :, :cd]
                right = src[s + 1][:, :, :cd] if s < S - 1 else nan[:, :, :cd]
                win = torch.cat([left, src[s], right], dim=2)
                wrow = torch.arange(s * P - cd, (s + 1) * P + cd)
                inw = ((wrow >= lo) & (wrow < hi))[None, None]
                a = _lrelu(torch.where(inw, win, torch.zeros((), dtype=dtype)))
                qa = torch.where(inw, _quantize(a.float(), sx),
                                 torch.full((), 55.0))
                out = F.conv1d(qa.double(), taps[b][i].double(),
                               dilation=d).float()
                y = (out * (sx * q.scales[n, :C][None, :, None])
                     + q.biases[n, :C][None, :, None]).to(dtype)
                if i % 2 == 1:
                    y = y + h[s]
                vs = valid[:, :, rows[s]]
                y = torch.where(vs, y, torch.zeros((), dtype=dtype))
                outs.append(y)
                m.append(torch.where(live(s, lo + hb, hi - hb),
                                     _lrelu(y).float().abs(), torch.zeros(()))
                         .amax(dim=(1, 2)))
            if i % 2 == 0:
                f = outs
            else:
                h = outs
            lo, hi = lo + hb, hi - hb
            sx = mrf_int8._div(torch.clamp(torch.stack(m).amax(0), min=1e-6),
                               127.0)[:, None, None]
            n += 1
        for s in range(S):
            acc[s] = h[s] if acc[s] is None else acc[s] + h[s]
    y = torch.cat(acc, dim=2)[:, :, lmax:lmax + ts]
    y = mrf_int8._div(y, len(q.kernel_sizes))
    y = y.view(B, n_tiles, C, ts).permute(0, 2, 1, 3).reshape(B, C, -1)
    return y[:, :, :T].transpose(1, 2)


# (B, C, r, T, tile, S, P): several CTAs a window at small widths, with
# the edges: T shorter than one CTA's rows (the second CTA's rows all
# outside [0, T)), a last TPU tile of half length, C below the padded
# width, a cluster of 5 (not a power of two), the reach as long as a
# CTA's rows (P = 25 = c d at k = 11, d = 5), and the plan's own S and P.
CASES = [(1, 16, 2, 32, 32, 2, 112), (2, 16, 1, 96, 64, 5, 48),
         (2, 24, 2, 192, 32, 5, 40), (1, 32, 4, 512, 64, 3, 160),
         (2, 16, 2, 128, 32, 8, 25)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,C,r,T,tile,S,P", CASES)
def test_cluster_partition_matches_plain(B, C, r, T, tile, S, P, dtype):
    x = _x(B, T, C, seed=C + T).to(dtype)
    q = _stage(C, seed=C)
    want = mrf_int8.mrf_stage_int8_plain(x, q, r, tile)
    got = _cluster_stage(x, q, r, tile, S, P)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cluster_partition_at_the_plans_geometry(dtype):
    """The partition with int8_plan's own cluster and rows, at C = 32 over
    two TPU windows of tile = 64 packed rows (the second of half length)."""
    B, C, r, T, tile = 2, 32, 4, 384, 64
    x = _x(B, T, C, seed=7).to(dtype)
    q = _stage(C, seed=3)
    plan = mrf_int8.int8_plan(T, C, r, KS, DIL, B, dtype, tile)
    assert plan.n_tiles == 2 and plan.ts == 256
    got = _cluster_stage(x, q, r, tile, plan.cluster, plan.rows)
    assert torch.equal(got, mrf_int8.mrf_stage_int8_plain(x, q, r, tile))
