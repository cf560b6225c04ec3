"""One fused HiFi-GAN MRF stage: the CUDA kernel (``csrc/mrf_stage.cu``) and
its plain PyTorch version.

Port of ``fused_mrf_packed`` / ``mrf_stage_apply``
(tts_king_tpu/ops/pallas/mrf_packed.py), bf16/f32 mode, on the unpacked
(B, T, C) layout. The wrapper dispatches on where its tensors lie: CPU
tensors go to ``mrf_stage_plain``; CUDA tensors launch the kernel, or raise.
``launches`` counts the wrapper's launches (one per stage: in f32 that is a
pass per dilation pair and the branch mean, launched together).

``rows`` (per item, the rows a caller needs: the Generator's delivered
samples depend on no others) lets the bf16 kernel skip the blocks whose
tile starts past them (``grid_tiles``); ``tiles_run`` and ``tiles_total``
count the bf16 kernel's blocks that ran and that its grid holds.

The kernel reads a stage's taps packed once (``pack_stage``, an
``MrfStagePacked``): bf16 taps in the layout that the tensor cores' B
operand reads from shared memory (``tap_byte_offset``), f32 taps in chunks
of 16 input channels whose rows (one per output channel) ldmatrix reads
without bank conflicts (``f32_tap_offset``). ``tile_plan`` fixes the
kernel's time tile, each conv's row window and the ring of tap slots (bf16:
a ``TilePlan``, all 18 convs on one tile; f32: an ``F32Plan``, one
(tile, branch) block per dilation pair); ``mrf_stage_tiles_plain`` runs the
plain arithmetic window by window on either plan.
"""

import ctypes
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from tts_king_torch.ops.kernels import _build

LRELU_SLOPE = 0.1
MAX_CHANNELS = 128
# Dynamic shared memory one block may use on an H100 (227 KB).
SMEM_LIMIT = 232448
_MAX_TILE = 512
# bf16 route: consumer warpgroups a block runs, slack that aligns the tap
# ring to the swizzle atom, and the ring's depth in slots.
_CONSUMER_WGS = 2
_RING_ALIGN = 1024
_MIN_SLOTS, _MAX_SLOTS = 3, 32
# f32 route: input channels per tap chunk and floats per chunk row (4 of
# padding, so the 8 rows an ldmatrix reads fall in distinct banks);
# consumer warps a block runs and 16-row m-tiles each holds; the ring's
# depth in slots; the blocks a pass should launch to give every SM of an
# H100 (132) two blocks in turn.
F32_KC, F32_ROW = 16, 20
_F32_WARPS, _F32_MT = 8, 2
_F32_MIN_SLOTS, _F32_MAX_SLOTS = 3, 8
_F32_TARGET_BLOCKS = 2 * 132
launches = 0
tiles_run = tiles_total = 0


@dataclass
class MrfStageWeights:
    """One stage's ResBlock1 weights in chain order.

    weights[b]: the 2 * len(dilations) conv weights of branch b, in torch
    Conv1d layout (C, C, k_b), ordered [convs1_0, convs2_0, convs1_1, ...];
    biases[b]: their (C,) biases in the same order.
    """
    kernel_sizes: Sequence[int]
    dilations: Sequence[int]
    weights: List[List[torch.Tensor]]
    biases: List[List[torch.Tensor]]


@dataclass
class MrfStagePacked:
    """One stage packed once in the kernel's layout (``pack_stage``).

    taps: flat, one block of k * tap_elems(Cp, dtype) elements per conv,
    branch-major, in chain order; bf16 taps in the B-operand layout of
    ``tap_byte_offset``, f32 taps in that of ``f32_tap_offset``. biases:
    (n_convs, Cp). Zero past C (and in the f32 rows' padding);
    Cp = _padded_channels(channels).
    """
    kernel_sizes: Sequence[int]
    dilations: Sequence[int]
    channels: int
    taps: torch.Tensor
    biases: torch.Tensor

    def unpack(self) -> MrfStageWeights:
        """The stage's weights as Conv1d tensors (exact)."""
        return MrfStageWeights(
            list(self.kernel_sizes), list(self.dilations),
            unpack_taps(self.taps, self.kernel_sizes, self.dilations,
                        self.channels),
            _unpack_biases(self.biases, len(self.kernel_sizes),
                           len(self.dilations), self.channels))


def _as_weights(stage):
    return stage.unpack() if isinstance(stage, MrfStagePacked) else stage


def mrf_stage_plain(x, stage, rows=None):
    """Mean over branches of ResBlock1(x), with per-conv zero padding.

    x: (B, T, C); stage: MrfStageWeights or MrfStagePacked. Each conv adds
    its bias after the product, as the JAX package does, so in bf16 the sum
    is rounded once before the bias. rows: None, or per item the rows
    needed (host integers); item b's rows from rows[b] on are zero.
    """
    if rows is not None:
        rows = torch.tensor(host_counts(rows, *x.shape[:2]), device=x.device)
        past = torch.arange(x.shape[1], device=x.device) >= rows[:, None]
        return mrf_stage_plain(x, stage).masked_fill(past[:, :, None], 0)
    stage = _as_weights(stage)
    h0 = x.transpose(1, 2)
    acc = None
    for k, ws, bs in zip(stage.kernel_sizes, stage.weights, stage.biases):
        c = (k - 1) // 2
        h = h0
        for p, d in enumerate(stage.dilations):
            t = F.leaky_relu(h, LRELU_SLOPE)
            t = F.conv1d(t, ws[2 * p], None, padding=c * d, dilation=d)
            t = t + bs[2 * p][:, None]
            t = F.leaky_relu(t, LRELU_SLOPE)
            t = F.conv1d(t, ws[2 * p + 1], None, padding=c)
            t = t + bs[2 * p + 1][:, None]
            h = t + h
        acc = h if acc is None else acc + h
    return (acc / len(stage.kernel_sizes)).transpose(1, 2)


def _halo(kernel_sizes, dilations):
    return max((k - 1) // 2 * (sum(dilations) + len(dilations))
               for k in kernel_sizes)


def _padded_channels(C):
    """Channels the kernel works on, in either dtype: 16, 32, 64 or 128.
    bf16: the tensor cores' N, a multiple of 16 in K and one swizzle atom
    of 32, 64 or 128 bytes a row; f32: whole 16-channel tap chunks and a
    warp tiling per width."""
    return max(16, 1 << (C - 1).bit_length())


# ------------------------------------------------------------ tap layout


def swizzle_bytes(Cp):
    """Bytes of one row of a bf16 tap's swizzle atom: 128 for Cp >= 64
    (64 input channels), else the whole row (64 or 32)."""
    return min(128, 2 * Cp)


def chunk_bytes(Cp):
    """Bytes of one bulk copy of a bf16 tap: Cp rows of one swizzle width
    (a K-half of the tap at Cp = 128, the whole tap below)."""
    return Cp * swizzle_bytes(Cp)


def tap_byte_offset(n, k, Cp):
    """Byte offset of element (output channel n, input channel k) within a
    packed bf16 tap: the canonical K-major layout that a wgmma B descriptor
    reads with a swizzle of swizzle_bytes(Cp) (128B, 64B or 32B mode).

    The tap is split along k into chunks of swizzle_bytes(Cp) / 2 input
    channels, each a block of Cp rows (one per n) of swizzle_bytes(Cp)
    bytes. Within a block the 16-byte group of a row is XORed with bits 7
    and up of the row's byte offset (CUTLASS's Swizzle<3,4,3>, <2,4,3>,
    <1,4,3>). Works elementwise on ints and integer tensors or arrays."""
    swb = swizzle_bytes(Cp)
    per = swb // 2
    kh, kk = k // per, k % per
    o = n * swb + (kk // 8) * 16 + (kk % 8) * 2
    mask = {128: 7, 64: 3, 32: 1}[swb]
    o = o ^ (((o >> 7) & mask) << 4)
    return kh * (Cp * swb) + o


def f32_tap_offset(n, k, Cp):
    """Element offset of (output channel n, input channel k) within a packed
    f32 tap: chunks of F32_KC input channels, each Cp rows (one per n) of
    F32_ROW floats, the last 4 of a row zero. A row is 80 bytes (20 words,
    4 times an odd number), so the 8 rows of an ldmatrix fall in distinct
    banks; a chunk is one bulk copy. Works elementwise on ints and integer
    tensors or arrays."""
    return (k // F32_KC) * Cp * F32_ROW + n * F32_ROW + k % F32_KC


def tap_elems(Cp, dtype):
    """Elements of one packed tap: Cp * Cp in bf16; in f32 Cp rows of
    F32_ROW floats per chunk of F32_KC input channels."""
    if dtype == torch.bfloat16:
        return Cp * Cp
    return Cp // F32_KC * Cp * F32_ROW


def _tap_index(C, Cp, dtype):
    """(C_out, C_in) element offsets within one packed tap."""
    n = torch.arange(C, device="cpu").view(C, 1)
    k = torch.arange(C, device="cpu").view(1, C)
    if dtype == torch.bfloat16:
        return tap_byte_offset(n, k, Cp) // 2
    return f32_tap_offset(n, k, Cp)


def _conv_index(C, Cp, dtype, k):
    """(k * C * C,) element offsets of a conv's (C, C, k) weights, read in
    [tap][c_out][c_in] order, within its packed block."""
    tap = _tap_index(C, Cp, dtype)
    return (torch.arange(k, device="cpu").view(k, 1, 1) * tap_elems(Cp, dtype)
            + tap.view(1, C, C)).reshape(-1)


def _pack(stage: MrfStageWeights, C, Cp, dtype, device):
    """Taps as one block of k packed taps per conv, branch-major, chain
    order, zero past C: bf16 in the B-operand layout (tap_byte_offset), f32
    in chunks of padded rows (f32_tap_offset). Biases (n_convs, Cp)."""
    taps, biases = [], []
    for ws, bs in zip(stage.weights, stage.biases):
        for w, b in zip(ws, bs):
            k = w.shape[-1]
            t = torch.zeros((k * tap_elems(Cp, dtype),), dtype=dtype,
                            device=device)
            idx = _conv_index(C, Cp, dtype, k).to(device)
            t[idx] = w.to(dtype).permute(2, 0, 1).reshape(-1)
            taps.append(t)
            bp = torch.zeros((Cp,), dtype=dtype, device=device)
            bp[:C] = b
            biases.append(bp)
    return torch.cat(taps), torch.stack(biases)


def pack_stage(stage: MrfStageWeights, dtype=None) -> MrfStagePacked:
    """Pack a stage once for the kernel, in ``dtype`` (default: the
    weights'), on the weights' device."""
    w0 = stage.weights[0][0]
    dtype = w0.dtype if dtype is None else dtype
    C = w0.shape[0]
    taps, biases = _pack(stage, C, _padded_channels(C), dtype,
                         w0.device)
    return MrfStagePacked(list(stage.kernel_sizes), list(stage.dilations), C,
                          taps, biases)


def unpack_taps(taps, kernel_sizes, dilations, C):
    """Each conv's (C, C, k) weights from packed taps, branch-major, chain
    order: the inverse of ``_pack``'s taps."""
    Cp = _padded_channels(C)
    per = tap_elems(Cp, taps.dtype)
    out, pos = [], 0
    for k in kernel_sizes:
        row = []
        idx = _conv_index(C, Cp, taps.dtype, k).to(taps.device)
        for _ in range(2 * len(dilations)):
            blk = taps[pos:pos + k * per]
            row.append(blk[idx].view(k, C, C).permute(1, 2, 0).contiguous())
            pos += k * per
        out.append(row)
    return out


def _unpack_biases(biases, n_branch, n_dil, C):
    n = 2 * n_dil
    return [[biases[b * n + i, :C] for i in range(n)]
            for b in range(n_branch)]


# ------------------------------------------------------------- tile plan


@dataclass
class TilePlan:
    """How the bf16 kernel cuts a stage of T steps into blocks.

    Buffer row 0 of a block is time step t0 - hmax (t0 = the block's first
    output step); the block writes rows [hmax, hmax + tt). windows[b][n] is
    the (lo, hi) buffer rows conv n of branch b writes (chain order);
    m_tiles[b][n] the 64-row tiles that cover it (bf16). rows: rows of each
    activation buffer; slots: tap chunks the ring holds;
    smem_bytes: the block's dynamic shared memory; work_factor: the rows
    the convs compute, weighted by taps, over those of an untiled stage.
    """
    Cp: int
    tt: int
    hmax: int
    rows: int
    slots: int
    smem_bytes: int
    rows_per_pass: int
    windows: List[List[Tuple[int, int]]]
    m_tiles: List[List[int]]
    work_factor: float

    def blocks(self, B, T):
        return B * -(-T // self.tt)


def grid_tiles(plan: TilePlan, B, T, rows=None):
    """(blocks that run, blocks of the grid) of a bf16 launch: item b's
    tile j runs when j * tt < rows[b] (every tile without rows)."""
    n = -(-T // plan.tt)
    if rows is None:
        return B * n, B * n
    return sum(min(n, -(-r // plan.tt)) for r in rows), B * n


def m_tiles_per_warpgroup(Cp):
    """64-row tiles each consumer warpgroup holds in its accumulators
    (Cp / 2 f32 registers each): 3 at Cp = 128, 5 below."""
    return 3 if Cp == 128 else 5


def _windows(tt, hmax, kernel_sizes, dilations):
    out = []
    for k in kernel_sizes:
        c = (k - 1) // 2
        halo = c * (sum(dilations) + len(dilations))
        lo, hi = hmax - halo, hmax + tt + halo
        convs = []
        for d in dilations:
            for reach in (c * d, c):
                lo, hi = lo + reach, hi - reach
                convs.append((lo, hi))
        out.append(convs)
    return out


def _smem_bf16(tt, hmax, Cp, slots):
    return (_RING_ALIGN + slots * (chunk_bytes(Cp) + 16)
            + 2 * (tt + 2 * hmax) * (Cp + 8) * 2)


def tile_plan(T, C, dtype, kernel_sizes, dilations, batch=1):
    """The kernel's plan for a stage of T steps and C channels: a
    ``TilePlan`` in bf16, an ``F32Plan`` (``f32_plan``) in f32.

    bf16: the largest time tile (a multiple of 8, at most 512) that fits
    one block, each conv's window within the consumers' m64 tiles (so each
    tap is read once per conv) and two activation buffers beside a ring of
    at least _MIN_SLOTS tap chunks, the rest of shared memory given to more
    slots (up to _MAX_SLOTS). ``batch`` counts only in f32."""
    ks, dil = list(kernel_sizes), list(dilations)
    if dtype != torch.bfloat16:
        return f32_plan(T, C, ks, dil, batch)
    Cp = _padded_channels(C)
    hmax = _halo(ks, dil)
    per_pass = 64 * _CONSUMER_WGS * m_tiles_per_warpgroup(Cp)

    def fits(tt):
        widest = max(hi - lo for w in _windows(tt, hmax, ks, dil)
                     for lo, hi in w)
        return (widest <= per_pass
                and _smem_bf16(tt, hmax, Cp, _MIN_SLOTS) <= SMEM_LIMIT)

    tt = min(_MAX_TILE, (T + 7) // 8 * 8)
    while tt > 8 and not fits(tt):
        tt -= 8
    if not fits(tt):
        raise ValueError("mrf_stage: stage does not fit one block")
    free = SMEM_LIMIT - _smem_bf16(tt, hmax, Cp, 0)
    slots = min(_MAX_SLOTS, free // (chunk_bytes(Cp) + 16))
    # at least half an SM's shared memory, one block per SM (its consumers
    # take the registers its producer frees)
    smem = max(_smem_bf16(tt, hmax, Cp, slots), SMEM_LIMIT // 2)
    windows = _windows(tt, hmax, ks, dil)
    m_tiles = [[-(-(hi - lo) // 64) for lo, hi in w] for w in windows]
    work = sum(k * (hi - lo) for k, w in zip(ks, windows) for lo, hi in w)
    useful = tt * 2 * len(dil) * sum(ks)
    return TilePlan(Cp, tt, hmax, tt + 2 * hmax, slots, smem, per_pass,
                    windows, m_tiles, work / useful)


# ------------------------------------------------------- f32 pass plan


def f32_warp_grid(Cp):
    """(warps across the rows, warps across the channels) of an f32 block:
    8 consumer warps, two across the channels at Cp = 128 (64 each)."""
    wn = 2 if Cp == 128 else 1
    return _F32_WARPS // wn, wn


def f32_chunk_bytes(Cp):
    """Bytes of one f32 tap chunk: Cp rows of F32_ROW floats."""
    return Cp * F32_ROW * 4


def _smem_f32(tt, rmax, cmax, Cp, slots):
    """The ring (a chunk and two mbarriers a slot), then the pass's input
    rows (tt + 2 rmax) and conv1's rows (tt + 2 cmax), Cp + 4 floats a row
    (4 times an odd number of words: an ldmatrix's 8 rows in distinct
    banks)."""
    return (slots * (f32_chunk_bytes(Cp) + 16)
            + (2 * tt + 2 * rmax + 2 * cmax) * (Cp + 4) * 4)


@dataclass
class F32Plan:
    """How the f32 kernel cuts a stage into passes and blocks.

    The stage runs as one pass per dilation pair, then the branch mean.
    Pass p launches a block per (tile of tt steps, branch, batch item):
    it reads the branch's h with the pair's reach r = c (d + 1) a side,
    computes conv1 over tt + 2c rows and conv2 over tt rows, and writes
    h + conv2 to a scratch buffer that pass p + 1 reads; the last pass's
    three buffers are averaged in branch order by the mean pass.
    windows[b][p] = (conv1 rows, conv2 rows, reach) of branch b's pass p.
    rows_in / rows_mid: rows of the two activation buffers (the widest
    pass's); rows_per_pass: the rows a block's warps hold (16-row m-tiles);
    slots: tap chunks the ring holds; work_factor as in ``TilePlan``.
    """
    Cp: int
    tt: int
    rmax: int
    cmax: int
    rows_in: int
    rows_mid: int
    slots: int
    smem_bytes: int
    rows_per_pass: int
    n_branches: int
    windows: List[List[Tuple[int, int, int]]]
    work_factor: float

    def blocks(self, B, T):
        """Blocks of each pass's launch."""
        return self.n_branches * B * -(-T // self.tt)

    @property
    def n_launches(self):
        """Kernel launches per stage: a pass per dilation pair, the mean."""
        return len(self.windows[0]) + 1


def f32_plan(T, C, kernel_sizes, dilations, batch=1) -> F32Plan:
    """The f32 plan: the largest tile (a multiple of 16, at most 512) whose
    conv1 rows fit the warps' m-tiles and whose buffers fit one block
    beside _F32_MIN_SLOTS tap chunks, cut down so that a pass launches
    about _F32_TARGET_BLOCKS blocks (but not below 64 steps) and to T
    rounded up to 16; the rest of shared memory goes to more slots."""
    ks, dil = list(kernel_sizes), list(dilations)
    Cp = _padded_channels(C)
    nb = len(ks)
    cmax = max((k - 1) // 2 for k in ks)
    rmax = cmax * (max(dil) + 1)
    wm, _ = f32_warp_grid(Cp)
    per_pass = 16 * wm * _F32_MT

    def fits(tt):
        return (tt + 2 * cmax <= per_pass and
                _smem_f32(tt, rmax, cmax, Cp, _F32_MIN_SLOTS) <= SMEM_LIMIT)

    tt = _MAX_TILE
    while tt > 16 and not fits(tt):
        tt -= 16
    if not fits(tt):
        raise ValueError("mrf_stage: stage does not fit one block")
    want = -(-nb * batch * T // _F32_TARGET_BLOCKS)
    tt = min(tt, max(64, (want + 15) // 16 * 16), (T + 15) // 16 * 16)
    free = SMEM_LIMIT - _smem_f32(tt, rmax, cmax, Cp, 0)
    slots = min(_F32_MAX_SLOTS, free // (f32_chunk_bytes(Cp) + 16))
    windows = [[(tt + 2 * ((k - 1) // 2), tt, (k - 1) // 2 * (d + 1))
                for d in dil] for k in ks]
    work = sum(k * (m1 + m2) for k, w in zip(ks, windows) for m1, m2, _ in w)
    useful = tt * 2 * len(dil) * sum(ks)
    return F32Plan(Cp, tt, rmax, cmax, tt + 2 * rmax, tt + 2 * cmax, slots,
                   _smem_f32(tt, rmax, cmax, Cp, slots), per_pass, nb,
                   windows, work / useful)


def _conv_rows(h, w, d, m, matmul):
    """Rows [0, m) of a conv without padding over h (N, rows, C): out[i] =
    sum_j h[i + j d] . w[:, :, j]^T, tap by tap, each product by
    ``matmul``."""
    out = None
    for j in range(w.shape[-1]):
        t = matmul(h[:, j * d:j * d + m, :], w[:, :, j].t())
        out = t if out is None else out + t
    return out


def mrf_stage_f32_tiles_plain(x, stage, plan: F32Plan, matmul=torch.matmul):
    """The stage as the f32 kernel computes it: pass by pass, tile by tile
    on ``plan``, each conv a sum of shifted products over its window (by
    ``matmul``: tf32.matmul_3xtf32 gives the kernel's products), conv1's
    rows outside [0, T) zeroed, h + conv2 kept on [0, T) only, then the
    mean over branches in branch order. x: (B, T, C) float32."""
    stage = _as_weights(stage)
    B, T, C = x.shape
    tt = plan.tt
    n_tiles = -(-T // tt)
    times = torch.arange(n_tiles, device=x.device)[:, None] * tt
    acc = None
    for k, ws, bs, wins in zip(stage.kernel_sizes, stage.weights,
                               stage.biases, plan.windows):
        c = (k - 1) // 2
        h = x
        for p, (d, (m1, m2, r)) in enumerate(zip(stage.dilations, wins)):
            # rows t0 - r + [0, tt + 2 r) of every tile, zero outside [0, T)
            hp = F.pad(h.transpose(1, 2), (r, n_tiles * tt - T + r))
            a = hp.unfold(2, tt + 2 * r, tt).permute(0, 2, 3, 1)
            a = a.reshape(B * n_tiles, tt + 2 * r, C)
            t = _conv_rows(F.leaky_relu(a, LRELU_SLOPE), ws[2 * p], d, m1,
                           matmul)
            t = F.leaky_relu(t + bs[2 * p], LRELU_SLOPE)
            g = times - c + torch.arange(m1, device=x.device)
            valid = ((g >= 0) & (g < T)).to(t.dtype).repeat(B, 1)
            t = t * valid[:, :, None]
            t = _conv_rows(t, ws[2 * p + 1], 1, m2, matmul) + bs[2 * p + 1]
            h = (a[:, r:r + tt] + t).reshape(B, n_tiles * tt, C)[:, :T]
        acc = h if acc is None else acc + h
    return acc / len(stage.kernel_sizes)


def mrf_stage_tiles_plain(x, stage, plan):
    """The stage as the kernel computes it, in plain PyTorch. An
    ``F32Plan`` goes to ``mrf_stage_f32_tiles_plain``. A ``TilePlan``: its
    tiles, each conv over its window only (no padding), rows outside
    [0, T) zeroed after every conv and residual add, the branch mean over
    the tile's rows. x: (B, T, C)."""
    if isinstance(plan, F32Plan):
        return mrf_stage_f32_tiles_plain(x, stage, plan)
    stage = _as_weights(stage)
    B, T, C = x.shape
    tt, hmax = plan.tt, plan.hmax
    n_tiles = -(-T // tt)
    R = plan.rows
    # xp index i is time step i - hmax; windows (B * n_tiles, C, R)
    xp = F.pad(x.transpose(1, 2), (hmax, n_tiles * tt - T + hmax))
    win = xp.unfold(2, R, tt).permute(0, 2, 1, 3).reshape(-1, C, R)
    t0 = torch.arange(n_tiles, device=x.device) * tt - hmax

    def mask(h, lo):
        g = t0[:, None] + lo + torch.arange(h.shape[-1], device=x.device)
        valid = ((g >= 0) & (g < T)).to(h.dtype)[None, :, None, :]
        return (h.view(B, n_tiles, C, -1) * valid).view(h.shape)

    acc = None
    for k, ws, bs, wins in zip(stage.kernel_sizes, stage.weights,
                               stage.biases, plan.windows):
        c = (k - 1) // 2
        lo0 = wins[0][0] - c * stage.dilations[0]
        h = mask(win[:, :, lo0:wins[0][1] + c * stage.dilations[0]], lo0)
        for p, d in enumerate(stage.dilations):
            (lo1, _), (lo2, hi2) = wins[2 * p], wins[2 * p + 1]
            t = F.conv1d(F.leaky_relu(h, LRELU_SLOPE), ws[2 * p], None,
                         dilation=d)
            t = mask(F.leaky_relu(t + bs[2 * p][:, None], LRELU_SLOPE), lo1)
            t = F.conv1d(t, ws[2 * p + 1], None)
            t = mask(t + bs[2 * p + 1][:, None], lo2)
            cut = lo2 - (lo1 - c * d)
            h = mask(t + h[:, :, cut:cut + hi2 - lo2], lo2)
        acc = h if acc is None else acc + h
    out = (acc / len(stage.kernel_sizes)).view(B, n_tiles, C, tt)
    out = out.permute(0, 2, 1, 3).reshape(B, C, n_tiles * tt)[:, :, :T]
    return out.transpose(1, 2)


# ----------------------------------------------------------------- wrapper


def _check_weights(x, stage: MrfStageWeights):
    C = x.shape[2]
    for k, ws, bs in zip(stage.kernel_sizes, stage.weights, stage.biases):
        if len(ws) != 2 * len(stage.dilations) or len(bs) != len(ws):
            raise ValueError("mrf_stage: 2 convs per dilation and branch")
        for w, b in zip(ws, bs):
            if tuple(w.shape) != (C, C, k) or tuple(b.shape) != (C,):
                raise ValueError("mrf_stage: weight shapes do not match x")
            if w.device != x.device or w.dtype != x.dtype or b.dtype != x.dtype:
                raise ValueError("mrf_stage: weights must match x's device "
                                 "and dtype")


def _check_packed(x, stage: MrfStagePacked, ks, dil):
    C = x.shape[2]
    Cp = _padded_channels(C)
    n = len(ks) * 2 * len(dil)
    if stage.channels != C:
        raise ValueError(f"mrf_stage: a stage of {stage.channels} channels "
                         f"for x of {C}")
    if (stage.taps.dim() != 1
            or stage.taps.numel() != (2 * len(dil) * sum(ks)
                                      * tap_elems(Cp, x.dtype))
            or tuple(stage.biases.shape) != (n, Cp)):
        raise ValueError("mrf_stage: packed taps/biases do not match x")
    for t in (stage.taps, stage.biases):
        if (t.device != x.device or t.dtype != x.dtype
                or not t.is_contiguous()):
            raise ValueError("mrf_stage: packed taps and biases must be "
                             "contiguous, on x's device and dtype")


def host_counts(counts, B, T, what="mrf_stage: rows"):
    """Per-item counts (a list, numpy or a CPU tensor) as B Python ints,
    each cut to T; raises on a device tensor (reading it would sync), a
    count other than B or a negative count."""
    if isinstance(counts, torch.Tensor) and counts.device.type != "cpu":
        raise ValueError(f"{what} must be host integers, not a tensor on "
                         f"{counts.device}")
    counts = [int(c) for c in counts]
    if len(counts) != B or min(counts) < 0:
        raise ValueError(f"{what} {counts} for a batch of {B}")
    return [min(c, T) for c in counts]


def mrf_stage(x, stage, rows=None):
    """One MRF stage; same contract as ``mrf_stage_plain``.

    x: (B, T, C), any strides (a transposed (B, C, T) tensor is read in
    place). Returns (B, T, C) with x's memory layout. stage: an
    MrfStagePacked (the Generator's, packed once) or MrfStageWeights
    (packed on every call). On CUDA: f32 or bf16, C <= 128, odd kernel
    sizes, weights on x's device and dtype. rows (host integers, one per
    item): in bf16 the kernel runs only the tiles that start below them and
    y is zero from rows[b] on; in f32 every row is computed, as without.
    """
    if x.device.type == "cpu":
        return mrf_stage_plain(x, stage, rows)
    if x.device.type != "cuda":
        raise ValueError(f"mrf_stage: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"mrf_stage: dtype {x.dtype} (float32 or bfloat16)")
    if x.dim() != 3:
        raise ValueError("mrf_stage: x must be (B, T, C)")
    B, T, C = x.shape
    if C > MAX_CHANNELS:
        raise ValueError(f"mrf_stage: {C} channels > {MAX_CHANNELS}")
    ks = [int(k) for k in stage.kernel_sizes]
    dil = [int(d) for d in stage.dilations]
    if not 1 <= len(ks) <= 4 or not 1 <= len(dil) <= 4:
        raise ValueError("mrf_stage: 1-4 branches of 1-4 dilations")
    if B * len(ks) > 65535:   # one grid row per (branch,) batch item
        raise ValueError(f"mrf_stage: batch {B} x {len(ks)} branches > "
                         "65535")
    if any(k % 2 == 0 for k in ks):
        raise ValueError("mrf_stage: kernel sizes must be odd")
    if isinstance(stage, MrfStageWeights):
        _check_weights(x, stage)
        stage = pack_stage(stage)
    _check_packed(x, stage, ks, dil)
    if rows is not None:
        rows = host_counts(rows, B, T)
    plan = tile_plan(T, C, x.dtype, ks, dil, batch=B)
    y = torch.empty_like(x)

    lib = _build.load("mrf_stage")
    ks_arr = (ctypes.c_int * len(ks))(*ks)
    dil_arr = (ctypes.c_int * len(dil))(*dil)
    # The kernels run on the current stream after this returns; the caching
    # allocator hands taps packed (and scratch allocated) for this call only
    # to work queued after it.
    if x.dtype == torch.float32:
        # two buffers of each branch's h (B, T, Cp): the passes alternate
        scratch = torch.empty((2, len(ks), B, T, plan.Cp), dtype=x.dtype,
                              device=x.device)
        err = lib.tk_mrf_stage_f32(
            x.data_ptr(), y.data_ptr(), stage.taps.data_ptr(),
            stage.biases.data_ptr(), scratch.data_ptr(), B, T, C, plan.Cp,
            plan.tt, plan.slots, len(ks), ks_arr, len(dil), dil_arr,
            *x.stride(), *y.stride(), _build.current_stream(x.device))
    else:
        run, total = grid_tiles(plan, B, T, rows)
        err = lib.tk_mrf_stage_bf16(
            x.data_ptr(), y.data_ptr(), stage.taps.data_ptr(),
            stage.biases.data_ptr(),
            None if rows is None else (ctypes.c_int * B)(*rows), B, T, C,
            plan.Cp, plan.tt, plan.slots, len(ks), ks_arr, len(dil), dil_arr,
            *x.stride(), *y.stride(), _build.current_stream(x.device))
    _build.check(lib, err, "mrf_stage")
    _build.count_launch(globals())
    if x.dtype == torch.bfloat16:
        _build.count_launch(globals(), "tiles_run", run)
        _build.count_launch(globals(), "tiles_total", total)
    return y
