"""One fused HiFi-GAN MRF stage with int8 weights and activations: the CUDA
kernel (``csrc/mrf_stage_int8.cu``) and its plain PyTorch version.

Port of ``fused_mrf_packed`` in int8 mode (tts_king_tpu/ops/pallas/
mrf_packed.py: weights quantized by ``pack_mrf_stage(int8=True)``, :119-126;
activations by ``_quant``, :215-220; dequantization, :261-264). The function:

  * weights: one scale per output channel, max(max |w| over taps and input
    channels, 1e-12) / 127, from the f32 weights; q = floor(w / s + 0.5)
    clipped to [-127, 127]; biases stay f32;
  * before every conv, a = lrelu(h) in the stage dtype and one activation
    scale sx = max(max |a| over the conv's whole window, 1e-6) / 127, a
    quantized as the weights are; the products are summed exactly (s32);
  * y = (acc -> f32) * (sx * wscale[c_out]) + bias, in f32, rounded to the
    stage dtype; rows outside [0, T) zeroed; then the residual add and the
    mask, and the stage output ((b0 + b1) + b2) / 3, as in bf16/f32 mode.

The window a scale covers is the TPU kernel's: its tile of ``tile`` packed
rows (r time steps each, all channels), widened by each branch's halo. On
the packed layout a conv reaches PL = PR = ceil(c * d / r) packed rows (c =
(k - 1) / 2; ``packed_halo``), so the first conv of a branch sees time steps
[t TS - r sum PL, (t + 1) TS + r sum PR), TS = r * tile, and each conv
shrinks the window by its own r PL on either side. The integers a packed
conv multiplies are those of the unpacked conv, so the port works unpacked
with the packed windows; a tile's output steps use that tile's scales, and
halo rows two tiles share are recomputed by each with its own.

The kernel runs each window on a thread-block cluster; ``int8_plan`` fixes
its size, the rows of each CTA, the ring of taps and the shared bytes, and
the C entry point recomputes and checks them. It reads the taps in its own
layout (``pack_kernel_taps``), which ``quantize_mrf_stage`` packs once
beside the plain layout.

The wrapper dispatches on where its tensors lie: CPU tensors go to
``mrf_stage_int8_plain``; CUDA tensors launch the kernel, or raise.
``launches`` counts the kernel's launches.
"""

import ctypes
from dataclasses import dataclass
from typing import Sequence

import torch
import torch.nn.functional as F

from tts_king_torch.ops.kernels import _build
from tts_king_torch.ops.kernels.mrf import (LRELU_SLOPE, MAX_CHANNELS,
                                            MrfStageWeights)

# The TPU kernel's tile in packed rows; the Generator never passes another.
TILE = 1024
_SMEM_LIMIT = 232448
# The kernel's geometry (csrc/mrf_stage_int8.cu): rows a CTA covers in one
# pass at each Cp, the largest (portable) cluster, the deepest tap ring, the
# shared header.
PASS_ROWS = {128: 192, 64: 384, 32: 768}
MAX_CLUSTER = 8
MAX_SLOTS = 4
_HEADER = 512
launches = 0


def padded_channels(C):
    """Channels the kernel's layout pads C to: 32, 64 or 128 for C <= 128."""
    return max(32, 1 << (C - 1).bit_length())


@dataclass
class MrfStageInt8:
    """One stage quantized in the kernel's layout, which the plain version
    reads too. Convs are branch-major, in chain order [convs1_0, convs2_0,
    convs1_1, ...] within a branch; Cp = padded_channels(channels).

    taps: int8, flat, one (k, Cp, Cp) block [tap][c_out][c_in] per conv;
    scales, biases: f32 (n_convs, Cp), the per-output-channel weight scales
    and the biases. All zero past C. kernel_taps: the same taps in the
    CUDA kernel's layout (``pack_kernel_taps``).
    """
    kernel_sizes: Sequence[int]
    dilations: Sequence[int]
    channels: int
    taps: torch.Tensor
    scales: torch.Tensor
    biases: torch.Tensor
    kernel_taps: torch.Tensor

    def conv_taps(self):
        """Each conv's taps as an int8 (C, C, k) Conv1d-layout view,
        branch-major, chain order."""
        C, Cp = self.channels, padded_channels(self.channels)
        out, pos = [], 0
        for k in self.kernel_sizes:
            row = []
            for _ in range(2 * len(self.dilations)):
                blk = self.taps[pos:pos + k * Cp * Cp].view(k, Cp, Cp)
                row.append(blk[:, :C, :C].permute(1, 2, 0))
                pos += k * Cp * Cp
            out.append(row)
        return out


def pack_kernel_taps(taps, Cp):
    """Flat int8 taps of (k, Cp, Cp) blocks [tap][c_out][c_in] -> the CUDA
    kernel's layout: per tap [c_in / 16][c_out][16 c_in], K-major 8-row core
    matrices of 16 bytes without swizzle."""
    n = taps.numel() // (Cp * Cp)
    return (taps.view(n, Cp, Cp // 16, 16).permute(0, 2, 1, 3).contiguous()
            .reshape(-1))


def unpack_kernel_taps(packed, Cp):
    """The inverse of ``pack_kernel_taps``."""
    n = packed.numel() // (Cp * Cp)
    return (packed.view(n, Cp // 16, Cp, 16).permute(0, 2, 1, 3).contiguous()
            .reshape(-1))


def _round_half_up(v):
    return torch.floor(v + 0.5)


def _div(a, v):
    """a / v, rounded as one IEEE division. (PyTorch's CUDA kernels divide
    by a Python or CPU scalar as a multiplication by its reciprocal, which
    may differ by one ulp and move a value across a rounding boundary.)"""
    return a / a.new_tensor(v)


def quantize_weights(w):
    """(C_out, C_in, k) weights -> (int8 taps, f32 scale per output
    channel), as pack_mrf_stage(int8=True) does from the f32 weights."""
    w = w.float()
    amax = w.abs().amax(dim=(1, 2))
    scale = _div(torch.clamp(amax, min=1e-12), 127.0)
    q = _round_half_up(w / scale[:, None, None]).clamp(-127.0, 127.0)
    return q.to(torch.int8), scale


def quantize_mrf_stage(stage: MrfStageWeights) -> MrfStageInt8:
    """Quantize a stage's f32 weights once, into the kernel's layout;
    biases are kept in f32."""
    w0 = stage.weights[0][0]
    C, device = w0.shape[0], w0.device
    Cp = padded_channels(C)
    n = sum(len(ws) for ws in stage.weights)
    scales = torch.zeros((n, Cp), dtype=torch.float32, device=device)
    biases = torch.zeros((n, Cp), dtype=torch.float32, device=device)
    taps, i = [], 0
    for ws, bs in zip(stage.weights, stage.biases):
        for w, b in zip(ws, bs):
            q, s = quantize_weights(w)
            scales[i, :C] = s
            biases[i, :C] = b.float()
            t = torch.zeros((w.shape[-1], Cp, Cp), dtype=torch.int8,
                            device=device)
            t[:, :C, :C] = q.permute(2, 0, 1)
            taps.append(t.reshape(-1))
            i += 1
    taps = torch.cat(taps)
    return MrfStageInt8(list(stage.kernel_sizes), list(stage.dilations), C,
                        taps, scales, biases, pack_kernel_taps(taps, Cp))


def pack_factor(channels, T):
    """The JAX Generator's space-to-depth factor r for a stage of
    ``channels`` at T time steps (models/hifigan.py:222-226)."""
    r = max(1, min(128 // channels, 8))
    while r > 1 and T % r:
        r //= 2
    return r


def packed_halo(k, d, r):
    """Packed rows a same-padded conv of kernel k, dilation d reaches on
    either side at packing factor r: ceil(c d / r), c = (k - 1) / 2 (the
    port's copy of ops/convs.pack_kernel_1d's pad arithmetic)."""
    cd = (k - 1) // 2 * d
    return (cd + r - 1) // r


def _chain_dilations(dilations):
    return [dd for d in dilations for dd in (d, 1)]


def conv_halos(k, dilations, r):
    """Time steps each conv of a branch shrinks the window by on either
    side: r * packed_halo, in chain order."""
    return [r * packed_halo(k, d, r) for d in _chain_dilations(dilations)]


def tile_rows(T, r, tile=TILE):
    """The TPU kernel's tile Tt in packed rows for T time steps
    (mrf_packed.py:161): min(tile, max(8, Mp rounded up to 8))."""
    mp = T // r
    return min(tile, max(8, (mp + 7) // 8 * 8))


@dataclass(frozen=True)
class Int8Plan:
    """The int8 kernel's launch for one stage. Each window (batch item, TPU
    tile) runs on a cluster of ``cluster`` CTAs; CTA s owns the window rows
    [s rows, (s + 1) rows) (row 0 is time step t0 - lmax), covered in
    ``passes`` passes of PASS_ROWS[Cp] rows; the taps stream through a
    ring of ``slots``; with ``msum`` the branch sum stays in shared memory
    and y is written once; ``smem`` is a CTA's dynamic shared bytes."""
    ts: int          # time steps of a TPU tile
    n_tiles: int
    lmax: int        # the widest branch's half-extension
    window: int      # the widest window's rows, ts + 2 lmax
    cdmax: int       # the widest reach c d of one conv
    cluster: int
    rows: int
    passes: int
    slots: int
    msum: bool
    smem: int
    batch: int

    @property
    def grid(self):
        return (self.cluster, self.n_tiles, self.batch)


def _smem_int8(Cp, C, rows, cdmax, slots, msum, esize):
    """csrc/mrf_stage_int8.cu's smem_bytes: header, tap ring, the int8
    window with the reach, h in the stage dtype (C rounded up to 8 channels
    by rows + 8), and as much again for conv 1's output when the rows take
    more than one pass and for the branch sum when msum."""
    cb = (C + 7) // 8 * 8
    bufs = 1 + (rows > PASS_ROWS[Cp]) + bool(msum)
    return (_HEADER + slots * Cp * Cp + Cp * (rows + 2 * cdmax)
            + bufs * cb * (rows + 8) * esize)


def int8_plan(T, C, r, kernel_sizes, dilations, batch=1,
              dtype=torch.bfloat16, tile=TILE):
    """The cluster plan for a stage of C channels at T time steps, packing
    factor r: the fewest passes a CTA that let at most MAX_CLUSTER CTAs
    cover the widest window, the fewest CTAs of that many rows, then the
    branch sum in shared memory with the deepest ring (at most MAX_SLOTS)
    that fits beside it, or else without it. Raises when no plan fits."""
    Cp = padded_channels(C)
    ts = r * tile_rows(T, r, tile)
    n_tiles = -(-T // ts)
    lmax = max(sum(conv_halos(k, dilations, r)) for k in kernel_sizes)
    window = ts + 2 * lmax
    cdmax = max((k - 1) // 2 * d for k in kernel_sizes for d in dilations)
    pr = PASS_ROWS[Cp]
    passes = -(-window // (MAX_CLUSTER * pr))
    rows = passes * pr
    cluster = -(-window // rows)
    if cluster > 1 and rows < cdmax:
        raise ValueError(f"mrf_stage_int8: a conv's reach of {cdmax} steps "
                         f"exceeds a CTA's {rows} rows")
    esize = torch.tensor([], dtype=dtype).element_size()
    for msum in (True, False):
        for slots in range(MAX_SLOTS, 1, -1):
            smem = _smem_int8(Cp, C, rows, cdmax, slots, msum, esize)
            if smem <= _SMEM_LIMIT:
                return Int8Plan(ts, n_tiles, lmax, window, cdmax, cluster,
                                rows, passes, slots, msum, smem, batch)
    raise ValueError(f"mrf_stage_int8: a window of {window} rows at C={C} "
                     f"needs {rows} rows a CTA, which do not fit shared "
                     "memory")


def _lrelu(v):
    return F.leaky_relu(v, LRELU_SLOPE)


def _quantize_acts(a):
    """(N, C, W) activations -> (float64 integers, f32 scale (N, 1, 1)):
    one scale per window."""
    af = a.float()
    sx = _div(torch.clamp(af.abs().amax(dim=(1, 2), keepdim=True), min=1e-6),
              127.0)
    q = _round_half_up(af / sx).clamp(-127.0, 127.0)
    return q.double(), sx


def _stage_tiles(x, q: MrfStageInt8, r, tile, shift):
    """The int8 stage on tiles that start ``shift`` packed rows before 0
    (0 for the TPU kernel's tiling). x: (B, T, C)."""
    B, T, C = x.shape
    dtype = x.dtype
    if T % r:
        raise ValueError(f"mrf_stage_int8: T={T} is not a multiple of r={r}")
    ts = r * tile_rows(T, r, tile)
    off = r * shift
    n_tiles = -(-(T + off) // ts)
    halos = [conv_halos(k, q.dilations, r) for k in q.kernel_sizes]
    lmax = max(sum(h) for h in halos)
    span = n_tiles * ts
    # xpad index i is time step i - off - lmax
    xp = F.pad(x.transpose(1, 2), (off + lmax, span - off - T + lmax))
    t0 = torch.arange(n_tiles, device=x.device) * ts - off
    n_br = len(q.kernel_sizes)
    taps = q.conv_taps()
    scales, biases = q.scales[:, :C], q.biases[:, :C]
    acc = None
    conv_idx = 0
    for b, (k, hs) in enumerate(zip(q.kernel_sizes, halos)):
        lo = sum(hs)
        width = ts + 2 * lo
        # (B, n_tiles, C, width) windows -> (B * n_tiles, C, width)
        h = xp[:, :, lmax - lo:lmax - lo + (n_tiles - 1) * ts + width]
        h = h.unfold(2, width, ts).permute(0, 2, 1, 3).reshape(-1, C, width)
        c = (k - 1) // 2
        res = None
        for i, (hi, d) in enumerate(zip(hs, _chain_dilations(q.dilations))):
            qa, sx = _quantize_acts(_lrelu(h))
            out = F.conv1d(qa, taps[b][i].double(), dilation=d)
            crop = hi - c * d
            out = out[:, :, crop:out.shape[-1] - crop].float()
            scale = sx * scales[conv_idx][None, :, None]
            y = (out * scale + biases[conv_idx][None, :, None]).to(dtype)
            lo -= hi
            w_out = y.shape[-1]
            g = (t0[:, None] - lo
                 + torch.arange(w_out, device=x.device)[None, :])
            valid = ((g >= 0) & (g < T)).to(dtype)[None, :, None, :]
            y = (y.view(B, n_tiles, C, w_out) * valid).view(-1, C, w_out)
            if i % 2 == 0:
                res, h = h, y
            else:
                cut = (res.shape[-1] - w_out) // 2
                h = y + res[:, :, cut:cut + w_out]
                h = (h.view(B, n_tiles, C, w_out) * valid).view(-1, C, w_out)
            conv_idx += 1
        acc = h if acc is None else acc + h
    out = _div(acc, n_br).view(B, n_tiles, C, ts).permute(0, 2, 1, 3)
    out = out.reshape(B, C, span)[:, :, off:off + T]
    return out.transpose(1, 2)


def mrf_stage_int8_plain(x, q: MrfStageInt8, r, tile=TILE):
    """The int8 stage on (B, T, C) x, as the TPU kernel computes it at
    packing factor r with tiles of ``tile`` packed rows. The integer
    products are summed in float64, which is exact for these sums."""
    return _stage_tiles(x, q, r, tile, 0)


def _check(x, q: MrfStageInt8, r):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"mrf_stage_int8: dtype {x.dtype} (float32 or "
                        "bfloat16)")
    if x.dim() != 3:
        raise ValueError("mrf_stage_int8: x must be (B, T, C)")
    B, T, C = x.shape
    if C > MAX_CHANNELS:
        raise ValueError(f"mrf_stage_int8: {C} channels > {MAX_CHANNELS}")
    if B > 65535:
        raise ValueError(f"mrf_stage_int8: batch {B} > 65535")
    if r < 1 or T % r:
        raise ValueError(f"mrf_stage_int8: T={T} is not a multiple of r={r}")
    ks = [int(k) for k in q.kernel_sizes]
    if not 1 <= len(ks) <= 4 or not 1 <= len(q.dilations) <= 4:
        raise ValueError("mrf_stage_int8: 1-4 branches of 1-4 dilations")
    if any(k % 2 == 0 for k in ks):
        raise ValueError("mrf_stage_int8: kernel sizes must be odd")
    if q.channels != C:
        raise ValueError(f"mrf_stage_int8: a stage of {q.channels} channels "
                         f"for x of {C}")
    Cp = padded_channels(C)
    n = len(ks) * 2 * len(q.dilations)
    n_taps = 2 * len(q.dilations) * sum(ks)
    if (q.kernel_taps.dtype != torch.int8 or q.kernel_taps.dim() != 1
            or q.kernel_taps.numel() != n_taps * Cp * Cp):
        raise ValueError("mrf_stage_int8: kernel_taps must be int8, flat, "
                         "in pack_kernel_taps's layout")
    if (tuple(q.scales.shape) != (n, Cp)
            or tuple(q.biases.shape) != (n, Cp)):
        raise ValueError("mrf_stage_int8: scales/biases must be (n_convs, Cp)")
    for t in (q.kernel_taps, q.scales, q.biases):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("mrf_stage_int8: taps, scales and biases must be "
                             "contiguous on x's device")
    if q.scales.dtype != torch.float32 or q.biases.dtype != torch.float32:
        raise ValueError("mrf_stage_int8: scales and biases must be f32")


def mrf_stage_int8(x, q: MrfStageInt8, r, tile=TILE):
    """One int8 MRF stage; same contract as ``mrf_stage_int8_plain``.

    x: (B, T, C), any strides (a transposed (B, C, T) tensor is read in
    place). Returns (B, T, C) with x's memory layout. On CUDA: f32 or bf16,
    C <= 128, odd kernel sizes, taps, scales and biases on x's device.
    """
    if x.device.type == "cpu":
        return mrf_stage_int8_plain(x, q, r, tile)
    if x.device.type != "cuda":
        raise ValueError(f"mrf_stage_int8: unsupported device {x.device}")
    _check(x, q, r)
    B, T, C = x.shape
    Cp = padded_channels(C)
    ks = [int(k) for k in q.kernel_sizes]
    dil = [int(d) for d in q.dilations]
    plan = int8_plan(T, C, r, ks, dil, B, x.dtype, tile)
    hal = [h for k in ks for h in conv_halos(k, dil, r)]
    is_bf16 = int(x.dtype == torch.bfloat16)
    lib = _build.load("mrf_stage_int8")
    if (lib.tk_mrf_int8_cluster_smem(Cp, C, plan.rows, plan.cdmax,
                                     plan.slots, int(plan.msum),
                                     is_bf16) != plan.smem
            or lib.tk_mrf_int8_pass_rows(Cp) != PASS_ROWS[Cp]):
        raise RuntimeError("mrf_stage_int8: int8_plan and the kernel's "
                           "geometry disagree")
    y = torch.empty_like(x)
    err = lib.tk_mrf_int8_cluster_stage(
        x.data_ptr(), y.data_ptr(), q.kernel_taps.data_ptr(),
        q.scales.data_ptr(), q.biases.data_ptr(), is_bf16, B, T, C, Cp,
        plan.ts, plan.n_tiles, len(ks), (ctypes.c_int * len(ks))(*ks),
        len(dil), (ctypes.c_int * len(dil))(*dil),
        (ctypes.c_int * len(hal))(*hal), plan.cluster, plan.rows, plan.slots,
        int(plan.msum), *x.stride(), *y.stride(),
        _build.current_stream(x.device))
    _build.check(lib, err, "mrf_stage_int8")
    _build.count_launch(globals())
    return y
