"""One fused HiFi-GAN MRF stage: the CUDA kernel (``csrc/mrf_stage.cu``) and
its plain PyTorch version.

Port of ``fused_mrf_packed`` / ``mrf_stage_apply``
(tts_king_tpu/ops/pallas/mrf_packed.py), bf16/f32 mode, on the unpacked
(B, T, C) layout. The wrapper dispatches on where its tensors lie: CPU
tensors go to ``mrf_stage_plain``; CUDA tensors launch the kernel, or raise.
``launches`` counts the kernel's launches.
"""

import ctypes
from dataclasses import dataclass
from typing import List, Sequence

import torch
import torch.nn.functional as F

from tts_king_torch.ops.kernels import _build

LRELU_SLOPE = 0.1
MAX_CHANNELS = 128
# Dynamic shared memory one block may use on an H100 (227 KB).
_SMEM_LIMIT = 232448
_MAX_TILE = 512
launches = 0


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


def mrf_stage_plain(x, stage: MrfStageWeights):
    """Mean over branches of ResBlock1(x), with per-conv zero padding.

    x: (B, T, C). Each conv adds its bias after the product, as the JAX
    package does, so in bf16 the sum is rounded once before the bias.
    """
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


def _padded_channels(C, dtype):
    """Channels the kernel works on: a multiple of 8 in f32 (CUDA cores);
    16, 32, 64 or 128 in bf16 (tensor-core n-tiles of 8, k-steps of 16)."""
    if dtype == torch.bfloat16:
        return max(16, 1 << (C - 1).bit_length())
    return (C + 7) // 8 * 8


def _pack(stage, C, Cp, dtype, device):
    """Taps as (k, Cp, Cp) blocks, branch-major, chain order, zero past C:
    [tap][c_in][c_out] in f32 (CUDA-core path), [tap][c_out][c_in] in bf16
    (the tensor-core B operand). Biases (n_convs, Cp)."""
    perm = (2, 0, 1) if dtype == torch.bfloat16 else (2, 1, 0)
    taps, biases = [], []
    for ws, bs in zip(stage.weights, stage.biases):
        for w, b in zip(ws, bs):
            k = w.shape[-1]
            t = torch.zeros((k, Cp, Cp), dtype=dtype, device=device)
            t[:, :C, :C] = w.permute(*perm)
            taps.append(t.reshape(-1))
            bp = torch.zeros((Cp,), dtype=dtype, device=device)
            bp[:C] = b
            biases.append(bp)
    return torch.cat(taps), torch.stack(biases)


def _tile(lib, is_bf16, T, hmax, Cp):
    """Largest tile of time steps (a multiple of 8, at most 512) whose two
    activation buffers and weight buffer fit one block's shared memory."""
    fn = lib.tk_mrf_smem_bytes
    tt = min(_MAX_TILE, (T + 7) // 8 * 8)
    while tt > 8 and fn(is_bf16, tt, hmax, Cp) > _SMEM_LIMIT:
        tt -= 8
    if fn(is_bf16, tt, hmax, Cp) > _SMEM_LIMIT:
        raise ValueError("mrf_stage: stage does not fit shared memory")
    return tt


def mrf_stage(x, stage: MrfStageWeights):
    """One MRF stage; same contract as ``mrf_stage_plain``.

    x: (B, T, C), any strides (a transposed (B, C, T) tensor is read in
    place). Returns (B, T, C) with x's memory layout. On CUDA: f32 or bf16,
    C <= 128, odd kernel sizes, weights on x's device and dtype.
    """
    global launches
    if x.device.type == "cpu":
        return mrf_stage_plain(x, stage)
    if x.device.type != "cuda":
        raise ValueError(f"mrf_stage: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"mrf_stage: dtype {x.dtype} (float32 or bfloat16)")
    if x.dim() != 3:
        raise ValueError("mrf_stage: x must be (B, T, C)")
    B, T, C = x.shape
    if C > MAX_CHANNELS:
        raise ValueError(f"mrf_stage: {C} channels > {MAX_CHANNELS}")
    if B > 65535:   # one grid row per batch item
        raise ValueError(f"mrf_stage: batch {B} > 65535")
    ks = [int(k) for k in stage.kernel_sizes]
    dil = [int(d) for d in stage.dilations]
    if not 1 <= len(ks) <= 4 or not 1 <= len(dil) <= 4:
        raise ValueError("mrf_stage: 1-4 branches of 1-4 dilations")
    if any(k % 2 == 0 for k in ks):
        raise ValueError("mrf_stage: kernel sizes must be odd")
    for k, ws, bs in zip(ks, stage.weights, stage.biases):
        if len(ws) != 2 * len(dil) or len(bs) != 2 * len(dil):
            raise ValueError("mrf_stage: 2 convs per dilation and branch")
        for w, b in zip(ws, bs):
            if tuple(w.shape) != (C, C, k) or tuple(b.shape) != (C,):
                raise ValueError("mrf_stage: weight shapes do not match x")
            if w.device != x.device or w.dtype != x.dtype or b.dtype != x.dtype:
                raise ValueError("mrf_stage: weights must match x's device "
                                 "and dtype")
    Cp = _padded_channels(C, x.dtype)
    taps, biases = _pack(stage, C, Cp, x.dtype, x.device)
    y = torch.empty_like(x)
    is_bf16 = int(x.dtype == torch.bfloat16)

    # The kernel runs on the current stream after this returns; the caching
    # allocator hands freed temporaries (taps, biases) only to work queued
    # after it.
    lib = _build.load("mrf_stage")
    tt = _tile(lib, is_bf16, T, _halo(ks, dil), Cp)
    fn = lib.tk_mrf_stage
    ks_arr = (ctypes.c_int * len(ks))(*ks)
    dil_arr = (ctypes.c_int * len(dil))(*dil)
    err = fn(x.data_ptr(), y.data_ptr(), taps.data_ptr(), biases.data_ptr(),
             is_bf16, B, T, C, Cp, tt, len(ks), ks_arr, len(dil), dil_arr,
             *x.stride(), *y.stride(), _build.current_stream(x.device))
    _build.check(lib, err, "mrf_stage")
    launches += 1
    return y
