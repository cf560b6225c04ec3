"""Masked self-attention: the CUDA kernel (``csrc/attention.cu``) and its
plain PyTorch version.

Port of ``fused_attention`` (tts_king_tpu/ops/pallas/attention.py). The
wrapper dispatches on where its tensors lie: CPU tensors go to
``attention_plain``; CUDA tensors launch the kernel, or raise. ``launches``
counts the kernel's launches, ``launches_bf16`` those of them on bf16
inputs.
"""

import math

import torch

from tts_king_torch.ops.kernels import _build

NEG_INF = -1e9
launches = 0
launches_bf16 = 0


def attention_plain(q, k, v, key_pad_mask):
    """softmax((q * scale) k^T, padded keys at -1e9) v, in the TPU kernel's
    order: q scaled in its own type, f32 scores and softmax, probabilities
    cast to v's type before P.V with f32 accumulation.

    q, k, v: (B, H, T, D); key_pad_mask: (B, T) bool, True = padded key.
    Returns (B, H, T, D) in q's dtype.
    """
    D = q.shape[-1]
    q = q * torch.tensor(1.0 / math.sqrt(D), dtype=q.dtype)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    s = s.masked_fill(key_pad_mask[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def check_aligned(what, *tensors):
    """Raise unless each (B, H, T, D) tensor's (b, h) bases and rows start
    on 16 bytes: the kernels copy rows with 16-byte cp.async."""
    for t in tensors:
        esz = t.element_size()
        if t.data_ptr() % 16 or any(s * esz % 16 for s in t.stride()[:3]):
            raise ValueError(
                f"{what}: rows must start on 16 bytes (data_ptr "
                f"{t.data_ptr()}, strides {tuple(t.stride())}, "
                f"{esz}-byte elements)")


def attention(q, k, v, key_pad_mask):
    """Masked attention; same contract as ``attention_plain``.

    On CUDA: f32 or bf16, D up to 128 and a multiple of 16 bytes (4 in f32,
    8 in bf16), q/k/v with one shared layout and a unit stride over D (a
    transposed (B, T, H, D) view is taken without a copy) whose rows start
    on 16 bytes (the kernel's 16-byte cp.async); other inputs raise. Padded
    query rows come out finite; the caller zeroes them.
    """
    if q.device.type == "cpu":
        return attention_plain(q, k, v, key_pad_mask)
    if q.device.type != "cuda":
        raise ValueError(f"attention: unsupported device {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"attention: dtype {q.dtype} (float32 or bfloat16)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("attention: q, k, v must share one dtype")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("attention: q, k, v must all be (B, H, T, D)")
    B, H, T, D = q.shape
    per_chunk = 16 // q.element_size()   # the kernel copies 16-byte chunks
    if D > 128 or D % per_chunk:
        raise ValueError(f"attention: head dim {D} (a multiple of "
                         f"{per_chunk} in {q.dtype}, at most 128)")
    if B * H > 65535:   # one grid row per (b, h)
        raise ValueError(f"attention: B * H = {B * H} > 65535")
    if tuple(key_pad_mask.shape) != (B, T) or key_pad_mask.dtype != torch.bool:
        raise ValueError("attention: key_pad_mask must be (B, T) bool")
    if not (k.device == q.device == v.device == key_pad_mask.device):
        raise ValueError("attention: all inputs must be on one device")
    if q.stride(-1) != 1 or k.stride() != q.stride() or v.stride() != q.stride():
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    check_aligned("attention", q, k, v)
    sb, sh, st, _ = q.stride()
    out = torch.empty((B, T, H, D), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    osb, osh, ost, _ = out.stride()
    mask = key_pad_mask.contiguous()   # the kernel reads bool's 0/1 bytes

    # The kernel runs on the current stream after this returns; the caching
    # allocator hands a freed temporary (mask) only to work queued after it.
    lib = _build.load("attention")
    err = lib.tk_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        out.data_ptr(), int(q.dtype == torch.bfloat16), B, H, T, D, sb, sh,
        st, osb, osh, ost, 1.0 / math.sqrt(D), _build.current_stream(q.device))
    _build.check(lib, err, "attention")
    _build.count_launch(globals())
    if q.dtype == torch.bfloat16:
        _build.count_launch(globals(), "launches_bf16")
    return out
