"""Flash attention with a key-padding mask, forward and backward: the CUDA
kernels (``csrc/flash_attention.cu``) and their plain PyTorch versions.

Port of ``flash_attention_padmask`` (tts_king_tpu/ops/pallas/attention.py),
the training attention of the FFT blocks. The function is

    softmax((q k^T) / sqrt(D), padded keys at -1e9) v

with q, k, v (B, H, T, D) and key_pad_mask (B, T) bool (True = padded key).
Padded keys are excluded exactly; padded query rows attend the valid keys and
come out finite (the caller zeroes them); there is no query-side mask.

``flash_attention`` dispatches on where its tensors lie: CPU tensors go to
``flash_attention_plain`` (eager ops, gradients from autograd); CUDA tensors
go through ``FlashAttention``, a ``torch.autograd.Function`` whose forward
launches the forward kernel and saves O and the f32 log-sum-exp of each row,
and whose backward launches the dQ and dK/dV kernels, which recompute the
probabilities from q, k and the log-sum-exp (in the bf16-probability mode,
below, read them from the forward's). Anything else raises. On CUDA
only float32 is taken (the training step is f32); bfloat16 raises
``TypeError``. The Function also runs on CPU tensors, float32 or float64,
through ``flash_forward_plain`` / ``flash_backward_plain``, the same
arithmetic in eager ops, so its backward can be checked with gradcheck.

``launches_fwd`` and ``launches_bwd`` count the forward kernel's launches and
the backward's (one per backward call, which launches dQ then dK/dV);
``launches_fwd_probs_bf16`` and ``launches_bwd_probs_bf16`` those of them in
the bf16-probability mode.

``probs_bf16=True`` (``ModelConfig.attention_probs_bf16``) is the JAX
package's XLA attention with its probabilities rounded to bf16
(attention.attention_probs_bf16_plain) and its gradient as ``jax.vjp``
gives it, P the normalized f32 softmax and round() rounding to bf16:

    dV = round(P)^T dO,  dP = round(dO v^T),  Delta_i = sum_j P_ij dP_ij,
    dS = P * (dP - Delta),  dQ = dS k * scale,  dK = dS^T q * scale.

The mode's kernels (``csrc/attention_round.cuh``) compute no product twice:
the forward keeps S in a (B, H, T, ld) f32 buffer between its two passes
(the first for each row's max and sum) and leaves P there, which the
Function saves for the backward instead of recomputing S; Delta is not
rowsum(dO * O) there, so the dQ kernel's first pass computes dP, sums Delta
and writes round(dP) (bf16) to a second buffer, which its second pass and
dK/dV read. ``attention.probs_plan`` sizes the buffers: at the bench
step's decoder call (B=16, H=2, T=640) P takes 52.4 MB from the forward to
the backward, round(dP) 26.2 MB during it.

A row whose keys are all padded is not reproduced exactly by the backward
(its log-sum-exp, -1e9 + log T, rounds to -1e9 in f32); training never has
one, since every utterance has a phoneme and a frame.
"""

import math

import torch

from tts_king_torch.ops.kernels import _build
from tts_king_torch.ops.kernels.attention import (attention_probs_bf16_plain,
                                                  check_aligned, probs_plan,
                                                  round_bf16)

NEG_INF = -1e9
launches_fwd = 0
launches_bwd = 0
launches_fwd_probs_bf16 = 0
launches_bwd_probs_bf16 = 0


def _scores(q, k, key_pad_mask):
    s = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    return s.masked_fill(key_pad_mask[:, None, None, :], NEG_INF)


def flash_attention_plain(q, k, v, key_pad_mask, probs_bf16=False):
    """The contract in eager ops; differentiable through autograd."""
    if probs_bf16:
        return attention_probs_bf16_plain(q, k, v, key_pad_mask)
    return torch.matmul(torch.softmax(_scores(q, k, key_pad_mask), dim=-1), v)


def flash_forward_plain(q, k, v, key_pad_mask, probs_bf16=False):
    """The forward kernel's function: (O, log-sum-exp of each row)."""
    s = _scores(q, k, key_pad_mask)
    lse = torch.logsumexp(s, dim=-1)
    if probs_bf16:
        return torch.matmul(round_bf16(torch.softmax(s, dim=-1)), v), lse
    return torch.matmul(torch.exp(s - lse[..., None]), v), lse


def flash_backward_plain(q, k, v, key_pad_mask, o, lse, do,
                         probs_bf16=False):
    """The backward kernels' function: P recomputed from q, k and lse,
    Delta = rowsum(dO * O), dS = P * (dO v^T - Delta); probs_bf16: the
    module docstring's formulas, Delta = rowsum(P * round(dO v^T))."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.exp(_scores(q, k, key_pad_mask) - lse[..., None])
    dp = torch.matmul(do, v.transpose(-1, -2))
    if probs_bf16:
        dp = round_bf16(dp)
        delta = (p * dp).sum(-1, keepdim=True)
        p_v = round_bf16(p)
    else:
        delta = (do * o).sum(-1, keepdim=True)
        p_v = p
    ds = p * (dp - delta)
    dq = torch.matmul(ds, k) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q) * scale
    dv = torch.matmul(p_v.transpose(-1, -2), do)
    return dq, dk, dv


def _check(q, k, v, key_pad_mask):
    if q.dtype in (torch.bfloat16, torch.float16):
        raise TypeError(f"flash_attention: dtype {q.dtype} is not supported "
                        "yet (the training step is float32)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k, v must share one dtype")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("flash_attention: q, k, v must all be (B, H, T, D)")
    B, H, T, D = q.shape
    if tuple(key_pad_mask.shape) != (B, T) or key_pad_mask.dtype != torch.bool:
        raise ValueError("flash_attention: key_pad_mask must be (B, T) bool")
    if not (k.device == q.device == v.device == key_pad_mask.device):
        raise ValueError("flash_attention: all inputs must be on one device")
    if q.device.type == "cuda":
        if q.dtype != torch.float32:
            raise TypeError(f"flash_attention: dtype {q.dtype} on CUDA "
                            "(float32 only)")
        if D > 128 or D % 4:   # the kernels copy 16-byte chunks
            raise ValueError(f"flash_attention: head dim {D} (a multiple of "
                             "4, at most 128)")
        if B * H > 65535:   # one grid row per (b, h)
            raise ValueError(f"flash_attention: B * H = {B * H} > 65535")
    elif q.device.type != "cpu":
        raise ValueError(f"flash_attention: unsupported device {q.device}")


def _out_like(q):
    """A (B, H, T, D) buffer laid out as (B, T, H, D), the layout the FFT
    block's output projection reads without a copy."""
    B, H, T, D = q.shape
    return torch.empty((B, T, H, D), dtype=q.dtype,
                       device=q.device).transpose(1, 2)


def _forward_cuda(q, k, v, mask, probs_bf16=False):
    """The forward kernel: (O, lse, P), P the mode's (B, H, T, ld)
    probabilities for the backward (None without the mode)."""
    B, H, T, D = q.shape
    o = _out_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    lib = _build.load("flash_attention")
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            o.data_ptr(), lse.data_ptr())
    shape = (B, H, T, D, *q.stride()[:3], *o.stride()[:3])
    stream = _build.current_stream(q.device)
    probs = None
    if probs_bf16:
        plan = probs_plan(B, H, T, D)
        probs = torch.empty(plan["probs"], dtype=torch.float32,
                            device=q.device)
        err = lib.tk_flash_fwd_probs_bf16(*args, probs.data_ptr(), *shape,
                                          plan["ld"], 1.0 / math.sqrt(D),
                                          stream)
    else:
        err = lib.tk_flash_fwd(*args, *shape, 1.0 / math.sqrt(D), stream)
    _build.check(lib, err, "flash_attention forward")
    _build.count_launch(globals(), "launches_fwd")
    if probs_bf16:
        _build.count_launch(globals(), "launches_fwd_probs_bf16")
    return o, lse, probs


def _backward_cuda(q, k, v, mask, o, lse, probs, do):
    """The backward kernels: (dQ, dK, dV); the mode's (probs, as the
    forward left it, not None) reads P instead of recomputing it."""
    B, H, T, D = q.shape
    if do.stride() != o.stride() or do.data_ptr() % 16:
        do = _out_like(q).copy_(do)   # autograd's gradient, in O's layout
    dq, dk, dv = _out_like(q), _out_like(q), _out_like(q)
    lib = _build.load("flash_attention")
    shape = (B, H, T, D, *q.stride()[:3], *o.stride()[:3])
    grads = (dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    stream = _build.current_stream(q.device)
    if probs is not None:
        plan = probs_plan(B, H, T, D)
        dprobs = torch.empty(plan["dprobs"], dtype=torch.bfloat16,
                             device=q.device)
        delta = torch.empty(plan["delta"], dtype=torch.float32,
                            device=q.device)
        err = lib.tk_flash_bwd_probs_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            do.data_ptr(), probs.data_ptr(), dprobs.data_ptr(),
            delta.data_ptr(), *grads, *shape, plan["ld"],
            1.0 / math.sqrt(D), stream)
    else:
        delta = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
        err = lib.tk_flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            o.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            *grads, *shape, 1.0 / math.sqrt(D), stream)
    _build.check(lib, err, "flash_attention backward")
    _build.count_launch(globals(), "launches_bwd")
    if probs is not None:
        _build.count_launch(globals(), "launches_bwd_probs_bf16")
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Flash attention with a hand-written backward: the kernels on CUDA
    tensors, their plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, key_pad_mask, probs_bf16=False):
        _check(q, k, v, key_pad_mask)
        ctx.probs_bf16 = bool(probs_bf16)
        if q.device.type == "cuda":
            # one layout with a unit stride over D for q, k and v
            if (q.stride(-1) != 1 or k.stride() != q.stride()
                    or v.stride() != q.stride()):
                q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
            check_aligned("flash_attention", q, k, v)
            mask = key_pad_mask.contiguous()   # read as 0/1 bytes
            o, lse, probs = _forward_cuda(q, k, v, mask, ctx.probs_bf16)
        else:
            mask = key_pad_mask
            o, lse = flash_forward_plain(q, k, v, mask, ctx.probs_bf16)
            probs = None
        ctx.save_for_backward(q, k, v, mask, o, lse, probs)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask, o, lse, probs = ctx.saved_tensors
        if q.device.type == "cuda":
            dq, dk, dv = _backward_cuda(q, k, v, mask, o, lse, probs, do)
        else:
            dq, dk, dv = flash_backward_plain(q, k, v, mask, o, lse, do,
                                              ctx.probs_bf16)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, key_pad_mask, probs_bf16=False):
    """Training attention; same contract as ``flash_attention_plain``.

    On CUDA: float32, D a multiple of 4 up to 128; q, k, v may be strided
    (B, H, T, D) views with a unit stride over D and one shared layout (the
    transposed (B, T, H, D) output of a Linear is taken without a copy),
    whose rows start on 16 bytes; other inputs raise. The output and the
    gradients are laid out as (B, T, H, D)."""
    if q.device.type == "cpu":
        _check(q, k, v, key_pad_mask)
        return flash_attention_plain(q, k, v, key_pad_mask, probs_bf16)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return FlashAttention.apply(q, k, v, key_pad_mask, probs_bf16)
