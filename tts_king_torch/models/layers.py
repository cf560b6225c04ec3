"""Neural building blocks of the FastSpeech2 acoustic model.

Port of tts_king_tpu/models/layers.py. Behaviour kept from the reference
(fs_two/transformer/Layers.py, SubLayers.py, fs_two/model/modules.py):
  * FFTBlock = masked multi-head self-attention + conv1d feed-forward,
    post-LayerNorm, dropout before each residual add, padded positions
    zeroed after each sub-layer;
  * PostNet = 5x [conv1d(k=5) + BatchNorm], tanh on all but the last,
    dropout 0.5, activations zeroed past mel_len after every stage;
  * VariancePredictor = 2x [conv1d(k=3) + ReLU + LayerNorm + dropout] +
    linear head, 0 at padded positions; conv1d_2's padding is 1 whatever k
    is;
  * CNNScalar = two [conv1d(k=1) + adaptive average pool to 30 + LayerNorm
    + ReLU] branches summed, linear head, ReLU (the CWT branch's pitch
    mean and std).

Training mode is the module's ``training`` flag (``model.train()``): dropout
draws its masks from a ``torch.Generator`` that the caller passes down the
forward calls (nothing draws from the global RNG), BatchNorm normalizes
with the batch's statistics and updates its running ones as flax does, and
attention with a gradient goes through the flash kernels. In eval mode, or
with a p of 0, dropout is the identity.

Activations are (B, T, C) at every module boundary, as in the JAX package;
convolutions run on the transposed (B, C, T) view. Submodules carry the flax
names (``w_qs``, ``conv1d_1``, ``layer_0`` ...) so a flax parameter tree maps
onto the state dict by path (tts_king_torch/weights.py).
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tts_king_torch.ops.kernels.attention import attention
from tts_king_torch.ops.kernels.flash_attention import flash_attention

LN_EPS = 1e-5  # torch LayerNorm/BatchNorm default
BN_MOMENTUM = 0.9  # flax's: running = 0.9 * running + 0.1 * batch


def sinusoid_position_table(n_position: int, d_hid: int) -> np.ndarray:
    """Fixed sinusoid table, same angle layout as the reference
    (fs_two/transformer/Models.py:10-30): angle = pos / 10000^(2*(i//2)/d),
    sin on even channels, cos on odd."""
    pos = np.arange(n_position)[:, None]
    idx = np.arange(d_hid)[None, :]
    angle = pos / np.power(10000, 2 * (idx // 2) / d_hid)
    table = np.zeros((n_position, d_hid), dtype=np.float64)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table.astype(np.float32)


def _conv(conv, x):
    """nn.Conv1d on a (B, T, C) tensor."""
    return conv(x.transpose(1, 2)).transpose(1, 2)


class Dropout(nn.Module):
    """flax ``nn.Dropout``: keep with probability 1 - p, scale kept values
    by 1 / (1 - p). The mask comes from the ``generator`` given to forward,
    on the input's device; in eval mode, or at p = 0, the identity."""

    def __init__(self, p):
        super().__init__()
        self.p = float(p)

    def forward(self, x, generator):
        if not self.training or self.p == 0.0:
            return x
        if generator is None:
            raise ValueError("dropout in training mode needs a generator")
        keep = torch.rand(x.shape, generator=generator, device=x.device,
                          dtype=torch.float32) < 1.0 - self.p
        return torch.where(keep, x / (1.0 - self.p), x.new_zeros(()))


class BatchNorm(nn.BatchNorm1d):
    """BatchNorm1d on (B, C, T) with flax's training semantics (flax
    linen.BatchNorm, use_fast_variance): batch mean and variance
    E[x^2] - E[x]^2 (biased, clipped at 0) over every (B, T) position, and
    running stats updated with that biased variance at momentum 0.9. torch's
    own training mode updates the running variance with the unbiased one.
    Eval mode normalizes with the running stats, as BatchNorm1d does."""

    def __init__(self, num_features, eps=LN_EPS):
        super().__init__(num_features, eps=eps, momentum=1.0 - BN_MOMENTUM)
        # None, or the eval-mode multiplier fixed by
        # pipeline.round_variables (flax's on variables rounded to bf16)
        self.register_buffer("eval_mul", None, persistent=False)

    def forward(self, x):
        if not self.training:
            if self.eval_mul is None:
                return super().forward(x)
            return ((x - self.running_mean[:, None]) * self.eval_mul[:, None]
                    + self.bias[:, None])
        mean = x.mean(dim=(0, 2))
        var = ((x * x).mean(dim=(0, 2)) - mean * mean).clamp(min=0.0)
        with torch.no_grad():
            self.running_mean.mul_(BN_MOMENTUM).add_(mean, alpha=self.momentum)
            self.running_var.mul_(BN_MOMENTUM).add_(var, alpha=self.momentum)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None]) * mul[:, None] + self.bias[:, None]


class MultiHeadAttention(nn.Module):
    """Post-LN multi-head self-attention (fs_two/transformer/SubLayers.py:8-65).

    With a gradient to take (grad enabled and the projections requiring
    one) the attention is ``flash_attention``, whose backward is a kernel
    too; otherwise it is the inference kernel's function (``attention``).
    Both compute softmax(q k^T / sqrt(d_k), padded keys at -1e9) v with an
    f32 softmax."""

    def __init__(self, n_head, d_model, d_k, d_v, dropout=0.1):
        super().__init__()
        if d_k != d_v:
            raise ValueError("the attention kernel needs d_k == d_v")
        self.n_head, self.d_k = n_head, d_k
        self.w_qs = nn.Linear(d_model, n_head * d_k)
        self.w_ks = nn.Linear(d_model, n_head * d_k)
        self.w_vs = nn.Linear(d_model, n_head * d_v)
        self.fc = nn.Linear(n_head * d_v, d_model)
        self.dropout = Dropout(dropout)
        self.layer_norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x, key_pad_mask, generator=None):
        B, T, _ = x.shape
        H, D = self.n_head, self.d_k

        def heads(t):  # (B, T, H*D) -> (B, H, T, D) view
            return t.view(B, T, H, D).transpose(1, 2)

        q, k, v = heads(self.w_qs(x)), heads(self.w_ks(x)), heads(self.w_vs(x))
        if torch.is_grad_enabled() and q.requires_grad:
            out = flash_attention(q, k, v, key_pad_mask)
        else:
            out = attention(q, k, v, key_pad_mask)
        out = self.fc(out.transpose(1, 2).reshape(B, T, H * D))
        return self.layer_norm(self.dropout(out, generator) + x)


class PositionwiseFeedForward(nn.Module):
    """Conv1d FFN: k=9 expand, k=1 project, post-LN
    (fs_two/transformer/SubLayers.py:68-100)."""

    def __init__(self, d_in, d_hid, kernel_size=(9, 1), dropout=0.1):
        super().__init__()
        k1, k2 = kernel_size
        self.w_1 = nn.Conv1d(d_in, d_hid, k1, padding=(k1 - 1) // 2)
        self.w_2 = nn.Conv1d(d_hid, d_in, k2, padding=(k2 - 1) // 2)
        self.dropout = Dropout(dropout)
        self.layer_norm = nn.LayerNorm(d_in, eps=LN_EPS)

    def forward(self, x, generator=None):
        h = _conv(self.w_2, F.relu(_conv(self.w_1, x)))
        return self.layer_norm(self.dropout(h, generator) + x)


class FFTBlock(nn.Module):
    """Feed-forward transformer block (fs_two/transformer/Layers.py:11-34)."""

    def __init__(self, d_model, n_head, d_k, d_v, d_inner, kernel_size,
                 dropout=0.1):
        super().__init__()
        self.slf_attn = MultiHeadAttention(n_head, d_model, d_k, d_v, dropout)
        self.pos_ffn = PositionwiseFeedForward(d_model, d_inner, kernel_size,
                                               dropout)

    def forward(self, x, pad_mask, generator=None):
        not_pad = (~pad_mask)[:, :, None].to(x.dtype)
        x = self.slf_attn(x, pad_mask, generator) * not_pad
        return self.pos_ffn(x, generator) * not_pad


class PostNet(nn.Module):
    """Residual mel refiner (fs_two/transformer/Layers.py:71-143)."""

    def __init__(self, n_mel_channels=80, embedding_dim=512, kernel_size=5,
                 n_convolutions=5):
        super().__init__()
        self.n_convolutions = n_convolutions
        for i in range(n_convolutions):
            c_in = n_mel_channels if i == 0 else embedding_dim
            c_out = (n_mel_channels if i == n_convolutions - 1
                     else embedding_dim)
            self.add_module(f"conv_{i}", nn.Conv1d(
                c_in, c_out, kernel_size, padding=(kernel_size - 1) // 2))
            self.add_module(f"bn_{i}", BatchNorm(c_out))
        self.dropout = Dropout(0.5)   # hard-coded in the reference

    def forward(self, x, pad_mask, generator=None):
        """pad_mask (B, T) True=pad: zeroing activations after every stage
        makes each conv see zeros past mel_len, as if the stack ran at that
        item's true length. In training the BatchNorm statistics still run
        over every (B, T) position, as flax's do."""
        not_pad = (~pad_mask)[:, None, :].to(x.dtype)
        h = x.transpose(1, 2) * not_pad
        for i in range(self.n_convolutions):
            h = getattr(self, f"bn_{i}")(getattr(self, f"conv_{i}")(h))
            if i < self.n_convolutions - 1:
                h = torch.tanh(h)
            h = self.dropout(h, generator) * not_pad
        return h.transpose(1, 2)


class VariancePredictor(nn.Module):
    """Duration/pitch/energy predictor (fs_two/model/modules.py:255-309):
    (B, T) out, or (B, T, output_size) when output_size > 1 (the CWT pitch
    predictor's 11 scales)."""

    def __init__(self, d_in, filter_size=256, kernel_size=3, dropout=0.5,
                 output_size=1):
        super().__init__()
        self.output_size = output_size
        k = kernel_size
        self.conv1d_1 = nn.Conv1d(d_in, filter_size, k, padding=(k - 1) // 2)
        self.layer_norm_1 = nn.LayerNorm(filter_size, eps=LN_EPS)
        # conv2 padding is hard-coded to 1 in the reference (modules.py:291)
        self.conv1d_2 = nn.Conv1d(filter_size, filter_size, k, padding=1)
        self.layer_norm_2 = nn.LayerNorm(filter_size, eps=LN_EPS)
        self.dropout = Dropout(dropout)
        self.linear_layer = nn.Linear(filter_size, output_size)

    def forward(self, x, pad_mask, generator=None):
        h = self.layer_norm_1(F.relu(_conv(self.conv1d_1, x)))
        h = self.dropout(h, generator)
        h = self.layer_norm_2(F.relu(_conv(self.conv1d_2, h)))
        h = self.dropout(h, generator)
        out = self.linear_layer(h)
        if self.output_size == 1:
            return torch.where(pad_mask, out.new_zeros(()), out[..., 0])
        return torch.where(pad_mask[:, :, None], out.new_zeros(()), out)


class CNNFlat(nn.Module):
    """Conv1d(C -> 1, k=1) + AdaptiveAvgPool1d(reduce) + LayerNorm + ReLU
    (fs_two/model/modules.py:358-370): (B, T, C) -> (B, reduce). The pool
    averages every position of T, padded ones too (segment i spans
    floor(i*T/reduce) to ceil((i+1)*T/reduce), also for T < reduce)."""

    def __init__(self, d_in, reduce=30):
        super().__init__()
        self.conv = nn.Conv1d(d_in, 1, 1)
        self.norm = nn.LayerNorm(reduce, eps=LN_EPS)
        self.reduce = reduce

    def forward(self, x):
        h = self.conv(x.transpose(1, 2))                  # (B, 1, T)
        h = F.adaptive_avg_pool1d(h, self.reduce)[:, 0]   # (B, reduce)
        return F.relu(self.norm(h))


class CNNScalar(nn.Module):
    """Two CNNFlat branches + a linear head -> (B, 1) non-negative scalar
    (fs_two/model/modules.py:373-385); the pitch mean and std heads of the
    CWT branch."""

    def __init__(self, d_one, d_two, reduce=30):
        super().__init__()
        self.flat_one = CNNFlat(d_one, reduce)
        self.flat_two = CNNFlat(d_two, reduce)
        self.linear = nn.Linear(reduce, 1)

    def forward(self, x_one, x_two):
        return F.relu(self.linear(self.flat_one(x_one) + self.flat_two(x_two)))
