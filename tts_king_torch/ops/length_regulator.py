"""Fixed-size length regulator.

The reference expands each phoneme's hidden state `duration[i]` times with a
per-item Python loop (fs_two/model/modules.py:220-252). Here the same mapping
is one gather with a static output length, as in the JAX package:

    ends[b]   = cumsum(durations[b])
    idx[b, t] = #{i : ends[b, i] <= t}         (searchsorted right)
    out[b, t] = x[b, idx[b, t]]  if t < mel_len[b] else 0

which is exactly "repeat phoneme i duration[i] times, then zero-pad".
"""

import torch


def length_regulate(x, durations, max_mel_len):
    """Expand phoneme-level features to frame level.

    Args:
      x: (B, L, H) phoneme hidden states.
      durations: (B, L) non-negative frame counts; truncated to int here
        (the reference's int() in modules.py:244-245).
      max_mel_len: output length T.

    Returns:
      out: (B, T, H) frame-level features, zero past mel_len.
      mel_len: (B,) int32 total frames per item (may exceed T; caller clamps).
    """
    durations = durations.to(torch.int32)
    ends = torch.cumsum(durations, dim=1, dtype=torch.int32)  # (B, L)
    mel_len = ends[:, -1]
    B = x.shape[0]
    t = torch.arange(max_mel_len, dtype=torch.int32, device=x.device)
    idx = torch.searchsorted(ends, t[None, :].expand(B, -1).contiguous(),
                             right=True)
    idx = idx.clamp(max=x.shape[1] - 1)
    out = torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[2]))
    valid = t[None, :] < mel_len.clamp(max=max_mel_len)[:, None]
    out = torch.where(valid[:, :, None], out, out.new_zeros(()))
    return out, mel_len


def round_durations(log_duration_pred, d_control):
    """Inference duration rounding, bit-matching the reference:
    clamp(round((exp(logd) - 1)) * d_control, min=0)
    (fs_two/model/modules.py:199-204). ``torch.round`` rounds half to even,
    as ``jnp.round`` does. Returned as float, like the reference's
    duration_rounded output."""
    d = torch.round(torch.exp(log_duration_pred) - 1.0) * d_control
    return d.clamp(min=0.0)
