"""Padding-mask helpers (True = padded position).

Same convention as the reference (fs_two/utils/tools.py:121-131): a boolean
mask over the time axis where True marks positions at or beyond the sequence
length.
"""

import torch


def mask_from_lengths(lengths, max_len):
    """(B,) lengths -> (B, max_len) bool mask, True = pad."""
    ids = torch.arange(max_len, dtype=lengths.dtype, device=lengths.device)
    return ids[None, :] >= lengths[:, None]


def lengths_from_mask(mask):
    """(B, T) bool pad-mask -> (B,) lengths."""
    return (~mask).sum(dim=1)
