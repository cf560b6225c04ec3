"""FastSpeech2 training loss.

Port of tts_king_tpu/train/loss.py (reference fs_two/model/loss.py:24-134),
with its quirks kept:
  * pitch/energy/log-duration MSE averaged over the VALID (unmasked) source
    positions only (masked_select semantics);
  * the mel terms (MSE + MAE + postnet MAE) computed on mask-zeroed tensors
    but averaged over the FULL padded tensor (loss.py:83-96), which rescales
    the mel term against the others;
  * log-duration targets are log(d + 1) (loss.py:56);
  * mel targets trimmed to the decoder-truncated length (loss.py:57);
  * with ``use_cwt`` the pitch term is the masked MSE over the 11 CWT
    scales, plus the MSE of the pitch mean and std heads; otherwise those
    two terms are 0.

Under data parallelism (``dp``, the mesh's axis) every term is this rank's
share of the *global* batch's term, so that the shares of all ranks sum to
it, and so do their gradients: a masked mean's numerator over the global
count of valid positions (the counts all-reduced over dp), a full-tensor
mean's sum over the global element count. Averaging each rank's own means
(DDP's gradient average) would weigh a rank's valid positions by its own
count instead.
"""

from typing import Any, Dict, NamedTuple

import torch

from tts_king_torch.parallel.comm import Axis, all_reduce


class FS2Losses(NamedTuple):
    total: Any
    mel: Any
    pitch: Any
    energy: Any
    duration: Any
    pitch_mean: Any
    pitch_std: Any


def _masked_mse(pred, target, valid, count):
    """The masked mean over ``count`` valid positions (the global batch's
    under data parallelism)."""
    err = (pred - target) ** 2 * valid.to(pred.dtype)
    return err.sum() / count.clamp(min=1.0)


def fastspeech2_loss(batch: Dict[str, Any], outputs: Dict[str, Any],
                     use_cwt: bool = False, dp: Axis = Axis()) -> FS2Losses:
    """batch: training targets (tensors); outputs: FastSpeech2.forward's
    dict. Every term is a 0-dim tensor; under ``dp`` (a mesh axis), this
    rank's share of the global batch's term."""
    src_valid = ~outputs["src_masks"]          # (B, L)
    mel_valid = ~outputs["mel_masks"]          # (B, T') possibly truncated
    T = mel_valid.shape[1]

    mel_targets = batch["mels"][:, :T]
    log_d_targets = torch.log(batch["durations"].float() + 1.0)

    zero = log_d_targets.new_zeros(())
    # the global counts of valid positions (data, no gradient)
    n_src = src_valid.sum().to(log_d_targets.dtype)
    n_pitch = n_src * (outputs["pitch_prediction"].shape[-1]
                       if use_cwt else 1)
    n_src, n_pitch = all_reduce(torch.stack([n_src, n_pitch]), dp)

    def mean(x):   # this rank's share of a full-tensor mean
        return x.sum() / (x.numel() * dp.size)

    if use_cwt:
        pitch_valid = src_valid[:, :, None].expand(
            -1, -1, outputs["pitch_prediction"].shape[-1])
        pitch_loss = _masked_mse(outputs["pitch_prediction"],
                                 batch["pitches_cwt"], pitch_valid, n_pitch)
        mean_loss = mean(
            (outputs["pitch_mean"][:, 0] - batch["pitches_mean"]) ** 2)
        std_loss = mean(
            (outputs["pitch_std"][:, 0] - batch["pitches_std"]) ** 2)
    else:
        pitch_loss = _masked_mse(outputs["pitch_prediction"],
                                 batch["pitches_raw"], src_valid, n_pitch)
        mean_loss = std_loss = zero
    energy_loss = _masked_mse(outputs["energy_prediction"],
                              batch["energies"], src_valid, n_src)
    duration_loss = _masked_mse(outputs["log_duration_prediction"],
                                log_d_targets, src_valid, n_src)

    # mel terms: mask-zeroed, averaged over the FULL tensor (reference quirk)
    m = mel_valid[:, :, None].to(mel_targets.dtype)
    mel_p = outputs["mel"][:, :T] * m
    post_p = outputs["postnet_mel"][:, :T] * m
    mel_t = mel_targets * m
    mel_mse = mean((mel_p - mel_t) ** 2)
    mel_mae = mean(torch.abs(mel_p - mel_t))
    post_mae = mean(torch.abs(post_p - mel_t))
    mel_loss = mel_mse + mel_mae + post_mae

    total = (mel_loss + duration_loss + pitch_loss + energy_loss
             + mean_loss + std_loss)
    return FS2Losses(total, mel_loss, pitch_loss, energy_loss, duration_loss,
                     mean_loss, std_loss)
