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
"""

from typing import Any, Dict, NamedTuple

import torch


class FS2Losses(NamedTuple):
    total: Any
    mel: Any
    pitch: Any
    energy: Any
    duration: Any
    pitch_mean: Any
    pitch_std: Any


def _masked_mse(pred, target, valid):
    valid = valid.to(pred.dtype)
    err = (pred - target) ** 2 * valid
    return err.sum() / valid.sum().clamp(min=1.0)


def fastspeech2_loss(batch: Dict[str, Any], outputs: Dict[str, Any],
                     use_cwt: bool = False) -> FS2Losses:
    """batch: training targets (tensors); outputs: FastSpeech2.forward's
    dict. Every term is a 0-dim tensor."""
    src_valid = ~outputs["src_masks"]          # (B, L)
    mel_valid = ~outputs["mel_masks"]          # (B, T') possibly truncated
    T = mel_valid.shape[1]

    mel_targets = batch["mels"][:, :T]
    log_d_targets = torch.log(batch["durations"].float() + 1.0)

    zero = log_d_targets.new_zeros(())
    if use_cwt:
        pitch_valid = src_valid[:, :, None].expand(
            -1, -1, outputs["pitch_prediction"].shape[-1])
        pitch_loss = _masked_mse(outputs["pitch_prediction"],
                                 batch["pitches_cwt"], pitch_valid)
        mean_loss = torch.mean(
            (outputs["pitch_mean"][:, 0] - batch["pitches_mean"]) ** 2)
        std_loss = torch.mean(
            (outputs["pitch_std"][:, 0] - batch["pitches_std"]) ** 2)
    else:
        pitch_loss = _masked_mse(outputs["pitch_prediction"],
                                 batch["pitches_raw"], src_valid)
        mean_loss = std_loss = zero
    energy_loss = _masked_mse(outputs["energy_prediction"],
                              batch["energies"], src_valid)
    duration_loss = _masked_mse(outputs["log_duration_prediction"],
                                log_d_targets, src_valid)

    # mel terms: mask-zeroed, averaged over the FULL tensor (reference quirk)
    m = mel_valid[:, :, None].to(mel_targets.dtype)
    mel_p = outputs["mel"][:, :T] * m
    post_p = outputs["postnet_mel"][:, :T] * m
    mel_t = mel_targets * m
    mel_mse = torch.mean((mel_p - mel_t) ** 2)
    mel_mae = torch.mean(torch.abs(mel_p - mel_t))
    post_mae = torch.mean(torch.abs(post_p - mel_t))
    mel_loss = mel_mse + mel_mae + post_mae

    total = (mel_loss + duration_loss + pitch_loss + energy_loss
             + mean_loss + std_loss)
    return FS2Losses(total, mel_loss, pitch_loss, energy_loss, duration_loss,
                     mean_loss, std_loss)
