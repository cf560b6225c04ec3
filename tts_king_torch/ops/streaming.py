"""Streaming (chunked) vocoder synthesis.

The port's copy of tts_king_tpu/ops/streaming.py. A HiFi-GAN (or
BigVGAN) generator is fully convolutional, so a waveform chunk depends only
on a bounded mel neighbourhood: vocoding fixed-size mel windows with a halo
on either side gives the full pass's audio everywhere but at the
utterance's edges, and the first chunk is ready after one small vocoder
call. Every window has one shape, so the card sees the same launches for
every chunk.
"""

from typing import Callable, Iterator

import numpy as np


def generator_receptive_field(config, act_reach: int) -> int:
    """Conservative one-sided receptive field of a HiFi-GAN-shaped
    generator in mel frames: conv_pre + per stage (transposed-conv and MRF
    halos, divided back to the mel rate by the upsampling so far) +
    conv_post, with ``act_reach`` (an activation's reach in samples) twice
    a dilation and once before conv_post. pipeline.VOCODERS holds each
    family's."""
    rf = 3.0  # conv_pre k=7
    up = 1.0
    for u, k in zip(config.upsample_rates, config.upsample_kernel_sizes):
        prev_up, up = up, up * u
        rf += (k / u) / prev_up  # transposed conv halo, at the input rate
        mrf_halo = max(
            sum((kk - 1) // 2 * d + (kk - 1) // 2 + 2 * act_reach
                for d in dil)
            for kk, dil in zip(config.resblock_kernel_sizes,
                               config.resblock_dilation_sizes))
        rf += mrf_halo / up
    rf += (3.0 + act_reach) / up  # conv_post k=7 at sample rate
    return int(np.ceil(rf)) + 2


def stream_vocoder(vocode: Callable[[np.ndarray], np.ndarray], mel,
                   chunk_frames: int = 64, halo_frames: int = 32,
                   hop: int = 256, start_frame: int = 0
                   ) -> Iterator[np.ndarray]:
    """Yield waveform chunks for a (1, T, n_mels) numpy mel.

    vocode: (1, frames, n_mels) numpy mel -> (1, frames * hop) numpy
    waveform. halo_frames must cover the generator's receptive field
    (pipeline.Vocoder.halo_frames). Windows past the utterance's edges repeat
    its edge frames. The chunks concatenate to the full pass's waveform,
    exactly in the interior. start_frame skips the chunks before it, which
    were already produced (serve.SynthesisServer.stream's first window).
    """
    mel = np.asarray(mel)
    if mel.ndim != 3 or mel.shape[0] != 1:
        raise ValueError(f"stream_vocoder: mel must be (1, T, n_mels), got "
                         f"{mel.shape}")
    T = mel.shape[1]
    for start in range(start_frame, T, chunk_frames):
        lo = start - halo_frames
        hi = start + chunk_frames + halo_frames
        pad_l = max(0, -lo)
        pad_r = max(0, hi - T)
        piece = mel[:, max(lo, 0):min(hi, T)]
        if pad_l or pad_r:
            piece = np.pad(piece, [(0, 0), (pad_l, pad_r), (0, 0)],
                           mode="edge")
        wav = np.asarray(vocode(piece))
        n_valid = min(chunk_frames, T - start)
        yield wav[0, halo_frames * hop:(halo_frames + n_valid) * hop]
