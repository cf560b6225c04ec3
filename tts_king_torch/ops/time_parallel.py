"""Sequence-parallel (time-sharded) vocoding over a mesh.

Port of tts_king_tpu/ops/time_parallel.py. The HiFi-GAN generator is fully
convolutional with a bounded receptive field (ops/streaming.py), so one
long utterance vocodes n ways: the time axis is split over the mesh's
``axis``, each slice is vocoded with ``halo`` mel frames of each
neighbour's slice on either side, and only its centre is kept. The halo
exchange is non-circular: the first and last slices get zeros where they
have no neighbour, the zero padding the sequence's ends need.

On a mesh of processes each rank vocodes its own slice (the halos come
from one all-gather of every rank's edge frames, a few kB) and the centres
are gathered, so every rank returns the whole waveform. On a
single-process mesh the slices run one after another, each on its
position's device.

Correctness contract (the streaming one): with ``halo`` at least the
generator's receptive field, every sample inside a slice equals the full
pass's; the first and last ``halo`` frames of the whole sequence see
mel-space zero padding instead of the full pass's conv-level zero padding,
and may differ there (bounded by the tests).
"""

import torch

from tts_king_torch.parallel.comm import all_gather


def vocoder_time_sharded(generator, mel, mesh, halo_frames: int,
                         upsample: int, axis: str = "dp"):
    """Vocode one long utterance with its time axis split over
    ``mesh``'s ``axis``.

    generator: (1, t, M) mel -> (1, t * upsample) waveform (a module or a
        function of the tensor);
    mel: (1, T, M) tensor;
    halo_frames: the one-sided halo, at least the generator's receptive
        field (pipeline.Vocoder.halo_frames);
    upsample: the total upsampling (the product of upsample_rates).

    Returns the (1, T * upsample) waveform on ``mel``'s device.
    """
    n = mesh.shape[axis]
    B, T, M = mel.shape
    if B != 1:
        raise ValueError("time sharding is for a single long utterance")
    Tp = -(-T // n) * n    # T padded to a multiple of n with zero frames
    h = int(halo_frames)
    if Tp // n < h:
        raise ValueError(
            f"per-device slice {Tp // n} frames < halo {h}; the utterance "
            f"is too short to time-shard {n} ways — use the plain vocoder")
    t = Tp // n
    if mesh.local:
        # every slice's window straight out of the zero-padded sequence
        padded = torch.nn.functional.pad(mel, (0, 0, h, Tp - T + h))
        devices = mesh.dp_devices() if axis == "dp" else mesh.devices
        parts = []
        for i in range(n):
            gen = (mesh.replica(generator, devices[i])
                   if isinstance(generator, torch.nn.Module) else generator)
            window = padded[:, i * t:(i + 1) * t + 2 * h].to(devices[i])
            parts.append(gen(window)[:, h * upsample:-h * upsample]
                         .to(mel.device))
        return torch.cat(parts, dim=1)[:, :T * upsample]

    ax = mesh.axis(axis)
    full = torch.nn.functional.pad(mel, (0, 0, 0, Tp - T))
    local = full[:, ax.index * t:(ax.index + 1) * t]
    # every rank's first and last h frames; a neighbour's are its halo
    edges = all_gather(torch.cat([local[:, :h], local[:, -h:]], dim=1), ax)
    zeros = local.new_zeros((1, h, M))
    left = edges[ax.index - 1][:, h:] if ax.index > 0 else zeros
    right = edges[ax.index + 1][:, :h] if ax.index < n - 1 else zeros
    window = torch.cat([left, local, right], dim=1)
    centre = generator(window)[:, h * upsample:-h * upsample].contiguous()
    return torch.cat(all_gather(centre, ax), dim=1)[:, :T * upsample]
