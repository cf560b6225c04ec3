"""End-to-end usage walkthrough of the port (examples/basic_usage.py's
counterpart): a config, the speakers, text -> mel with prosody controls,
mel -> wav, and batch synthesis through the dynamic-batching server.

Runs with seeded random weights where the config names no checkpoints:

    python -m tts_king_torch.examples.basic_usage [--micro] [--device cpu]

``--micro`` takes toy model sizes (seconds on the CPU; the same flow).
"""

import argparse
import os

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def example_config(micro, path=None):
    """micro_config(), the YAML at ``path`` (default: the repo's
    config.yaml) or the shipped defaults."""
    from tts_king_torch.config import TTSConfig, load_config, micro_config

    if micro:
        return micro_config()
    path = path or os.path.join(REPO, "config.yaml")
    return load_config(path) if os.path.exists(path) else TTSConfig()


def has_weights(cfg):
    return bool(cfg.acoustic.weights_path
                and os.path.exists(cfg.acoustic.weights_path))


def example_king(cfg, device, n_speakers=1):
    """TTSKing of ``cfg``; with seeded random weights it has ``n_speakers``
    speakers (the port refuses an id outside the table, where the JAX
    package clamps it)."""
    from tts_king_torch.pipeline import TTSKing

    return TTSKing(cfg, device=device,
                   n_speakers=None if has_weights(cfg) else n_speakers)


def bias_durations(king, bias=1.5):
    """Untrained weights predict next to no frames; a duration head bias of
    1.5 gives each phoneme about 3.5 frames."""
    with torch.no_grad():
        king.tts.model.variance_adaptor.duration_predictor.linear_layer \
            .bias.fill_(bias)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m tts_king_torch.examples.basic_usage")
    ap.add_argument("--micro", action="store_true",
                    help="toy model sizes (fast on the CPU; same flow)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from tts_king_torch.serve import SynthesisServer
    from tts_king_torch.text import text_to_sequence

    cfg = example_config(args.micro)
    king = example_king(cfg, args.device, n_speakers=2)  # the batch's two
    if args.micro:
        bias_durations(king)
    print(f"speakers ({len(king.speakers)}):", king.speakers[:5], "...")

    # --- phoneme-level input (no G2P needed) --------------------------
    phonemes = np.array([text_to_sequence("{P R I0 V E0 T sp M I0 R}", [])])
    out = king.tts.generate(phonemes, duration_control=1.0,
                            pitch_control=1.0, energy_control=1.0,
                            speaker_name=0)
    n = int(out["mel_lens"][0])
    print(f"mel: {tuple(out['postnet_mel'].shape)} ({n} valid frames)")

    # --- prosody control knobs ----------------------------------------
    slow = king.tts.generate(phonemes, duration_control=1.3, speaker_name=0)
    print("slow speech frames:", int(slow["mel_lens"][0]))

    # --- mel -> waveform ----------------------------------------------
    wavs = king.mel_to_wav(out["postnet_mel"], out["mel_lens"])
    sr = cfg.preprocess.audio.sampling_rate
    print(f"wav: {len(wavs[0])} samples ({len(wavs[0]) / sr:.2f}s, int16)")

    # --- batched serving ----------------------------------------------
    server = SynthesisServer(king, max_batch=4, max_wait_ms=20)
    try:
        futures = [server.submit(phonemes=phonemes[0], speaker=i % 2)
                   for i in range(3)]
        results = [f.result(timeout=300) for f in futures]
        print("served", len(results), "requests in batches")
    finally:
        server.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
