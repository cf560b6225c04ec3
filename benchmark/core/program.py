"""The system under test, built from a configuration file: tts_king_torch's
AcousticModel and Vocoder with the benchmark's seeded weights.

This is the one module of the harness that imports the program; the
reference (benchmark/reference/) never does.
"""

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def tts_config(cfg):
    """tts_king_torch's TTSConfig for a configuration file's dict."""
    from tts_king_torch.config import (ModelConfig, TransformerConfig,
                                       TTSConfig, VarianceEmbeddingConfig,
                                       VariancePredictorConfig,
                                       VocoderModelConfig)

    m, v = cfg["model"], cfg["vocoder"]
    t = dict(m["transformer"])
    t["conv_kernel_size"] = tuple(t["conv_kernel_size"])
    t["variance_hidden"] = t["encoder_hidden"]
    vocoder = {k: v[k] for k in ("upsample_rates", "num_mels",
                                 "max_wav_value") if k in v}
    vocoder["sampling_rate"] = v["sampling_rate"]
    vocoder["hop_size"] = v["hop_size"]
    for k in ("upsample_kernel_sizes", "upsample_initial_channel", "resblock",
              "resblock_kernel_sizes", "resblock_dilation_sizes"):
        if k in v:
            vocoder[k] = v[k]
    out = TTSConfig(
        model=ModelConfig(
            transformer=TransformerConfig(**t),
            variance_predictor=VariancePredictorConfig(
                **m["variance_predictor"]),
            variance_embedding=VarianceEmbeddingConfig(
                **m["variance_embedding"]),
            max_seq_len=m["max_seq_len"], postnet_dim=m["postnet_dim"],
            multi_speaker=m["multi_speaker"],
            vocoder_model=m["vocoder_model"]),
        vocoder=VocoderModelConfig(**vocoder))
    out.preprocess.stft.hop_length = v["hop_size"]
    out.preprocess.audio.sampling_rate = v["sampling_rate"]
    return out


def meta_modules(cfg):
    """The program's FastSpeech2 and vocoder generator on the meta device
    (shapes only), for the seeded weights."""
    from tts_king_torch.models.fs2 import build_fastspeech2
    from tts_king_torch.models.hifigan import Generator
    from tts_king_torch.models.melgan import MelGANGenerator

    tc = tts_config(cfg)
    with torch.device("meta"):
        fs2 = build_fastspeech2(tc.model, cfg["assumed"]["stats"],
                                cfg["model"]["n_speakers"])
        if cfg["model"]["vocoder_model"] == "MelGAN":
            v = cfg["vocoder"]
            if (v["ngf"], v["n_residual_layers"]) != (32, 3):
                raise ValueError("the port's MelGAN is ngf 32 with 3 "
                                 "residual layers")
            voc = MelGANGenerator(mel_channels=v["num_mels"],
                                  ratios=tuple(v["upsample_rates"]))
        else:
            voc = Generator(tc.vocoder)
    if fs2.encoder.src_word_emb.num_embeddings != cfg["model"]["n_symbols"]:
        raise ValueError("the configuration's n_symbols is not the "
                         "program's phoneme vocabulary")
    return fs2, voc


def make_weights(cfg, precision, seed, device, calibration):
    """The run's weights, made on ``device`` from ``seed``: FastSpeech2's in
    float32 (the program rounds them itself where the precision says so),
    the vocoder's in the dtype it is served in. ``calibration``: sentences
    ((phonemes, length) pairs) over which the duration head is centred
    (weights.speech_like_durations), its inputs worked out by the plain
    reference."""
    from benchmark.core.weights import seeded_state_dict, speech_like_durations
    from benchmark.reference import fs2 as reference

    fs2, voc = meta_modules(cfg)
    p = cfg["precisions"][precision]
    acoustic = seeded_state_dict(fs2, seed, device, torch.float32)
    rounded = reference.round_variables(acoustic, p["acoustic_variables"])
    with torch.no_grad():
        features = torch.cat([reference.duration_features(
            rounded, cfg["model"], torch.as_tensor(ph, device=device), n)
            for ph, n in calibration])
    acoustic = speech_like_durations(
        acoustic, features,
        stored=lambda t: reference.stored(t, p["acoustic_variables"]))
    vocoder = seeded_state_dict(voc, seed + 1, device,
                                DTYPES[p["vocoder"]])
    return acoustic, vocoder


def build(cfg, precision, weights, device):
    """The program's AcousticModel and Vocoder for ``precision``."""
    from tts_king_torch.pipeline import AcousticModel, Vocoder

    p = cfg["precisions"][precision]
    if p["acoustic_compute"] != "float32":
        raise ValueError("the program computes FastSpeech2 in float32")
    tc = tts_config(cfg)
    acoustic = AcousticModel(tc, variables=weights[0],
                             n_speakers=cfg["model"]["n_speakers"],
                             stats=cfg["assumed"]["stats"],
                             dtype=DTYPES[p["acoustic_variables"]],
                             device=device)
    vocoder = Vocoder(tc, variables=weights[1], dtype=DTYPES[p["vocoder"]],
                      device=device)
    return acoustic, vocoder


def hop(cfg):
    return cfg["vocoder"]["hop_size"]


def audio_seconds(cfg, frames):
    return frames * hop(cfg) / cfg["vocoder"]["sampling_rate"]

