"""The system under test, built from a configuration file: tts_king_torch's
AcousticModel and Vocoder with the benchmark's seeded weights.

The vocoder is the configuration's family's (model.vocoder_model, named as
benchmark/reference/vocoders.family names it): its program side is
``benchmark/programs/<family>.py``, which gives
  PROGRAM_NAME          the name tts_king_torch's TTSConfig gives the vocoder;
  vocoder_config(v)     tts_king_torch's VocoderModelConfig fields for the
                        configuration's ``vocoder`` dict, having checked that
                        the port supports its widths;
  generator(tc, v)      the port's generator for TTSConfig ``tc`` (built on
                        the meta device, for the weights' shapes).
This module and those files are the harness's only code that imports the
program; the reference (benchmark/reference/) never does.
"""

import importlib

import torch

from benchmark.reference import vocoders

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def family(cfg):
    """The program side of the configuration's vocoder family."""
    return importlib.import_module(
        f"benchmark.programs.{vocoders.family(cfg['model']['vocoder_model'])}")


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
    voc = family(cfg)
    out = TTSConfig(
        model=ModelConfig(
            transformer=TransformerConfig(**t),
            variance_predictor=VariancePredictorConfig(
                **m["variance_predictor"]),
            variance_embedding=VarianceEmbeddingConfig(
                **m["variance_embedding"]),
            max_seq_len=m["max_seq_len"], postnet_dim=m["postnet_dim"],
            multi_speaker=m["multi_speaker"],
            vocoder_model=voc.PROGRAM_NAME),
        vocoder=VocoderModelConfig(**voc.vocoder_config(v)))
    out.preprocess.stft.hop_length = v["hop_size"]
    out.preprocess.audio.sampling_rate = v["sampling_rate"]
    return out


def meta_modules(cfg):
    """The program's FastSpeech2 and vocoder generator on the meta device
    (shapes only), for the seeded weights."""
    from tts_king_torch.models.fs2 import build_fastspeech2

    tc = tts_config(cfg)
    with torch.device("meta"):
        fs2 = build_fastspeech2(tc.model, cfg["assumed"]["stats"],
                                cfg["model"]["n_speakers"])
        voc = family(cfg).generator(tc, cfg["vocoder"])
    if fs2.encoder.src_word_emb.num_embeddings != cfg["model"]["n_symbols"]:
        raise ValueError("the configuration's n_symbols is not the "
                         "program's phoneme vocabulary")
    return fs2, voc


def seeded_weights(cfg, precision, seed, device):
    """The run's weights as drawn from ``seed`` on ``device``: FastSpeech2's
    in float32, the vocoder's in the dtype it is served in, under its
    family's weight rules."""
    from benchmark.core.weights import seeded_state_dict

    fs2, voc = meta_modules(cfg)
    rules = getattr(vocoders.find(cfg["model"]["vocoder_model"]),
                    "WEIGHT_RULES", None)
    p = cfg["precisions"][precision]
    return (seeded_state_dict(fs2, seed, device, torch.float32),
            seeded_state_dict(voc, seed + 1, device, DTYPES[p["vocoder"]],
                              rules=rules))


def make_weights(cfg, precision, seed, device, calibration):
    """The run's weights, made on ``device`` from ``seed``: FastSpeech2's in
    float32 (the program rounds them itself where the precision says so),
    the vocoder's in the dtype it is served in. ``calibration``: sentences
    ((phonemes, length) pairs) over which the duration head is centred
    (weights.speech_like_durations), its inputs worked out by the plain
    reference."""
    from benchmark.core.weights import speech_like_durations
    from benchmark.reference import fs2 as reference

    p = cfg["precisions"][precision]
    acoustic, vocoder = seeded_weights(cfg, precision, seed, device)
    rounded = reference.round_variables(acoustic, p["acoustic_variables"])
    with torch.no_grad():
        features = torch.cat([reference.duration_features(
            rounded, cfg["model"], torch.as_tensor(ph, device=device), n)
            for ph, n in calibration])
    acoustic = speech_like_durations(
        acoustic, features,
        stored=lambda t: reference.stored(t, p["acoustic_variables"]))
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

