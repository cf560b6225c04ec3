#!/usr/bin/env python
"""Export goldens of the JAX package's feature pipeline and FastSpeech2 CWT
branch, which the PyTorch port replays without JAX.

Writes three files under tests/fixtures/torch_port/:

  * golden_cwt_features.npz: the feature tree that the JAX Preprocessor
    (YIN backend) writes for a seeded generate_corpus of 2 speakers x 3
    utterances at the shipped preprocessing config: every file as
    ``tree::<relative path>`` (arrays as they are, .txt and .json files as
    text), and ``meta::corpus`` (the generate_corpus arguments, JSON);
  * golden_cwt_fs2.npz: a micro-width CWT FastSpeech2's seeded variables
    (``var::...``), a B = 3 batch of lengths 10 / 7 / 4 (``in::...``) and
    its eval forward's outputs (``out::...``), ``meta::config`` (the model
    config and max_mel_len);
  * golden_cwt_train_step.npz: two make_train_step(use_cwt=True) steps of
    that model at acc = 2 with every dropout intercepted to the identity:
    the initial variables, the two superbatches and the two steps' mean
    losses with a leading step axis (``in::<key>``, ``out::loss::<name>``),
    the state after the second step (``var::out_params::...``,
    ``var::out_batch_stats::...``, ``var::out_mu::...``,
    ``var::out_nu::...``), the Adam count, and ``meta::config`` (model,
    optimizer, steps: 2).

The port replays them in tests/test_torch_features.py and
tests/test_torch_cwt.py on the CPU and in chip_smoke.py on the card. Runs
with JAX on the CPU (about a minute):

  JAX_PLATFORMS=cpu python scripts/export_cwt_features_golden.py
"""

import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the repo root in place of scripts/, whose profile.py would shadow the
# standard library's profile module that torch imports
sys.path[0] = REPO

import numpy as np

OUT_DIR = os.path.join(REPO, "tests", "fixtures", "torch_port")
CORPUS = {"n_speakers": 2, "utts_per_speaker": 3, "seed": 0}


def export_features():
    from chip_smoke import GOLDEN_FEATURES, feature_tree
    from tts_king_tpu.config import TTSConfig
    from tts_king_tpu.data.features import Preprocessor
    from tts_king_tpu.data.synthetic import generate_corpus

    cfg = TTSConfig()
    with tempfile.TemporaryDirectory() as tmp:
        cfg.preprocess.raw_path = os.path.join(tmp, "raw")
        cfg.preprocess.preprocessed_path = os.path.join(tmp, "processed")
        generate_corpus(cfg.preprocess.raw_path, **CORPUS)
        Preprocessor(cfg.preprocess, pitch_backend="yin").build_from_path(
            seed=cfg.train.seed)
        tree = feature_tree(cfg.preprocess.preprocessed_path)
    flat = {f"tree::{k}": np.asarray(v) for k, v in tree.items()}
    flat["meta::corpus"] = np.asarray(json.dumps(CORPUS))
    np.savez_compressed(GOLDEN_FEATURES, **flat)
    return GOLDEN_FEATURES


def export_fs2():
    from chip_smoke import GOLDEN_CWT_FS2
    from scripts.export_flax_variables import flatten_variables
    from scripts.export_train_step_golden import GOLDEN_MODEL
    from tests.test_torch_cwt import cwt_inputs, cwt_variables, jax_forward

    model = dict(GOLDEN_MODEL, use_cwt=True)
    variables = cwt_variables(model, seed=9)
    speakers, texts, src_lens = cwt_inputs(seed=10)
    max_mel_len = 64
    out = jax_forward(model, variables, speakers, texts, src_lens,
                      max_mel_len)
    flat = flatten_variables(variables)
    flat.update({"in::speakers": speakers, "in::texts": texts,
                 "in::src_lens": src_lens})
    flat.update({f"out::{k}": v for k, v in out.items()
                 if k in ("pitch_prediction", "log_duration_prediction",
                          "pitch_mean", "pitch_std", "mel_lens", "mel")})
    flat["meta::config"] = np.asarray(json.dumps(
        {"model": model, "max_mel_len": max_mel_len}))
    np.savez_compressed(GOLDEN_CWT_FS2, **flat)
    return GOLDEN_CWT_FS2


def export_train_step():
    from chip_smoke import GOLDEN_CWT_TRAIN
    from scripts.export_flax_variables import flatten_variables
    from scripts.export_train_step_golden import GOLDEN_MODEL, GOLDEN_OPT
    from tests.test_torch_train import (jax_train, seeded_variables,
                                        synthetic_superbatch)

    model = dict(GOLDEN_MODEL, use_cwt=True)
    variables = seeded_variables(model, seed=11)
    sbs = [synthetic_superbatch(2, 3, 8, 24, seed=s) for s in (12, 13)]
    res = jax_train(model, GOLDEN_OPT, variables, sbs)
    flat = flatten_variables(variables)
    flat.update({f"in::{k}": np.stack([sb[k] for sb in sbs])
                 for k in sbs[0]})
    flat.update({f"out::loss::{k}": np.stack(
        [np.asarray(r["losses"][k]) for r in res]) for k in res[0]["losses"]})
    flat.update(flatten_variables(
        {f"out_{coll}": res[-1][coll]
         for coll in ("params", "batch_stats", "mu", "nu")}))
    flat["out::count"] = np.asarray(res[-1]["count"])
    flat["meta::config"] = np.asarray(json.dumps(
        {"model": model, "optimizer": GOLDEN_OPT, "steps": len(sbs)}))
    np.savez_compressed(GOLDEN_CWT_TRAIN, **flat)
    return GOLDEN_CWT_TRAIN


def main():
    os.makedirs(OUT_DIR, exist_ok=True)
    for export in (export_features, export_fs2, export_train_step):
        path = export()
        print(f"{path}: {os.path.getsize(path)} bytes")


if __name__ == "__main__":
    main()
