"""A small configuration and traffic of the bulk cells for the CPU tests:
each configuration's FastSpeech2 at tiny widths (tts_king_torch.config.
micro_config's widths) and its vocoder at its family's ``MICRO`` widths
(benchmark/reference/<family>.py), sentences of 6-40 phonemes in batches
of 4. Cells and configurations are those of BENCHMARK.json."""

import json
import os

from benchmark.core import env, harness
from benchmark.reference import vocoders


def configs(family=None):
    """BENCHMARK.json's configuration names, in its order; with ``family``,
    those whose vocoder is of that family."""
    return [c["name"] for c in harness.manifest()["configs"]
            if family is None or vocoders.family(
                _load(c["name"])["model"]["vocoder_model"]) == family]


def cells():
    """BENCHMARK.json's cells, in its order, as {name: configuration}."""
    return {w["name"]: w["config"] for w in harness.manifest()["workloads"]}


def _load(name):
    with open(os.path.join(env.BENCH_DIR, "configs", f"{name}.json")) as f:
        return json.load(f)


def config(name=None):
    """Configuration ``name`` (default: BENCHMARK.json's first) at the
    tests' widths."""
    cfg = _load(name or harness.manifest()["configs"][0]["name"])
    cfg["model"]["transformer"].update(
        encoder_layer=1, encoder_hidden=16, decoder_layer=1,
        decoder_hidden=16, conv_filter_size=32)
    cfg["model"]["variance_predictor"]["filter_size"] = 16
    cfg["model"]["max_seq_len"] = 256
    cfg["vocoder"].update(vocoders.find(cfg["model"]["vocoder_model"]).MICRO)
    return cfg


def config_file(tmp_path, name=None):
    cfg = config(name)
    path = tmp_path / f"micro_{name or 'first'}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


TRAFFIC = {"batch": 4, "pool": 64, "check_sentences": 3,
           "phonemes": {"dist": "lognormal", "median": 20, "sigma": 0.4,
                        "min": 6, "max": 40}}

def calibration(n=3, seed=0):
    """A few sentences to centre the duration head over."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [(rng.integers(1, 207, k), k) for k in (12, 20, 31)[:n]]
