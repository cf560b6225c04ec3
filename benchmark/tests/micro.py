"""A small configuration and traffic of the bulk cells for the CPU tests:
the shipped architecture at tiny widths (tts_king_torch.config.micro_config's
widths), sentences of 6-40 phonemes in batches of 4."""

import json
import os

from benchmark.core.env import BENCH_DIR


def config(name="fs2_hifigan_v1"):
    with open(os.path.join(BENCH_DIR, "configs", f"{name}.json")) as f:
        cfg = json.load(f)
    cfg["model"]["transformer"].update(
        encoder_layer=1, encoder_hidden=16, decoder_layer=1,
        decoder_hidden=16, conv_filter_size=32)
    cfg["model"]["variance_predictor"]["filter_size"] = 16
    cfg["model"]["max_seq_len"] = 256
    if cfg["model"]["vocoder_model"] == "HiFi-GAN":
        cfg["vocoder"].update(upsample_initial_channel=16,
                              resblock_kernel_sizes=[3],
                              resblock_dilation_sizes=[[1, 3, 5]])
    return cfg


def config_file(tmp_path, name="fs2_hifigan_v1"):
    path = tmp_path / f"micro_{name}.json"
    path.write_text(json.dumps(config(name)))
    return str(path)


TRAFFIC = {"batch": 4, "pool": 64, "check_sentences": 3,
           "phonemes": {"dist": "lognormal", "median": 20, "sigma": 0.4,
                        "min": 6, "max": 40}}

def calibration(n=3, seed=0):
    """A few sentences to centre the duration head over."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [(rng.integers(1, 207, k), k) for k in (12, 20, 31)[:n]]
