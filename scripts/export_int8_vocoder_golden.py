#!/usr/bin/env python
"""Export the int8 vocoder golden: the JAX Generator with
``mrf_backend="fused_int8"`` (the Pallas MRF kernel in int8 mode, run in
interpret mode on the CPU) and with ``mrf_backend="xla"`` (f32, unquantized)
on one seeded mel, so that the PyTorch port can be held to the JAX int8
waveform without JAX.

The model is the tiny config of tests/test_pallas_mrf_packed.py (upsample
4 x 4, 32 initial channels: MRF stages of 16 and 8 channels, both packed
r = 8 and fused), its weights N(0, 0.05^2) as that test rescales them. The
mel is B = 2, T_mel = 600, so stage 1 (C = 8, r = 8, 1200 packed rows) spans
two 1024-row tile windows, the second partial, and stage 0 (300 packed rows)
one padded window.

Keys: ``var::params::...`` (the weights, tts_king_torch.weights.load_flax_npz
naming), ``meta::config`` (the VocoderModelConfig fields as JSON),
``in::mel``, ``out::wav_int8`` and ``out::wav_f32``.

    JAX_PLATFORMS=cpu python scripts/export_int8_vocoder_golden.py
"""

import argparse
import dataclasses
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np

from scripts.export_flax_variables import flatten_variables

OUT = os.path.join(REPO, "tests", "fixtures", "torch_port",
                   "golden_int8_vocoder.npz")
B, T_MEL = 2, 600


def tiny_config():
    from tts_king_tpu.config import VocoderModelConfig

    return VocoderModelConfig(upsample_rates=[4, 4],
                              upsample_kernel_sizes=[8, 8],
                              upsample_initial_channel=32)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from tts_king_tpu.models.hifigan import Generator

    cfg = tiny_config()
    rng = np.random.RandomState(1)
    mel = rng.randn(B, T_MEL, 80).astype(np.float32)
    shapes = jax.eval_shape(lambda: Generator(cfg).init(
        jax.random.PRNGKey(0), jnp.asarray(mel[:, :16])))["params"]
    params = jax.tree.map(
        lambda s: (rng.randn(*s.shape) * 0.05).astype(np.float32), shapes)
    out = {}
    for backend, key in (("fused_int8", "wav_int8"), ("xla", "wav_f32")):
        t0 = time.perf_counter()
        wav = Generator(cfg, mrf_backend=backend).apply(
            {"params": params}, jnp.asarray(mel))
        out[f"out::{key}"] = np.asarray(wav, np.float32)
        print(f"{backend}: {time.perf_counter() - t0:.1f} s", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(
        args.out, **flatten_variables({"params": params}), **out,
        **{"in::mel": mel,
           "meta::config": np.asarray(json.dumps(dataclasses.asdict(cfg)))})
    print(f"{args.out}: {os.path.getsize(args.out)} bytes")


if __name__ == "__main__":
    main()
