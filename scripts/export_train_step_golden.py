#!/usr/bin/env python
"""Export one FastSpeech2 train step of the JAX package as a golden fixture
that the PyTorch port replays without JAX.

Writes tests/fixtures/torch_port/golden_train_step.npz: a tiny
FastSpeech2's seeded initial variables (``var::params::...``,
``var::batch_stats::...``), one acc = 2 superbatch (``in::<key>``), and what
tts_king_tpu.train.step.make_train_step makes of them with the default XLA
attention and every dropout intercepted to the identity: the mean losses
(``out::loss::<name>``), the new params and batch_stats and the Adam
moments as further collections (``var::out_params::...``,
``var::out_batch_stats::...``, ``var::out_mu::...``, ``var::out_nu::...``),
and the Adam count (``out::count``). ``meta::config`` holds the model and
optimizer configs as JSON; the optimizer has a weight decay, so the
decoupled-decay stage of the chain is on the path.

The port replays it with chip_smoke.replay_train_step_golden: on the CPU
in tests/test_torch_train.py, on the card in chip_smoke.py. Runs with JAX on the CPU:

  JAX_PLATFORMS=cpu python scripts/export_train_step_golden.py
"""

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the repo root in place of scripts/, whose profile.py would shadow the
# standard library's profile module that torch imports
sys.path[0] = REPO

import numpy as np

OUT = os.path.join(REPO, "tests", "fixtures", "torch_port",
                   "golden_train_step.npz")

GOLDEN_MODEL = {
    "transformer": {"encoder_layer": 1, "encoder_head": 2,
                    "encoder_hidden": 8, "variance_hidden": 8,
                    "decoder_layer": 1, "decoder_head": 2,
                    "decoder_hidden": 8, "conv_filter_size": 16,
                    "conv_kernel_size": [9, 1]},
    "variance_predictor": {"filter_size": 8},
    "variance_embedding": {"n_bins": 32},
    "max_seq_len": 32, "postnet_dim": 8}
# eps 1e-3 keeps Adam's update well conditioned in the gradients (see
# chip_smoke.compare_train_step); the weight decay puts the decoupled-decay
# stage on the path, at 3% of a step
GOLDEN_OPT = {"grad_acc_step": 2, "warm_up_step": 4, "weight_decay": 0.1,
              "eps": 1e-3}


def main():
    from scripts.export_flax_variables import flatten_variables
    from tests.test_torch_train import (jax_train, seeded_variables,
                                        synthetic_superbatch)

    variables = seeded_variables(GOLDEN_MODEL, seed=7)
    sb = synthetic_superbatch(2, 3, 8, 24, seed=8)
    (res,) = jax_train(GOLDEN_MODEL, GOLDEN_OPT, variables, [sb])

    flat = flatten_variables(variables)
    flat.update({f"in::{k}": v for k, v in sb.items()})
    flat.update({f"out::loss::{k}": np.asarray(v)
                 for k, v in res["losses"].items()})
    flat.update(flatten_variables(
        {f"out_{coll}": res[coll]
         for coll in ("params", "batch_stats", "mu", "nu")}))
    flat["out::count"] = np.asarray(res["count"])
    flat["meta::config"] = np.asarray(json.dumps(
        {"model": GOLDEN_MODEL, "optimizer": GOLDEN_OPT}))
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **flat)
    print(f"{OUT}: {len(flat)} arrays, {os.path.getsize(OUT)} bytes, "
          f"loss {float(res['losses']['total']):.6f}")


if __name__ == "__main__":
    main()
