#!/usr/bin/env python
"""Export flax variables to flat ``.npz`` files that the PyTorch port reads
without JAX (tts_king_torch.weights.load_flax_npz).

Keys are ``var::<collection>::a/b/c``, the naming of the committed golden
fixtures. With no arguments it writes the golden_e2e fixture's weights to
tests/fixtures/torch_port/:

  * golden_e2e_variables.npz — the trained FastSpeech2 orbax checkpoint
    (tests/fixtures/golden_e2e/ckpt), restored through
    tts_king_tpu.checkpoint.restore_train_state, params + batch_stats, as
    tts_king_tpu.pipeline.AcousticModel loads it;
  * golden_e2e_vocoder_variables.npz — the HiFi-GAN variables the JAX
    TTSKing builds for that config (seeded init, PRNGKey(0)).

Runs with JAX on the CPU:

  JAX_PLATFORMS=cpu python scripts/export_flax_variables.py
  JAX_PLATFORMS=cpu python scripts/export_flax_variables.py \\
      --ckpt path/to/ckpt_dir --out fs2.npz      # any FS2 orbax checkpoint
"""

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np

OUT_DIR = os.path.join(REPO, "tests", "fixtures", "torch_port")


def flatten_variables(variables):
    """{collection: nested tree} -> {"var::collection::a/b/c": ndarray}."""
    flat = {}

    def walk(coll, node, prefix):
        for key, value in node.items():
            path = f"{prefix}/{key}" if prefix else str(key)
            if hasattr(value, "items"):
                walk(coll, value, path)
            else:
                flat[f"var::{coll}::{path}"] = np.asarray(value)

    for coll, tree in variables.items():
        walk(coll, tree, "")
    return flat


def fs2_checkpoint_variables(ckpt_dir):
    """The variables AcousticModel restores from an orbax directory."""
    from tts_king_tpu.checkpoint import restore_train_state

    payload = restore_train_state(ckpt_dir)
    return {"params": payload["params"], "batch_stats": payload["batch_stats"]}


def golden_e2e_vocoder_variables():
    """The Generator variables of the JAX TTSKing for the golden_e2e config."""
    from tests.test_golden_e2e import micro_config
    from tts_king_tpu.pipeline import Vocoder

    return Vocoder(micro_config()).variables


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", default=os.path.join(
        REPO, "tests", "fixtures", "golden_e2e", "ckpt"),
        help="FastSpeech2 orbax checkpoint directory")
    ap.add_argument("--out", default=os.path.join(
        OUT_DIR, "golden_e2e_variables.npz"))
    ap.add_argument("--vocoder-out", default=os.path.join(
        OUT_DIR, "golden_e2e_vocoder_variables.npz"),
        help="where to write the golden_e2e vocoder variables ('' to skip)")
    args = ap.parse_args(argv)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    flat = flatten_variables(fs2_checkpoint_variables(args.ckpt))
    np.savez_compressed(args.out, **flat)
    print(f"{args.out}: {len(flat)} arrays")
    if args.vocoder_out:
        flat = flatten_variables(golden_e2e_vocoder_variables())
        np.savez_compressed(args.vocoder_out, **flat)
        print(f"{args.vocoder_out}: {len(flat)} arrays")


if __name__ == "__main__":
    main()
