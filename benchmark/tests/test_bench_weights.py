"""The seeded weights do not move: each configuration's draw at seed 5, at
the tests' widths and at the published ones, hashes to what
``tests/frozen/<config>.json`` holds. A configuration added to
BENCHMARK.json adds its own file. And a family's weight rule sets its
tensor alone: every other tensor keeps the draw it has without the rule."""

import hashlib
import json
import os

import pytest
import torch

from benchmark.core import env, harness, program, weights
from benchmark.tests import micro

CPU = torch.device("cpu")


def sha256(state_dict):
    """Of each tensor in order: its key, dtype, shape and bytes."""
    h = hashlib.sha256()
    for key, t in state_dict.items():
        h.update(key.encode())
        h.update(str(t.dtype).encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(t.contiguous().reshape(-1).view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()


def frozen(name):
    path = os.path.join(env.BENCH_DIR, "tests", "frozen", f"{name}.json")
    assert os.path.isfile(path), (
        f"no {path}: a configuration's seeded weights are frozen there")
    with open(path) as f:
        return json.load(f)


def widths(name, which):
    if which == "micro":
        return micro.config(name)
    return harness.load_json("configs", f"{name}.json")


@pytest.mark.parametrize("which", ["micro", "published"])
@pytest.mark.parametrize("name", micro.configs())
def test_seeded_weights_are_frozen(name, which):
    cfg = widths(name, which)
    want = frozen(name)["weights_sha256"][which]
    assert sorted(want) == sorted(cfg["precisions"])
    for precision, hashes in want.items():
        acoustic, vocoder = program.seeded_weights(cfg, precision, 5, CPU)
        assert sha256(acoustic) == hashes["acoustic"], precision
        assert sha256(vocoder) == hashes["vocoder"], precision


def test_a_rule_sets_its_tensor_alone():
    with torch.device("meta"):
        module = torch.nn.Sequential(torch.nn.Conv1d(4, 8, 3),
                                     torch.nn.LayerNorm(8),
                                     torch.nn.Conv1d(8, 2, 1))
    plain = weights.seeded_state_dict(module, 3, CPU)
    ruled = weights.seeded_state_dict(
        module, 3, CPU, rules={r"0\.bias": lambda z: z,
                               r"2\..*": lambda z: torch.zeros_like(z)})
    assert plain.keys() == ruled.keys()
    for key in plain:
        if key == "0.bias":       # the general rule: 0.02 x its draw
            assert torch.equal(0.02 * ruled[key], plain[key])
        elif key.startswith("2."):
            assert not ruled[key].any()
        else:
            assert torch.equal(ruled[key], plain[key]), key
