"""Train-state checkpoints of the port.

Counterpart of tts_king_tpu/checkpoint.py's save_train_state /
restore_train_state: one checkpoint per step under
``<ckpt_path>/step_%08d``, holding the parameters and BatchNorm buffers, the
Adam state, the step, and the speaker embedding under a key of its own (the
reference's convention, train.py:212-227, so a checkpoint can be moved
across speaker sets). The port writes it with ``torch.save`` as
``train_state.pt`` in that directory; orbax directories written by the JAX
package are not read (scripts/export_flax_variables.py exports their
weights to npz).
"""

import os
import re
from typing import Optional

import torch

from tts_king_torch.train.state import AdamState, TrainState

STATE_FILE = "train_state.pt"
_SPEAKER_PREFIX = "speaker_emb."


def ckpt_dir(path: str, step: int) -> str:
    return os.path.join(os.path.abspath(path), f"step_{step:08d}")


def _cpu(tree):
    return {k: v.detach().cpu() for k, v in tree.items()}


def save_train_state(path: str, step: int, state: TrainState):
    sd = _cpu(state.model.state_dict())
    speaker_emb = {k: sd.pop(k) for k in list(sd)
                   if k.startswith(_SPEAKER_PREFIX)}
    opt = state.opt_state
    payload = {
        "model": sd,
        "speaker_emb": speaker_emb,
        "opt_state": {"count": opt.count, "mu": _cpu(opt.mu),
                      "nu": _cpu(opt.nu)},
        "step": int(step),
    }
    out = ckpt_dir(path, step)
    os.makedirs(out, exist_ok=True)
    tmp = os.path.join(out, f"{STATE_FILE}.{os.getpid()}.tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(out, STATE_FILE))


def latest_step(path: str) -> int:
    steps = sorted(int(m.group(1)) for m in
                   (re.match(r"step_(\d+)$", d) for d in os.listdir(path))
                   if m)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {path}")
    return steps[-1]


def restore_train_state(path: str, step: Optional[int] = None):
    """The payload of one checkpoint (the latest if ``step`` is None), with
    the speaker embedding put back among the model's entries."""
    if step is None:
        step = latest_step(path)
    d = ckpt_dir(path, step)
    f = os.path.join(d, STATE_FILE)
    if not os.path.exists(f):
        if os.path.isdir(d):
            raise NotImplementedError(
                f"{d} holds no {STATE_FILE}: orbax checkpoints of the JAX "
                "package are not read by the port; export their weights "
                "with scripts/export_flax_variables.py")
        raise FileNotFoundError(f"no checkpoint for step {step} under {path}")
    payload = torch.load(f, map_location="cpu", weights_only=True)
    payload["model"] = {**payload["model"], **payload["speaker_emb"]}
    return payload


def load_train_state(state: TrainState, payload) -> TrainState:
    """Copy a restored payload into ``state`` (on the model's device)."""
    state.model.load_state_dict(payload["model"], strict=True)
    device = next(state.model.parameters()).device
    opt = payload["opt_state"]
    state.opt_state = AdamState(
        int(opt["count"]), {k: v.to(device) for k, v in opt["mu"].items()},
        {k: v.to(device) for k, v in opt["nu"].items()})
    state.step = int(payload["step"])
    return state
