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

On a mesh (parallel/mesh.py) the file is the same: every tp line gathers
its split parameters and Adam moments, rank 0 writes the full state, and
every rank waits for the file; a restore reads the full state on every
rank and slices it by the rules. So a run saved at dp=2 or tp=2 resumes on
one process, and the other way round.
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


def _write(path: str, step: int, payload):
    out = ckpt_dir(path, step)
    os.makedirs(out, exist_ok=True)
    tmp = os.path.join(out, f"{STATE_FILE}.{os.getpid()}.tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(out, STATE_FILE))


def _adam_payload(opt: AdamState):
    return {"count": opt.count, "mu": _cpu(opt.mu), "nu": _cpu(opt.nu)}


def _adam_state(payload, device) -> AdamState:
    return AdamState(int(payload["count"]),
                     {k: v.to(device) for k, v in payload["mu"].items()},
                     {k: v.to(device) for k, v in payload["nu"].items()})


def save_train_state(path: str, step: int, state: TrainState, mesh=None):
    """Write ``state`` at ``step``; on a ``mesh`` every rank calls this and
    rank 0 writes the gathered full state."""
    sd = state.model.state_dict()
    opt = state.opt_state
    if mesh is not None:
        from tts_king_torch.parallel.lockstep import coordination_barrier
        from tts_king_torch.parallel.mesh import unshard_state_dict

        sd = unshard_state_dict(sd, mesh)
        opt = AdamState(opt.count, unshard_state_dict(opt.mu, mesh),
                        unshard_state_dict(opt.nu, mesh))
    if mesh is None or mesh.rank == 0:
        sd = _cpu(sd)
        speaker_emb = {k: sd.pop(k) for k in list(sd)
                       if k.startswith(_SPEAKER_PREFIX)}
        _write(path, step, {
            "model": sd,
            "speaker_emb": speaker_emb,
            "opt_state": _adam_payload(opt),
            "step": int(step),
        })
    if mesh is not None:
        coordination_barrier(f"save:{os.path.abspath(path)}:{step}")


def save_vocoder_state(path: str, step: int, state, params):
    """A GAN train state (train/vocoder.VocoderTrainState) and ``params``,
    the folded inference Generator's state dict."""
    _write(path, step, {
        "params": _cpu(params),
        "gan_state": {"gen": _cpu(state.gen.state_dict()),
                      "disc": _cpu(state.disc.state_dict()),
                      "gen_opt": _adam_payload(state.gen_opt),
                      "disc_opt": _adam_payload(state.disc_opt),
                      "step": int(state.step)},
        "step": int(step),
    })


def _read(path: str, step: Optional[int]):
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
    return torch.load(f, map_location="cpu", weights_only=True)


def restore_vocoder_state(path: str, step: Optional[int] = None):
    """The payload of one GAN checkpoint (the latest if ``step`` is
    None)."""
    return _read(path, step)


def load_vocoder_state(state, payload):
    """Copy a restored GAN payload into ``state`` (on its models'
    device)."""
    gan = payload["gan_state"]
    state.gen.load_state_dict(gan["gen"], strict=True)
    state.disc.load_state_dict(gan["disc"], strict=True)
    device = next(state.gen.parameters()).device
    state.gen_opt = _adam_state(gan["gen_opt"], device)
    state.disc_opt = _adam_state(gan["disc_opt"], device)
    state.step = int(gan["step"])
    return state


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
    payload = _read(path, step)
    payload["model"] = {**payload["model"], **payload["speaker_emb"]}
    return payload


def load_train_state(state: TrainState, payload, mesh=None) -> TrainState:
    """Copy a restored payload into ``state`` (on the model's device), this
    rank's slice of it on a ``mesh``."""
    model_sd, opt = payload["model"], payload["opt_state"]
    if mesh is not None:
        from tts_king_torch.parallel.mesh import shard_state_dict

        model_sd = shard_state_dict(model_sd, mesh)
        opt = {"count": opt["count"],
               "mu": shard_state_dict(opt["mu"], mesh),
               "nu": shard_state_dict(opt["nu"], mesh)}
    state.model.load_state_dict(model_sd, strict=True)
    device = next(state.model.parameters()).device
    state.opt_state = _adam_state(opt, device)
    state.step = int(payload["step"])
    return state
