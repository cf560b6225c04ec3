"""FastSpeech2 training and evaluation steps.

Port of tts_king_tpu/train/step.py. One optimizer step takes a superbatch
with a leading grad-accumulation axis, (acc, B, ...): each microbatch runs
forward and backward in training mode, the gradients are summed over the
microbatches and divided by acc (the reference's loss / grad_acc_step,
train.py:43), then clipped and applied (train/state.py). The BatchNorm
running stats are carried from one microbatch to the next, as the JAX
step's scan carry is. Dropout masks come from one generator per optimizer
step that the caller derives from (train.seed, step) (train/loop.py), drawn
by the microbatches in order. Whether the CWT pitch targets and loss apply
(the JAX steps' ``use_cwt``) is the model's own ``model_config.use_cwt``.

On a mesh (parallel/mesh.py; the model made this rank's part by
``shard_fs2``) the step computes the global batch's loss and gradients, as
the JAX step's one global program does: each rank's loss is its share of
the global loss (train/loss.py), the gradients are summed over dp, the
global norm for the clip adds each tp-split parameter's squares over tp and
counts each replicated one once, and Adam runs on each rank's slice. The
reported losses are the global ones on every rank.
"""

from typing import Any, Dict

import numpy as np
import torch

from tts_king_torch.parallel.comm import Axis, all_reduce, all_reduce_many
from tts_king_torch.train.loss import FS2Losses, fastspeech2_loss


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, Any]:
    """A numpy batch from data.dataset as tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def forward_loss(model, batch, generator=None, dp: Axis = Axis()):
    """Teacher-forced forward of one (B, ...) batch and its losses (this
    rank's shares under ``dp``, a mesh axis). A CWT model
    (``model_config.use_cwt``) takes no raw pitch targets and is held to
    the CWT targets (``pitches_cwt``, ``pitches_mean``, ``pitches_std``)."""
    use_cwt = model.model_config.use_cwt
    outputs = model(
        batch["speakers"], batch["texts"], batch["src_lens"],
        max_mel_len=int(batch["mels"].shape[1]), mel_lens=batch["mel_lens"],
        energy_targets=batch["energies"],
        duration_targets=batch["durations"],
        pitch_raw_targets=None if use_cwt else batch["pitches_raw"],
        generator=generator)
    return fastspeech2_loss(batch, outputs, use_cwt, dp)


def _grad_norm(grads, mesh):
    """The global norm of the gradient: each tp-split tensor's squares
    summed over tp, each replicated one counted once."""
    from tts_king_torch.parallel.mesh import FS2_TP_RULES, spec_for

    split = [g for n, g in grads.items() if spec_for(n, FS2_TP_RULES)
             is not None]
    whole = [g for n, g in grads.items() if spec_for(n, FS2_TP_RULES) is None]

    def squares(gs):
        if not gs:
            return next(iter(grads.values())).new_zeros(())
        return torch.stack(torch._foreach_norm(gs)).square().sum()

    return (all_reduce(squares(split), mesh.tp_axis)
            + squares(whole)).sqrt()


def make_train_step(optimizer, mesh=None):
    """Returns train_step(state, superbatch, generator) -> FS2Losses, the
    mean of each term over the microbatches (0-dim tensors on the device).
    ``superbatch`` holds (acc, B, ...) tensors on the model's device, this
    rank's rows of them on a ``mesh``; ``generator`` draws the global
    batch's dropout masks (the same on every rank)."""
    dp = mesh.dp_axis if mesh is not None else Axis()

    def train_step(state, superbatch, generator):
        model = state.model
        model.train()
        acc = int(superbatch["texts"].shape[0])
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        # a step that fails part-way leaves the running stats as they were
        stats = [b.clone() for b in model.buffers()]
        try:
            total = None
            for i in range(acc):
                losses = forward_loss(model, {k: v[i] for k, v in
                                              superbatch.items()}, generator,
                                      dp)
                losses.total.backward()
                stacked = torch.stack([t.detach() for t in losses])
                total = stacked if total is None else total + stacked
        except BaseException:
            with torch.no_grad():
                for b, s in zip(model.buffers(), stats):
                    b.copy_(s)
            raise
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in params.items()}
        for p in params.values():
            p.grad = None
        grads = dict(zip(grads, all_reduce_many(grads.values(), dp)))
        torch._foreach_div_(list(grads.values()), acc)
        norm = _grad_norm(grads, mesh) if mesh is not None else None
        optimizer.apply(model, grads, state.opt_state, grad_norm=norm)
        state.step += 1
        # the global losses: the sum of every rank's shares
        return FS2Losses(*(all_reduce(total, dp) / acc))

    return train_step


def make_eval_step(mesh=None):
    """Teacher-forced loss evaluation (fs_two/evaluate.py:44-54): eval mode,
    no gradient, so attention runs the inference kernel. On a ``mesh`` the
    batch is this rank's rows and the losses the global batch's."""
    dp = mesh.dp_axis if mesh is not None else Axis()

    def eval_step(state, batch):
        state.model.eval()
        with torch.no_grad():
            losses = forward_loss(state.model, batch, dp=dp)
            return FS2Losses(*all_reduce(torch.stack(list(losses)), dp))

    return eval_step
