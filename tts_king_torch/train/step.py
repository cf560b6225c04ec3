"""FastSpeech2 training and evaluation steps.

Port of tts_king_tpu/train/step.py. One optimizer step takes a superbatch
with a leading grad-accumulation axis, (acc, B, ...): each microbatch runs
forward and backward in training mode, the gradients are summed over the
microbatches and divided by acc (the reference's loss / grad_acc_step,
train.py:43), then clipped and applied (train/state.py). The BatchNorm
running stats are carried from one microbatch to the next, as the JAX
step's scan carry is. Dropout masks come from one generator per optimizer
step that the caller derives from (train.seed, step) (train/loop.py), drawn
by the microbatches in order.
"""

from typing import Any, Dict

import numpy as np
import torch

from tts_king_torch.train.loss import FS2Losses, fastspeech2_loss


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, Any]:
    """A numpy batch from data.dataset as tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def forward_loss(model, batch, generator=None):
    """Teacher-forced forward of one (B, ...) batch and its losses (the
    model raises for use_cwt, which is not ported yet)."""
    outputs = model(
        batch["speakers"], batch["texts"], batch["src_lens"],
        max_mel_len=int(batch["mels"].shape[1]), mel_lens=batch["mel_lens"],
        energy_targets=batch["energies"],
        duration_targets=batch["durations"],
        pitch_raw_targets=batch["pitches_raw"], generator=generator)
    return fastspeech2_loss(batch, outputs)


def make_train_step(optimizer):
    """Returns train_step(state, superbatch, generator) -> FS2Losses, the
    mean of each term over the microbatches (0-dim tensors on the device).
    ``superbatch`` holds (acc, B, ...) tensors on the model's device."""

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
                                              superbatch.items()}, generator)
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
        torch._foreach_div_(list(grads.values()), acc)
        for p in params.values():
            p.grad = None
        optimizer.apply(model, grads, state.opt_state)
        state.step += 1
        return FS2Losses(*(total / acc))

    return train_step


def make_eval_step():
    """Teacher-forced loss evaluation (fs_two/evaluate.py:44-54): eval mode,
    no gradient, so attention runs the inference kernel."""

    def eval_step(state, batch):
        state.model.eval()
        with torch.no_grad():
            return forward_loss(state.model, batch)

    return eval_step
