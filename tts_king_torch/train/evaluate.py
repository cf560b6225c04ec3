"""Validation loop: teacher-forced loss means over the val split.

Port of tts_king_tpu/train/evaluate.py (fs_two/evaluate.py:18-54
semantics): per-batch sums weighted by batch size, divided by the number of
utterances."""

from typing import Optional

import numpy as np
import torch

from tts_king_torch.train.loss import FS2Losses
from tts_king_torch.train.step import to_device


def evaluate(eval_step, state, dataset, device,
             max_batches: Optional[int] = None) -> FS2Losses:
    """eval_step: make_eval_step's function; dataset: FS2Dataset (val)."""
    totals = np.zeros(len(FS2Losses._fields), np.float64)
    count = 0
    for i, batch in enumerate(dataset.batches()):
        if max_batches is not None and i >= max_batches:
            break
        losses = eval_step(state, to_device(batch, device))
        B = batch["texts"].shape[0]
        totals += torch.stack(list(losses)).double().cpu().numpy() * B
        count += B
    if count == 0:
        return FS2Losses(*([np.nan] * len(FS2Losses._fields)))
    return FS2Losses(*(totals / count))
