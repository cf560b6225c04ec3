"""Learning-rate schedules: FastSpeech2's Noam schedule with step anneals,
and HiFi-GAN's per-epoch exponential decay.

Port of tts_king_tpu/train/schedule.py (reference ScheduledOptim,
fs_two/model/optimizer.py:35-53):

    lr(step) = d_model^-0.5 * min(step^-0.5, step * warmup^-1.5)
               * anneal_rate^|{s in anneal_steps : step > s}|

``lr`` takes the 0-based count of updates already applied, as optax passes
it, and evaluates the formula at step = count + 1 (the reference increments
before use). The JAX package evaluates it in f32; this does the same.
"""

import numpy as np


def noam_schedule(d_model: int, warm_up_step: int, anneal_steps,
                  anneal_rate: float):
    init_lr = np.float32(float(d_model) ** -0.5)
    anneal = np.asarray(sorted(anneal_steps), np.float32)
    rate = np.float32(anneal_rate)
    warm = np.float32(warm_up_step)

    def lr(count: int) -> float:
        step = np.float32(count) + np.float32(1.0)
        scale = min(step ** np.float32(-0.5), step * warm ** np.float32(-1.5))
        n_anneals = int(np.sum(step > anneal))
        return float(init_lr * scale * rate ** np.float32(n_anneals))

    return lr


def exponential_decay(init_value: float, transition_steps: int,
                      decay_rate: float):
    """optax.exponential_decay(..., staircase=True), HiFi-GAN's per-epoch
    decay (torch ExponentialLR stepped once an epoch):

        lr(count) = init_value * decay_rate ** (count // transition_steps)

    at the 0-based count of updates already applied, in f32."""
    init = np.float32(init_value)
    rate = np.float32(decay_rate)

    def lr(count: int) -> float:
        return float(init * rate ** np.float32(count // transition_steps))

    return lr
