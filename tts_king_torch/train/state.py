"""Training state and the optimizer.

Port of tts_king_tpu/train/state.py. The optimizer is the JAX package's
optax chain (fs_two/model/optimizer.py:10-15, train.py:47-54), written out
step by step so that each stage is optax's:

  1. (FastSpeech2 only) global-norm clip, ``g * thresh / ||g||`` when
     ``||g|| >= thresh`` (optax.clip_by_global_norm; ``clip_grad_norm_``
     would add 1e-6 to the norm);
  2. Adam, ``m_hat / (sqrt(v_hat) + eps)`` with eps outside the root and
     bias corrections at the incremented count (optax.scale_by_adam);
  3. decoupled weight decay ``+ wd * param`` after Adam, when the config
     has one (optax.add_decayed_weights; ``torch.optim.Adam``'s
     ``weight_decay`` is L2 folded into the gradient, another optimizer);
  4. ``* -lr(count)`` with the Noam schedule at the 0-based count
     (optax.scale_by_schedule).

``Optimizer.adamw`` builds HiFi-GAN's optax.adamw (train/vocoder.py): no
clip, Adam at the given betas and eps, a decoupled weight decay on every
parameter (biases and weight-norm g included), and a schedule of the
caller's (the per-epoch exponential decay). ``torch.optim.AdamW`` rounds in
another order (it decays the parameter before the Adam step) and is not
this optimizer.

The Adam moments are keyed by the model's parameter names, which are the
state-dict names ``weights.flax_to_torch`` gives an optax ``mu``/``nu`` tree
(``weights.flax_adam_to_torch``).
"""

from dataclasses import dataclass, field
from typing import Dict

import numpy as np
import torch

from tts_king_torch.config import OptimizerConfig
from tts_king_torch.train.schedule import noam_schedule


@dataclass
class AdamState:
    count: int = 0
    mu: Dict[str, torch.Tensor] = field(default_factory=dict)
    nu: Dict[str, torch.Tensor] = field(default_factory=dict)


@dataclass
class TrainState:
    """The module (its parameters and BatchNorm running stats), the
    optimizer state and the count of optimizer steps taken. The train step
    updates it in place."""
    model: torch.nn.Module
    opt_state: AdamState
    step: int = 0


def init_state_dict(module, seed: int):
    """Initial weights for training, from a numpy RandomState: flax's
    default scales (Dense and Conv kernels N(0, 1/fan_in), embeddings
    N(0, 1/features), biases 0, norm scales 1, running mean 0 and variance
    1). Shapes only are read from ``module`` (the meta device will do);
    nothing draws from torch's global RNG."""
    rng = np.random.RandomState(seed)
    sd = {}
    for key, ref in module.state_dict().items():
        shape = tuple(ref.shape)
        name = key.rsplit(".", 1)[-1]
        if name == "num_batches_tracked":
            continue
        if name in ("bias", "running_mean"):
            a = np.zeros(shape)
        elif name == "running_var" or len(shape) == 1:
            a = np.ones(shape)
        elif "emb" in key:
            a = rng.standard_normal(shape) / np.sqrt(shape[-1])
        else:
            a = rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
        sd[key] = torch.from_numpy(a.astype(np.float32))
    return sd


class Optimizer:
    """[clip ->] Adam -> [decoupled weight decay] -> -lr(count), in place."""

    def __init__(self, opt_cfg: OptimizerConfig, d_model: int):
        self.clip = float(opt_cfg.grad_clip_thresh)
        self.b1, self.b2 = (float(b) for b in opt_cfg.betas)
        self.eps = float(opt_cfg.eps)
        self.weight_decay = float(opt_cfg.weight_decay)
        self.lr = noam_schedule(d_model, opt_cfg.warm_up_step,
                                opt_cfg.anneal_steps, opt_cfg.anneal_rate)

    @classmethod
    def adamw(cls, lr, b1: float, b2: float, eps: float = 1e-8,
              weight_decay: float = 0.01) -> "Optimizer":
        """optax.adamw(lr, b1, b2, eps, weight_decay=...): no clip; ``lr``
        maps the 0-based count to the learning rate."""
        opt = cls.__new__(cls)
        opt.clip = None
        opt.b1, opt.b2 = float(b1), float(b2)
        opt.eps = float(eps)
        opt.weight_decay = float(weight_decay)
        opt.lr = lr
        return opt

    def init(self, model) -> AdamState:
        return AdamState(
            0, {n: torch.zeros_like(p) for n, p in model.named_parameters()},
            {n: torch.zeros_like(p) for n, p in model.named_parameters()})

    @torch.no_grad()
    def apply(self, model, grads: Dict[str, torch.Tensor], state: AdamState,
              grad_norm=None):
        """One update of ``model``'s parameters from ``grads`` (keyed by
        parameter name; consumed), advancing ``state``. ``grad_norm``: the
        gradient's global norm for the clip, where the parameters are split
        over a mesh (train/step.py), else computed here."""
        names = [n for n, _ in model.named_parameters()]
        params = [p for _, p in model.named_parameters()]
        g = [grads[n] for n in names]
        mu = [state.mu[n] for n in names]
        nu = [state.nu[n] for n in names]

        if self.clip is not None:
            g_norm = (grad_norm if grad_norm is not None else
                      torch.stack(torch._foreach_norm(g)).square().sum()
                      .sqrt())
            factor = torch.where(g_norm < self.clip, torch.ones_like(g_norm),
                                 self.clip / g_norm)
            torch._foreach_mul_(g, factor)

        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - self.b2)
        t = np.float32(state.count + 1)
        bc1 = float(np.float32(1.0) - np.float32(self.b1) ** t)
        bc2 = float(np.float32(1.0) - np.float32(self.b2) ** t)
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, denom)
        if self.weight_decay:
            torch._foreach_add_(upd, params, alpha=self.weight_decay)
        torch._foreach_mul_(upd, -self.lr(state.count))
        torch._foreach_add_(params, upd)
        state.count += 1
