"""Seeded random weights, made on the device in one draw.

The rule for each tensor (by its name in the state dict): conv and linear
weights N(0, 1/fan_in) (a transposed conv of kernel 2 x stride: 2 x its
input channels), embeddings N(0, 0.3^2), norm scales 1 + N(0, 0.1^2), biases
N(0, 0.02^2), BatchNorm running means N(0, 0.1^2) and variances
1 + |N(0, 0.1^2)|. A family's reference may give rules of its own for the
tensors this rule does not fit (benchmark/reference/vocoders.py,
WEIGHT_RULES). The shapes are read from a module built on the meta device,
so nothing of the program's own initialisation runs.
"""

import math
import re

import torch


def _transposed_weights(module):
    return {f"{name}.weight" for name, m in module.named_modules()
            if isinstance(m, torch.nn.ConvTranspose1d)}


def seeded_state_dict(module, seed, device, dtype=torch.float32, rules=None):
    """A state dict for ``module`` (on the meta device) drawn from ``seed``
    on ``device`` with one call of the generator, in ``dtype``. ``rules``:
    {regular expression: rule}; a tensor whose key a pattern matches whole
    is the first such rule applied to its N(0, 1) draw. Every tensor takes
    its draw in the state dict's order whatever its rule, so a rule moves
    no other tensor."""
    shapes = {k: tuple(v.shape) for k, v in module.state_dict().items()
              if not k.endswith("num_batches_tracked")}
    transposed = _transposed_weights(module)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2 ** 63)
    total = sum(math.prod(s) for s in shapes.values())
    z = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for key, shape in shapes.items():
        n = math.prod(shape)
        a = z[at:at + n].view(shape)
        at += n
        name = key.rsplit(".", 1)[-1]
        rule = next((r for pattern, r in (rules or {}).items()
                     if re.fullmatch(pattern, key)), None)
        if rule is not None:
            a = rule(a)
        elif name == "running_mean":
            a = 0.1 * a
        elif name == "running_var":
            a = 1.0 + (0.1 * a).abs()
        elif name == "bias":
            a = 0.02 * a
        elif len(shape) == 1:
            a = 1.0 + 0.1 * a
        elif "emb" in key:
            a = 0.3 * a
        else:
            fan_in = (2 * shape[0] if key in transposed
                      else n // shape[0])
            a = a / math.sqrt(fan_in)
        out[key] = a.to(dtype)
    return out


def speech_like_durations(state_dict, features, stored=lambda t: t,
                          frames=5.0,
                          head="variance_adaptor.duration_predictor.linear_layer"):
    """Random weights predict log-durations near 0, next to no frames. The
    head keeps a tenth of its random weight and is centred so that the
    phonemes whose head inputs are ``features`` (N, F) get ``frames``
    frames on average, as a trained model gives about five: the bias puts
    their mean log-duration at log(frames + 1), then the weight moves along
    the features' mean until the mean of the rounded durations,
    clamp(round(exp(log d) - 1), 0), is ``frames``. Both are read as the
    configuration stores them (``stored``: the rounding of its variables),
    so that every seed's weights give the program the same frames a
    phoneme, and a run the same audio, within a fraction of a percent."""
    w = state_dict[f"{head}.weight"].float() * 0.1
    x = features.float()
    bias = stored(math.log(frames + 1.0) - (x @ w.t()).mean().reshape(1))
    m = x.mean(0, keepdim=True)
    step = m / (m * m).sum()

    def mean_frames(t):
        logd = x @ stored(w + t * step).t() + bias
        return torch.clamp(torch.round(torch.exp(logd) - 1.0), min=0).mean()

    lo, hi = -1.0, 1.0
    for _ in range(40):
        mid = 0.5 * (lo + hi)
        if mean_frames(mid) < frames:
            lo = mid
        else:
            hi = mid
    state_dict[f"{head}.weight"] = w + 0.5 * (lo + hi) * step
    state_dict[f"{head}.bias"] = bias
    return state_dict
