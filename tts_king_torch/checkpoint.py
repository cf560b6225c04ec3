"""Upstream PyTorch vocoder checkpoints (``.pth`` / ``.pth.tar``) -> the
port's state dicts.

The port's own copy of the vocoder half of tts_king_tpu/checkpoint.py:

  * HiFi-GAN: ``{"generator": state_dict}`` (hifiapi.py:21-22) with
    weight-norm ``weight_g`` / ``weight_v`` pairs, folded to plain weights
    g * v / ||v|| (dim=0: the norm over every axis but the first, with no
    epsilon, as torch computes it); ResBlock1 convs at
    ``resblocks.{n}.convs1.{j}`` / ``convs2.{j}``, ResBlock2 at
    ``resblocks.{n}.convs.{j}``, upsamplers at ``ups.{i}``;
  * MelGAN (models/melgan.convert_melgan_state): the descript generator's
    ``model.{idx}`` Sequential.

The upstream weights are already in torch's layouts, so only the names
change. FastSpeech2 ``.pth.tar`` files wait with the CWT branch their
converter needs.
"""

import pickle

import torch


def load_torch_checkpoint(path):
    """Load a torch checkpoint on the CPU: tensors and plain containers
    only (``weights_only=True``), and the full unpickler only for files that
    need it (a pickled custom class), as the JAX package falls back."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        return torch.load(path, map_location="cpu", weights_only=False)


def fold_weight_norm(state, key):
    """The plain weight of ``key``: ``key.weight`` as it is, or
    g * v / ||v|| from ``key.weight_g`` / ``key.weight_v`` (dim=0)."""
    if key + ".weight" in state:
        return torch.as_tensor(state[key + ".weight"]).float()
    g = torch.as_tensor(state[key + ".weight_g"]).float()
    v = torch.as_tensor(state[key + ".weight_v"]).float()
    axes = tuple(range(1, v.dim()))
    return g * v / torch.sqrt(torch.sum(v * v, dim=axes, keepdim=True))


def _conv(state, key, name, out):
    out[f"{name}.weight"] = fold_weight_norm(state, key).contiguous()
    out[f"{name}.bias"] = torch.as_tensor(state[key + ".bias"]).float()


def _has(state, key):
    return key + ".weight" in state or key + ".weight_v" in state


def convert_hifigan_generator(state, n_ups=4, n_kernels=3, n_res_convs=3):
    """Upstream HiFi-GAN Generator state dict -> the port's Generator state
    dict (models/hifigan.py names), weight norm folded."""
    out = {}
    _conv(state, "conv_pre", "conv_pre", out)
    _conv(state, "conv_post", "conv_post", out)
    for i in range(n_ups):
        _conv(state, f"ups.{i}", f"ups_{i}", out)
    for n in range(n_ups * n_kernels):
        for j in range(n_res_convs):
            src = f"resblocks.{n}"
            if _has(state, f"{src}.convs1.{j}"):
                for g in ("convs1", "convs2"):
                    _conv(state, f"{src}.{g}.{j}", f"resblocks_{n}.{g}_{j}",
                          out)
            elif _has(state, f"{src}.convs.{j}"):
                _conv(state, f"{src}.convs.{j}", f"resblocks_{n}.convs_{j}",
                      out)
    return out


def convert_hifigan_checkpoint(path, **kw):
    """An upstream HiFi-GAN checkpoint ({"generator": ...} or a bare state
    dict) -> the port's Generator state dict."""
    ckpt = load_torch_checkpoint(path)
    state = ckpt["generator"] if "generator" in ckpt else ckpt
    return convert_hifigan_generator(state, **kw)


def convert_melgan_state(state, ratios=(8, 8, 2, 2), n_residual_layers=3):
    """The descript MelGAN generator's state dict (an nn.Sequential named
    ``model``, weight-normed) -> the port's MelGANGenerator state dict.

    Sequential layout: [pad, conv7] + per ratio [lrelu, convT,
    n_residual_layers ResnetBlocks] + [lrelu, pad, conv7, tanh]; a
    ResnetBlock's ``block`` is [lrelu, pad, conv3, lrelu, conv1] beside a
    1 x 1 ``shortcut``."""
    out = {}
    idx = 1   # model.0 is the ReflectionPad1d
    _conv(state, f"model.{idx}", "conv_in", out)
    idx += 1
    for i in range(len(ratios)):
        idx += 1   # LeakyReLU
        _conv(state, f"model.{idx}", f"up_{i}", out)
        idx += 1
        for j in range(n_residual_layers):
            base = f"model.{idx}"
            _conv(state, base + ".block.2", f"res_{i}_{j}.block_conv", out)
            _conv(state, base + ".block.4", f"res_{i}_{j}.block_out", out)
            _conv(state, base + ".shortcut", f"res_{i}_{j}.shortcut", out)
            idx += 1
    idx += 2   # LeakyReLU, ReflectionPad1d
    _conv(state, f"model.{idx}", "conv_out", out)
    return out


def convert_melgan_checkpoint(path, ratios=(8, 8, 2, 2), n_residual_layers=3):
    """A MelGAN generator checkpoint -> the port's state dict. A state dict
    saved from the hub wrapper carries a ``mel2wav.`` prefix, which is
    stripped (tts_king_tpu/pipeline.py:261-264)."""
    state = load_torch_checkpoint(path)
    if not any(k.startswith("model.") for k in state):
        state = {k.split("mel2wav.", 1)[-1]: v for k, v in state.items()}
    return convert_melgan_state(state, ratios, n_residual_layers)

