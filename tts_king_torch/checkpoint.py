"""Upstream PyTorch checkpoints (``.pth`` / ``.pth.tar``) -> the port's
state dicts.

The port's own copy of the converters of tts_king_tpu/checkpoint.py:

  * FastSpeech2 ``.pth.tar``: ``{"model": state_dict without speaker_emb,
    "embedding": speaker_emb.weight, "optimizer": ...}`` (fsapi.py:26-30),
    the split speaker embedding put back; FFT blocks at
    ``{encoder,decoder}.layer_stack.{i}``, variance predictors'
    ``conv_layer.{conv1d_1.conv, layer_norm_1, ...}``, the postnet's
    ``convolutions.{i}.{0.conv, 1}``; with ``use_cwt=True`` the CWT heads
    ``variance_adaptor.pitch_{mean,std}.{flat_one,flat_two}.net.{0,2}``
    (the k=1 conv and the LayerNorm) and their ``linear``;

  * HiFi-GAN: ``{"generator": state_dict}`` (hifiapi.py:21-22) with
    weight-norm ``weight_g`` / ``weight_v`` pairs, folded to plain weights
    g * v / ||v|| (dim=0: the norm over every axis but the first, with no
    epsilon, as torch computes it); ResBlock1 convs at
    ``resblocks.{n}.convs1.{j}`` / ``convs2.{j}``, ResBlock2 at
    ``resblocks.{n}.convs.{j}``, upsamplers at ``ups.{i}``;
  * MelGAN (models/melgan.convert_melgan_state): the descript generator's
    ``model.{idx}`` Sequential.

The upstream weights are already in torch's layouts, so only the names
change.
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


def _copy(state, src, dst, out, names=("weight", "bias")):
    for n in names:
        out[f"{dst}.{n}"] = torch.as_tensor(state[f"{src}.{n}"]).float()


def _fft_block(state, src, dst, out):
    for m in ("w_qs", "w_ks", "w_vs", "fc", "layer_norm"):
        _copy(state, f"{src}.slf_attn.{m}", f"{dst}.slf_attn.{m}", out)
    for m in ("w_1", "w_2", "layer_norm"):
        _copy(state, f"{src}.pos_ffn.{m}", f"{dst}.pos_ffn.{m}", out)


def _variance_predictor(state, src, dst, out):
    for i in (1, 2):
        _copy(state, f"{src}.conv_layer.conv1d_{i}.conv", f"{dst}.conv1d_{i}",
              out)
        _copy(state, f"{src}.conv_layer.layer_norm_{i}",
              f"{dst}.layer_norm_{i}", out)
    _copy(state, f"{src}.linear_layer", f"{dst}.linear_layer", out)


def _cnn_scalar(state, src, dst, out):
    for flat in ("flat_one", "flat_two"):
        _copy(state, f"{src}.{flat}.net.0", f"{dst}.{flat}.conv", out)
        _copy(state, f"{src}.{flat}.net.2", f"{dst}.{flat}.norm", out)
    _copy(state, f"{src}.linear", f"{dst}.linear", out)


def convert_fs2_state(state, n_encoder_layers=4, n_decoder_layers=6,
                      use_cwt=False):
    """An upstream FastSpeech2 state dict (speaker_emb.weight included
    where the model has one) -> the port's FastSpeech2 state dict
    (models/fs2.py names), the keys that tts_king_tpu/checkpoint.py's
    convert_fs2_state reads; ``use_cwt=True`` adds the CWT heads."""
    out = {}
    _copy(state, "encoder.src_word_emb", "encoder.src_word_emb", out,
          ("weight",))
    for i in range(n_encoder_layers):
        _fft_block(state, f"encoder.layer_stack.{i}", f"encoder.layer_{i}",
                   out)
    for i in range(n_decoder_layers):
        _fft_block(state, f"decoder.layer_stack.{i}", f"decoder.layer_{i}",
                   out)
    va = "variance_adaptor"
    for name in ("duration", "pitch", "energy"):
        _variance_predictor(state, f"{va}.{name}_predictor",
                            f"{va}.{name}_predictor", out)
    for name in ("pitch_embedding", "energy_embedding"):
        _copy(state, f"{va}.{name}", f"{va}.{name}", out, ("weight",))
    if use_cwt:
        for name in ("pitch_mean", "pitch_std"):
            _cnn_scalar(state, f"{va}.{name}", f"{va}.{name}", out)
    if "speaker_emb.weight" in state:
        _copy(state, "speaker_emb", "speaker_emb", out, ("weight",))
    _copy(state, "mel_linear", "mel_linear", out)
    for i in range(5):
        src = f"postnet.convolutions.{i}"
        _copy(state, f"{src}.0.conv", f"postnet.conv_{i}", out)
        _copy(state, f"{src}.1", f"postnet.bn_{i}", out,
              ("weight", "bias", "running_mean", "running_var"))
    return out


def convert_fs2_checkpoint(path, n_encoder_layers=4, n_decoder_layers=6,
                           use_cwt=False):
    """An upstream FastSpeech2 ``.pth.tar`` -> the port's state dict, the
    split speaker embedding (``ckpt["embedding"]``) put back as
    ``speaker_emb.weight`` (fsapi.py:27-30)."""
    ckpt = load_torch_checkpoint(path)
    state = dict(ckpt["model"])
    if ckpt.get("embedding") is not None:
        state["speaker_emb.weight"] = ckpt["embedding"]
    return convert_fs2_state(state, n_encoder_layers, n_decoder_layers,
                             use_cwt)


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

