"""HiFi-GAN adversarial training.

Port of tts_king_tpu/train/vocoder.py (the HiFi-GAN V1 recipe the reference
leaves unimplemented, hifiapi.py:32-33):

  * the weight-norm Generator on the differentiable "plain" route, the
    multi-period and multi-scale discriminators (models/hifigan.py);
  * LSGAN losses, feature matching (x 2) and the mel L1 weighted 45 on
    ``hifigan_mel`` at ``mel_fmax_loss or mel_fmax``;
  * two optimizers, each optax.adamw(b1=0.8, b2=0.99, eps, weight decay
    0.01 on every parameter) under lr = 2e-4 * 0.999 ** (count //
    steps_per_epoch) (train/state.Optimizer.adamw).

One train step, in the JAX step's order (tts_king_tpu/train/vocoder.py:112-
188): the generator's forward; the discriminators' update on y_hat.detach()
(pair-batched: each discriminator once on cat([y, y_hat]), so one power
iteration of the spectral-normed MSD scale); then the generator's update
against the *updated* discriminators, run as two calls d(y), d(y_hat) (two
power iterations), the spectral buffers carried on from the first half.
The JAX step runs the generator forward twice, once per half, on the same
parameters; one forward, detached for the discriminators' half, computes
the same numbers. In the generator's half the discriminators' parameters
are frozen, so the backward computes no weight gradient of theirs.

``compute_dtype`` (bf16) runs the generator's and the discriminators' convs
in it; the parameters, the weight-norm folds, the losses, the mel loss's
STFT and the power iteration stay f32.
In f32 the convs follow the process's TF32 setting
(``torch.backends.cudnn.allow_tf32``, on by default in PyTorch); the
golden replays and the timed f32 step of chip_smoke.py turn it off.

Data parallelism (``make_train_step(mesh)``, parallel/mesh.py): each rank
computes its rows' losses, means over equal row blocks, so the mean of the
ranks' gradients is the global batch's; the generator's and both
discriminators' gradients are averaged over dp before each update, the
losses too. The spectral norm's power iteration reads the weights only, so
it stays replicated and equal on every rank.

Everything lives on ``device`` (the card unless the caller asks for the
CPU). Initial weights come from a numpy RandomState (``init_state``): the
generator's v ~ N(0, 0.01), the discriminators' v and weight_orig lecun
normal (truncated at 2 std), every g 1, biases 0, the power iteration's u
and v unit random vectors; nothing draws from torch's global RNG.
"""

import math
from dataclasses import dataclass
from typing import Dict, NamedTuple

import numpy as np
import torch
from torch import nn

from tts_king_torch.config import VocoderModelConfig
from tts_king_torch.models.hifigan import (Generator,
                                           MultiPeriodDiscriminator,
                                           MultiScaleDiscriminator,
                                           discriminator_loss, feature_loss,
                                           fold_weight_norm, generator_loss)
from tts_king_torch.ops.stft import hifigan_mel
from tts_king_torch.parallel.comm import Axis, all_reduce_many
from tts_king_torch.pipeline import resolve_device
from tts_king_torch.train.schedule import exponential_decay
from tts_king_torch.train.state import AdamState, Optimizer

MEL_LOSS_WEIGHT = 45.0
VOC_LOSS_NAMES = ("disc", "gen", "mel_l1", "fm", "adv")
MPD_CHANNELS = (32, 128, 512, 1024, 1024)


class Discriminators(nn.Module):
    """The MPD and the MSD as one module, so that one optimizer state
    covers both: parameter names ``mpd.*`` and ``msd.*``, as the JAX
    trainer's {"mpd": ..., "msd": ...} tree flattens."""

    def __init__(self, mpd: MultiPeriodDiscriminator,
                 msd: MultiScaleDiscriminator):
        super().__init__()
        self.mpd = mpd
        self.msd = msd


@dataclass
class VocoderTrainState:
    """The weight-norm generator, the discriminators (the MSD's spectral
    buffers among their buffers), the two Adam states and the count of
    steps taken. The train step updates it in place."""
    gen: Generator
    disc: Discriminators
    gen_opt: AdamState
    disc_opt: AdamState
    step: int = 0


class VocoderLosses(NamedTuple):
    disc: torch.Tensor
    gen: torch.Tensor
    mel_l1: torch.Tensor
    fm: torch.Tensor
    adv: torch.Tensor


def _truncated_normal(rng, shape, std):
    """flax's truncated_normal: N(0, 1) cut at +-2, over its own std
    (0.8796...), times ``std``."""
    n = int(np.prod(shape))
    out = np.empty(0)
    while out.size < n:
        draw = rng.standard_normal(2 * n + 16)
        out = np.concatenate([out, draw[np.abs(draw) <= 2.0]])
    return out[:n].reshape(shape) * std / 0.87962566103423978


def init_gan_state_dict(module, seed: int, generator: bool):
    """Initial weights for GAN training from a numpy RandomState, as the
    JAX package's initializers draw them (not the same numbers): a
    generator's weight-norm v ~ N(0, 0.01); a discriminator's v and
    weight_orig lecun normal over the fan-in; g 1; biases 0; an SNConv's u
    and v random unit vectors. Shapes only are read from ``module``."""
    rng = np.random.RandomState(seed)
    spectral = {k.rsplit(".", 1)[0] for k in module.state_dict()
                if k.endswith(".weight_orig")}
    sd = {}
    for key, ref in module.state_dict().items():
        shape = tuple(ref.shape)
        mod, name = key.rsplit(".", 1)
        if mod in spectral and name in ("u", "v"):
            a = rng.standard_normal(shape)
            a = a / np.linalg.norm(a)
        elif name in ("v", "weight_orig"):
            if generator:
                a = 0.01 * rng.standard_normal(shape)
            else:
                a = _truncated_normal(rng, shape,
                                      math.sqrt(1.0 / np.prod(shape[1:])))
        elif name == "g":
            a = np.ones(shape)
        elif name == "bias":
            a = np.zeros(shape)
        else:
            raise KeyError(f"no GAN initializer for {key}")
        sd[key] = torch.from_numpy(a.astype(np.float32))
    return sd


def export_inference_params(gen: Generator) -> Dict[str, torch.Tensor]:
    """The weight-norm fold (the remove_weight_norm step,
    hifi/models.py:203-210): each (v, g) pair of ``gen`` as the ``weight``
    of an inference Generator, biases as they are, f32 on the CPU. Loads
    into Generator(mrf_backend="fused" | "fused_int8" | "plain") and
    Vocoder."""
    sd = {}
    with torch.no_grad():
        for name, module in gen.named_modules():
            if hasattr(module, "v") and hasattr(module, "g"):
                sd[f"{name}.weight"] = fold_weight_norm(
                    module.v, module.g).detach().float().cpu().contiguous()
                sd[f"{name}.bias"] = module.bias.detach().float().cpu()
    return sd


class VocoderTrainer:
    """HiFi-GAN GAN training of ``cfg``'s generator on ``device``.

    disc_p_channels: the MPD's channels (MPD_CHANNELS by default);
    msd_width: divides the MSD's channels (1 = the published widths);
    steps_per_epoch: the learning rate's decay period; compute_dtype: the
    convs' dtype (None = f32); eps: Adam's eps (optax's default 1e-8)."""

    def __init__(self, cfg: VocoderModelConfig, disc_p_channels=None,
                 msd_width: int = 1, steps_per_epoch: int = 1000,
                 compute_dtype=None, eps: float = 1e-8, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.disc_p_channels = tuple(disc_p_channels or MPD_CHANNELS)
        self.msd_width = msd_width
        lr = exponential_decay(cfg.learning_rate, steps_per_epoch,
                               cfg.lr_decay)
        self.gen_opt = Optimizer.adamw(lr, cfg.adam_b1, cfg.adam_b2, eps,
                                       weight_decay=0.01)
        self.disc_opt = Optimizer.adamw(lr, cfg.adam_b1, cfg.adam_b2, eps,
                                        weight_decay=0.01)

    def build(self):
        """(generator, discriminators) on the meta device: shapes only."""
        with torch.device("meta"):
            gen = Generator(self.cfg, mrf_backend="plain", weight_norm=True,
                            compute_dtype=self.compute_dtype)
            disc = Discriminators(
                MultiPeriodDiscriminator(channels=self.disc_p_channels,
                                         compute_dtype=self.compute_dtype),
                MultiScaleDiscriminator(width=self.msd_width,
                                        compute_dtype=self.compute_dtype))
        return gen, disc

    def state_from(self, gen_sd, disc_sd) -> VocoderTrainState:
        """A fresh state (step 0, zero Adam moments) holding the given
        state dicts (the generator's; the discriminators' with the spectral
        buffers) on the trainer's device."""
        gen, disc = self.build()
        gen = gen.to_empty(device=self.device)
        disc = disc.to_empty(device=self.device)
        gen.load_state_dict(gen_sd, strict=True)
        disc.load_state_dict(disc_sd, strict=True)
        return VocoderTrainState(gen, disc, self.gen_opt.init(gen),
                                 self.disc_opt.init(disc))

    def init_state(self, seed: int) -> VocoderTrainState:
        gen, disc = self.build()
        return self.state_from(
            init_gan_state_dict(gen, seed, generator=True),
            init_gan_state_dict(disc, seed + 1, generator=False))

    def loss_mel(self, y):
        """The mel-loss spectrogram of a waveform (B, T), f32."""
        c = self.cfg
        return hifigan_mel(y, c.n_fft, c.num_mels, c.sampling_rate,
                           c.hop_size, c.win_size, c.mel_fmin,
                           c.mel_fmax_loss or c.mel_fmax)

    def make_train_step(self, mesh=None):
        """train_step(state, batch) -> VocoderLosses (0-dim tensors on the
        device); ``batch`` holds "mel" (B, frames, mels), "wav" (B, T) and
        "mel_loss" (B, frames, mels) tensors on the device, this rank's
        rows on a ``mesh`` (whose losses are the global batch's)."""
        gen_opt, disc_opt = self.gen_opt, self.disc_opt
        dp = mesh.dp_axis if mesh is not None else Axis()

        def train_step(state: VocoderTrainState, batch):
            gen, disc = state.gen, state.disc
            mpd, msd = disc.mpd, disc.msd
            mel, wav, mel_target = batch["mel"], batch["wav"], \
                batch["mel_loss"]
            y_hat = gen(mel)

            # the discriminators' update; the power iteration runs in the
            # forward and its buffers carry on to the generator's half
            y_d = y_hat.detach()
            r_p, g_p, _, _ = mpd(wav, y_d, pair_batched=True)
            loss_p, _, _ = discriminator_loss(r_p, g_p)
            r_s, g_s, _, _ = msd(wav, y_d, update_sn=True, pair_batched=True)
            loss_s, _, _ = discriminator_loss(r_s, g_s)
            d_loss = loss_p + loss_s
            d_params = dict(disc.named_parameters())
            d_grads = _mean_over(
                torch.autograd.grad(d_loss, list(d_params.values())), dp)
            disc_opt.apply(disc, dict(zip(d_params, d_grads)),
                           state.disc_opt)
            del d_grads

            # the generator's update against the updated discriminators,
            # whose parameters take no gradient
            disc.requires_grad_(False)
            try:
                l_mel = torch.mean(torch.abs(self.loss_mel(y_hat)
                                             - mel_target)) * MEL_LOSS_WEIGHT
                _, g_p, f_rp, f_gp = mpd(wav, y_hat)
                _, g_s, f_rs, f_gs = msd(wav, y_hat, update_sn=True)
                l_fm = feature_loss(f_rp, f_gp) + feature_loss(f_rs, f_gs)
                adv_p, _ = generator_loss(g_p)
                adv_s, _ = generator_loss(g_s)
                l_adv = adv_p + adv_s
                total = l_adv + l_fm + l_mel
            finally:
                disc.requires_grad_(True)
            g_params = dict(gen.named_parameters())
            g_grads = _mean_over(
                torch.autograd.grad(total, list(g_params.values())), dp)
            gen_opt.apply(gen, dict(zip(g_params, g_grads)), state.gen_opt)
            state.step += 1
            losses = torch.stack([d_loss, total, l_mel, l_fm, l_adv]).detach()
            return VocoderLosses(*_mean_over([losses], dp)[0])

        return train_step

    def make_eval_step(self, mesh=None):
        """eval_step(state, batch) -> the validation mel L1 (unweighted,
        upstream hifi-gan's val metric) of the generator on a training-
        shaped batch (the global batch's on a ``mesh``)."""
        dp = mesh.dp_axis if mesh is not None else Axis()

        def eval_step(state: VocoderTrainState, batch):
            with torch.no_grad():
                y = state.gen(batch["mel"])
                return _mean_over([torch.mean(torch.abs(
                    self.loss_mel(y) - batch["mel_loss"]))], dp)[0]

        return eval_step


def _mean_over(tensors, dp):
    """The tensors averaged over the dp axis, in one flat all-reduce."""
    return [t / dp.size for t in all_reduce_many(tensors, dp)]
