"""FastSpeech2 acoustic model.

Port of tts_king_tpu/models/fs2.py (reference fs_two/model/fastspeech2.py,
fs_two/transformer/Models.py, fs_two/model/modules.py), with the quirks that
change outputs kept:
  * pad-token embeddings are zeroed with a where, not through padding_idx;
  * the duration predictor runs on the encoder output *before* the speaker
    embedding is added (modules.py:158-159);
  * 256-bin bucketized pitch/energy embeddings, bins from stats.json min/max
    and a left-sided searchsorted (modules.py:55-90);
  * inference duration rounding clamp(round(exp(logd)-1)*c, 0), with the
    raw (unclamped) mel length returned beside the clamped one;
  * the sinusoid table is regenerated past max_seq_len (Models.py:163-170);
  * in training the decoder truncates to max_seq_len (Models.py:172-180).

Teacher forcing: given ``mel_lens`` and the duration, pitch and energy
targets, the embeddings come from the bucketized targets, the length
regulator runs on the target durations and the mel mask comes from
``mel_lens`` (the JAX package's training and eval path). Training mode is
``model.train()``: dropout at the config's rates with masks from the
``generator`` passed to forward, BatchNorm on batch statistics, attention
through the flash kernels, and the decoder truncation.

The CWT pitch branch (``use_cwt=True``, fs_two/model/modules.py:103-129):
the pitch predictor gives 11 CWT scales (with its own dropout of 0.1), two
CNNScalar heads give the pitch mean and std from the detached adaptor input
and prediction, and the pitch is the batch-standardized recomposition
(ops/cwt.inverse_batch_cwt, in f32) times the std plus the mean; its
embedding is bucketized from pitch * p_control, with or without targets.
Two quirks of the reference change outputs: the standardization runs over
the batch axis (a batch of one gets a flat pitch, the mean), and the heads
pool over the padded phoneme length, so the padding moves them.
"""

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from tts_king_torch.config import ModelConfig, VariancePredictorConfig
from tts_king_torch.models.layers import (CNNScalar, FFTBlock, PostNet,
                                          VariancePredictor,
                                          sinusoid_position_table)
from tts_king_torch.ops.cwt import inverse_batch_cwt
from tts_king_torch.ops.length_regulator import length_regulate, round_durations
from tts_king_torch.ops.masks import mask_from_lengths
from tts_king_torch.text.symbols import VOCAB_SIZE

CWT_CHANNELS = 11   # the CWT scales of the pitch spectrogram


class _Positions:
    """Sinusoid rows [0, n) for n > max_seq_len or from the max_seq_len + 1
    table otherwise — the same values either way, cached per device/dtype.
    Not module state: nothing to load, nothing the dtype cast may round."""

    def __init__(self, max_seq_len, d_model):
        self.max_seq_len, self.d_model = max_seq_len, d_model
        self._cache = {}

    def __call__(self, n, device, dtype):
        key = (max(n, self.max_seq_len + 1), device, dtype)
        table = self._cache.get(key)
        if table is None:
            table = torch.from_numpy(sinusoid_position_table(
                key[0], self.d_model)).to(device=device, dtype=dtype)
            self._cache[key] = table
        return table[:n]


class Encoder(nn.Module):
    """Phoneme encoder: embedding + sinusoid positions + N FFT blocks
    (fs_two/transformer/Models.py:33-112)."""

    def __init__(self, n_layers=4, n_head=2, d_model=256, d_inner=1024,
                 kernel_size=(9, 1), max_seq_len=1000, vocab_size=VOCAB_SIZE,
                 dropout=0.2):
        super().__init__()
        d_k = d_model // n_head
        self.n_layers = n_layers
        self.src_word_emb = nn.Embedding(vocab_size, d_model)
        for i in range(n_layers):
            self.add_module(f"layer_{i}", FFTBlock(
                d_model, n_head, d_k, d_k, d_inner, kernel_size, dropout))
        self._pos = _Positions(max_seq_len, d_model)

    def forward(self, src_seq, pad_mask, generator=None):
        emb = self.src_word_emb(src_seq)
        # padding_idx=0 semantics: the pad token contributes nothing
        x = torch.where((src_seq == 0)[:, :, None], emb.new_zeros(()), emb)
        x = x + self._pos(src_seq.shape[1], x.device, x.dtype)[None]
        for i in range(self.n_layers):
            x = getattr(self, f"layer_{i}")(x, pad_mask, generator)
        return x


class Decoder(nn.Module):
    """Mel decoder: sinusoid positions + N FFT blocks
    (fs_two/transformer/Models.py:115-189). In training it truncates to
    max_seq_len; otherwise it never truncates. Returns (x, pad_mask), both
    truncated alike."""

    def __init__(self, n_layers=6, n_head=2, d_model=256, d_inner=1024,
                 kernel_size=(9, 1), max_seq_len=1000, dropout=0.2):
        super().__init__()
        d_k = d_model // n_head
        self.n_layers = n_layers
        self.max_seq_len = max_seq_len
        for i in range(n_layers):
            self.add_module(f"layer_{i}", FFTBlock(
                d_model, n_head, d_k, d_k, d_inner, kernel_size, dropout))
        self._pos = _Positions(max_seq_len, d_model)

    def forward(self, x, pad_mask, generator=None):
        if self.training and x.shape[1] > self.max_seq_len:
            x = x[:, :self.max_seq_len]
            pad_mask = pad_mask[:, :self.max_seq_len]
        x = x + self._pos(x.shape[1], x.device, x.dtype)[None]
        for i in range(self.n_layers):
            x = getattr(self, f"layer_{i}")(x, pad_mask, generator)
        return x, pad_mask


class VarianceAdaptor(nn.Module):
    """Duration/pitch/energy adaptor + length regulator
    (fs_two/model/modules.py:14-217). With targets (teacher forcing) the
    embeddings come from the bucketized targets and the length regulator
    runs on the target durations; without, from the predictions."""

    def __init__(self, d_model=256, predictor: Optional[VariancePredictorConfig]
                 = None, n_bins=256, pitch_quantization="linear",
                 energy_quantization="linear", pitch_min=-1.0, pitch_max=1.0,
                 energy_min=-1.0, energy_max=1.0, use_cwt=False):
        super().__init__()
        vp = predictor or VariancePredictorConfig()
        self.n_bins = n_bins
        self.use_cwt = use_cwt
        for name in ("duration_predictor", "pitch_predictor",
                     "energy_predictor"):
            self.add_module(name, VariancePredictor(
                d_model, vp.filter_size, vp.kernel_size, vp.dropout))
        if use_cwt:
            # 11 CWT scales, with the reference's own dropout of 0.1
            self.pitch_predictor = VariancePredictor(
                d_model, vp.filter_size, vp.kernel_size, 0.1,
                output_size=CWT_CHANNELS)
            self.pitch_mean = CNNScalar(d_model, CWT_CHANNELS)
            self.pitch_std = CNNScalar(d_model, CWT_CHANNELS)
        self.pitch_embedding = nn.Embedding(n_bins, d_model)
        self.energy_embedding = nn.Embedding(n_bins, d_model)
        # f32 bins, kept out of the module state so a bf16 cast leaves them be
        self._bins = {
            "pitch": self._make_bins(pitch_min, pitch_max, pitch_quantization),
            "energy": self._make_bins(energy_min, energy_max,
                                      energy_quantization)}
        # their copies per device: a copy from the host on every forward
        # would wait for the card's queued work
        self._bins_on = {}

    def _make_bins(self, lo, hi, quantization):
        if quantization == "log":
            b = np.exp(np.linspace(np.log(lo), np.log(hi), self.n_bins - 1))
        else:
            b = np.linspace(lo, hi, self.n_bins - 1)
        return torch.from_numpy(b.astype(np.float32))

    def _bucketize(self, kind, values):
        key = (kind, values.device)
        bins = self._bins_on.get(key)
        if bins is None:
            bins = self._bins_on[key] = self._bins[kind].to(values.device)
        return torch.searchsorted(bins, values.float().contiguous())

    def forward(self, x, speaker_embedding, src_mask, max_mel_len: int,
                p_control=1.0, e_control=1.0, d_control=1.0, mel_mask=None,
                pitch_target=None, energy_target=None, duration_target=None,
                generator=None):
        g = generator
        # duration predicted BEFORE the speaker embedding is added
        log_duration_prediction = self.duration_predictor(x, src_mask, g)
        x = x + speaker_embedding

        pitch_prediction = self.pitch_predictor(x, src_mask, g)
        pitch_mean = pitch_std = None
        if self.use_cwt:
            xd, pd = x.detach(), pitch_prediction.detach()
            pitch_mean = self.pitch_mean(xd, pd)
            pitch_std = self.pitch_std(xd, pd)
            pitch = inverse_batch_cwt(pitch_prediction)
            pitch_target = (pitch * pitch_std + pitch_mean) * p_control
        elif pitch_target is None:
            pitch_prediction = pitch_prediction * p_control
            pitch_target = pitch_prediction
        x = x + self.pitch_embedding(self._bucketize("pitch", pitch_target))

        energy_prediction = self.energy_predictor(x, src_mask, g)
        if energy_target is None:
            energy_prediction = energy_prediction * e_control
            energy_target = energy_prediction
        x = x + self.energy_embedding(
            self._bucketize("energy", energy_target))

        if duration_target is not None:
            x, mel_len = length_regulate(x, duration_target, max_mel_len)
            duration_rounded = duration_target
            mel_len_raw = mel_len
        else:
            duration_rounded = round_durations(log_duration_prediction,
                                               d_control)
            # padded phonemes predict logd = 0 -> round(e^0 - 1) = 0 frames
            x, mel_len = length_regulate(x, duration_rounded, max_mel_len)
            # the raw length decides mel-bucket escalation in the pipeline
            mel_len_raw = mel_len
            mel_len = mel_len.clamp(max=max_mel_len)
            mel_mask = mask_from_lengths(mel_len, max_mel_len)
        return {
            "x": x,
            "mel_len_raw": mel_len_raw,
            "pitch_prediction": pitch_prediction,
            "energy_prediction": energy_prediction,
            "log_duration_prediction": log_duration_prediction,
            "duration_rounded": duration_rounded,
            "mel_len": mel_len,
            "mel_mask": mel_mask,
            "pitch_mean": pitch_mean,
            "pitch_std": pitch_std,
        }


class FastSpeech2(nn.Module):
    """Encoder -> (+speaker) -> VarianceAdaptor -> Decoder -> mel + PostNet
    residual (fs_two/model/fastspeech2.py:43-119): inference, or teacher
    forcing with targets (training in train mode, evaluation in eval
    mode)."""

    def __init__(self, model_config: ModelConfig, n_speakers=1, pitch_min=-1.0,
                 pitch_max=1.0, energy_min=-1.0, energy_max=1.0,
                 n_mel_channels=80):
        super().__init__()
        mc = model_config
        if mc.attention_probs_bf16:
            # the JAX package's XLA attention (use_pallas_attention and
            # use_flash_attention False) rounds the normalized softmax
            # probabilities to bf16 before P.V, in training, evaluation
            # and inference alike; the port's kernels do not
            raise NotImplementedError(
                "attention_probs_bf16=True: attention with bf16 "
                "probabilities is not ported yet; it comes with the bf16 "
                "attention slice of the port")
        tc = mc.transformer
        self.model_config = mc
        self.encoder = Encoder(
            tc.encoder_layer, tc.encoder_head, tc.encoder_hidden,
            tc.conv_filter_size, tuple(tc.conv_kernel_size), mc.max_seq_len,
            dropout=tc.encoder_dropout)
        if mc.multi_speaker:
            self.speaker_emb = nn.Embedding(n_speakers, tc.encoder_hidden)
        ve = mc.variance_embedding
        self.variance_adaptor = VarianceAdaptor(
            tc.encoder_hidden, mc.variance_predictor, ve.n_bins,
            ve.pitch_quantization, ve.energy_quantization, pitch_min,
            pitch_max, energy_min, energy_max, mc.use_cwt)
        self.decoder = Decoder(
            tc.decoder_layer, tc.decoder_head, tc.decoder_hidden,
            tc.conv_filter_size, tuple(tc.conv_kernel_size), mc.max_seq_len,
            dropout=tc.decoder_dropout)
        self.mel_linear = nn.Linear(tc.decoder_hidden, n_mel_channels)
        self.postnet = PostNet(n_mel_channels, embedding_dim=mc.postnet_dim)

    def forward(self, speakers, texts, src_lens, max_mel_len=None,
                p_control=1.0, e_control=1.0, d_control=1.0, mel_lens=None,
                energy_targets=None, duration_targets=None,
                pitch_raw_targets=None, generator=None) -> Dict[str, Any]:
        """Inference from (speakers, texts, src_lens), or teacher forcing
        when ``mel_lens`` and the targets are given (the CWT branch takes no
        pitch target: its embedding comes from its own prediction).
        ``generator`` draws the dropout masks in training mode. The dict
        holds ``pitch_mean`` and ``pitch_std`` ((B, 1), None without
        CWT)."""
        mc = self.model_config
        if max_mel_len is None:
            max_mel_len = mc.max_seq_len
        g = generator
        src_masks = mask_from_lengths(src_lens, texts.shape[1])
        mel_masks = (mask_from_lengths(mel_lens, max_mel_len)
                     if mel_lens is not None else None)
        output = self.encoder(texts, src_masks, g)
        if mc.multi_speaker:
            speaker_embedding = self.speaker_emb(speakers)[:, None, :]
        else:
            speaker_embedding = output.new_zeros(
                (texts.shape[0], 1, output.shape[-1]))
        va = self.variance_adaptor(
            output, speaker_embedding, src_masks, max_mel_len, p_control,
            e_control, d_control, mel_mask=mel_masks,
            pitch_target=pitch_raw_targets, energy_target=energy_targets,
            duration_target=duration_targets, generator=g)
        decoded, mel_masks = self.decoder(va["x"], va["mel_mask"], g)
        mel = self.mel_linear(decoded)
        # masked postnet: every stage sees zeros past mel_len
        postnet_mel = self.postnet(mel, mel_masks, g) + mel
        return {
            "mel": mel,
            "pitch_prediction": va["pitch_prediction"],
            "energy_prediction": va["energy_prediction"],
            "log_duration_prediction": va["log_duration_prediction"],
            "duration_rounded": va["duration_rounded"],
            "src_masks": src_masks,
            "mel_masks": mel_masks,
            "src_lens": src_lens,
            "mel_lens": va["mel_len"],
            "mel_lens_raw": va["mel_len_raw"],
            "postnet_mel": postnet_mel,
            "pitch_mean": va["pitch_mean"],
            "pitch_std": va["pitch_std"],
        }


def build_fastspeech2(model_config: ModelConfig, stats: Dict[str, Any],
                      n_speakers: int, n_mel_channels: int = 80) -> FastSpeech2:
    """FastSpeech2 with bucketize bins from a stats.json dict
    (pitch/energy -> [min, max, mean, std]), mirroring modules.py:55-90."""
    pitch_min, pitch_max = stats["pitch"][:2]
    energy_min, energy_max = stats["energy"][:2]
    return FastSpeech2(model_config, n_speakers, float(pitch_min),
                       float(pitch_max), float(energy_min), float(energy_max),
                       n_mel_channels)
