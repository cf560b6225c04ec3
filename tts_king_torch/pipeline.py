"""End-to-end synthesis pipeline: text -> phonemes -> mel -> waveform.

Port of tts_king_tpu/pipeline.py (API of the reference tts_king.py TTSKing,
fsapi.py FSTWOapi, hifiapi.py HIFIapi), inference with HiFi-GAN or MelGAN:
  * phoneme lengths pad up to power-of-two buckets, or to a load-tuned grid
    (``AcousticModel.phone_buckets``, serve.py's suggest_buckets) where it
    covers the length;
  * the mel length starts at a bucket guessed from the phoneme count and
    escalates through MEL_BUCKETS while the model's raw (unclamped) length
    overflows the bucket, unless ``generate(defer_overflow=True)`` leaves
    that check to the caller, so that nothing waits for the card;
  * the waveform is scaled by max_wav_value and cast f32 -> int32 -> int16
    on the device, which wraps at full scale as numpy's astype does;
  * ``TTSKing.speak_streaming`` yields the int16 waveform in chunks vocoded
    from halo'd mel windows (ops/streaming.py).

Every entry point takes ``device`` (default "cuda", which raises when CUDA is
missing; the CPU is used only when asked for) and ``dtype`` (float32 or
bfloat16), with the JAX package's meaning:
  * ``AcousticModel(dtype=bf16)`` rounds the FastSpeech2 variables (the
    parameters and the BatchNorm running statistics) to bf16 and computes
    in f32 on them, as the JAX AcousticModel casts its variable tree and
    keeps its f32 flax modules; the sinusoid table and the pitch/energy
    bins are no variables and stay f32;
  * ``Vocoder(dtype=bf16)`` holds and computes the Generator in bf16, as
    ``Generator(dtype=bf16)`` does.
FastSpeech2 computed in bf16 (the JAX bench's ``build_fastspeech2(dtype=
bf16)``) is ``build_fastspeech2(...).to(torch.bfloat16)``.

Weights come from ``variables=`` (a flax-style tree of numpy arrays, or a
state dict) or from a weights path: an ``.npz`` export (``var::`` naming,
see scripts/export_flax_variables.py) for either model, or an upstream
PyTorch checkpoint (``.pth`` / ``.pth.tar``, checkpoint.py) for the
vocoder and FastSpeech2 (with or without the CWT branch); without
either, seeded random weights.
"""

import json
import math
import os

import numpy as np
import torch

from tts_king_torch.checkpoint import (convert_fs2_checkpoint,
                                       convert_hifigan_checkpoint,
                                       convert_melgan_checkpoint)
from tts_king_torch.config import TTSConfig
from tts_king_torch.models.fs2 import build_fastspeech2
from tts_king_torch.models.hifigan import Generator
from tts_king_torch.models.melgan import MelGANGenerator
from tts_king_torch.ops.streaming import (generator_receptive_field,
                                          stream_vocoder)
from tts_king_torch.weights import (flax_to_torch, load_flax_npz, load_into,
                                    seeded_state_dict)

MEL_BUCKETS = (128, 256, 512, 1000)
# Typical frames-per-phoneme headroom used to pick the first mel bucket.
_FRAMES_PER_PHONE_GUESS = 8.0


def _bucket(n, buckets):
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _phone_pad(n, buckets=None):
    """Phoneme padding length: the tuned grid ``buckets`` when it covers n,
    else the next power of two from 16 up, at most 1024. A tuned grid holds
    only the lengths of past load, so a longer request still pads up (a pad
    clamped to the grid's top could not hold it)."""
    if buckets and n <= buckets[-1]:
        return _bucket(n, buckets)
    b = 16
    while b < n:
        b *= 2
    return min(b, 1024)


def load_speakers(path):
    """speakers.json: {name: id} (fsapi.py:85-96)."""
    with open(path) as f:
        speakers = json.load(f)
    return speakers, list(speakers.keys())


def load_stats(path):
    with open(path) as f:
        return json.load(f)


def resolve_device(device):
    """torch.device for ``device``; a CUDA device must exist."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the port on the CPU")
    return device


def to_device(array, device):
    """A numpy array as a tensor on ``device``. A CUDA copy goes through
    pinned memory and does not wait: a copy from pageable memory first waits
    for all the work queued on the current stream."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def wav_to_int16(wav, scale):
    """Scale a float waveform and cast it f32 -> int32 -> int16. The int32
    hop truncates toward zero and then wraps (+1.0 * 32768 -> -32768), as
    the reference's numpy ``astype(np.int16)`` does; a direct cast to int16
    need not."""
    return (wav * scale).to(torch.int32).to(torch.int16)


def _check_dtype(dtype):
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dtype {dtype}: float32 or bfloat16")
    return dtype


def _state_dict(variables):
    """A flax-style tree or a state dict -> a state dict of tensors."""
    if any(isinstance(k, str) and "." in k for k in variables):
        return {k: torch.as_tensor(np.asarray(v) if not isinstance(
            v, torch.Tensor) else v) for k, v in variables.items()}
    return flax_to_torch(variables)


def _weights_from_path(path, what, convert_torch):
    """A state dict from an npz export, or from a PyTorch checkpoint through
    the model's converter ``convert_torch``."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{what}: orbax checkpoint directories are not read by the port; "
            "export one to npz with scripts/export_flax_variables.py")
    if path.endswith(".npz"):
        return flax_to_torch(load_flax_npz(path))
    return convert_torch(path)


def round_variables(module, dtype):
    """Round ``module``'s floating parameters and buffers to ``dtype`` in
    place, keeping their f32 storage (the JAX AcousticModel's cast of its
    variable tree), and fix each BatchNorm's eval multiplier as flax
    computes it on such variables: rsqrt(var + eps) in ``dtype`` (eps, the
    sum and the rsqrt each rounded), its product with the scale in f32,
    unrounded."""
    from tts_king_torch.models.layers import BatchNorm

    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            if t.is_floating_point():
                t.copy_(t.to(dtype))
        for m in module.modules():
            if isinstance(m, BatchNorm):
                eps = float(torch.tensor(m.eps, dtype=dtype))
                inv = torch.rsqrt((m.running_var + eps).to(dtype).float())
                m.eval_mul = inv.to(dtype).float() * m.weight
    return module


def _materialize(build, variables, weights_path, device, seed, what,
                 convert_torch):
    """Build a module on the meta device (no init, no global RNG), allocate
    it on ``device``, fill it and set eval mode."""
    with torch.device("meta"):
        module = build()
    if variables is not None:
        sd = _state_dict(variables)
    elif weights_path and os.path.exists(weights_path):
        sd = _weights_from_path(weights_path, what, convert_torch)
    else:
        sd = seeded_state_dict(module, seed)
    module = module.to_empty(device=device)
    load_into(module, sd)
    return module.eval()


class AcousticModel:
    """FastSpeech2 inference driver (FSTWOapi equivalent, fsapi.py:9-82)."""

    def __init__(self, config: TTSConfig, variables=None, n_speakers=None,
                 stats=None, dtype=torch.float32, device="cuda"):
        self.device = resolve_device(device)
        self.dtype = _check_dtype(dtype)
        self.config = config
        weights_path = config.acoustic.weights_path
        model_dir = os.path.dirname(weights_path) if weights_path else None

        speakers_json = (os.path.join(model_dir, "speakers.json")
                         if model_dir else None)
        if speakers_json and os.path.exists(speakers_json):
            self.speakers_dict, self.speaker_names = load_speakers(speakers_json)
        else:
            n = n_speakers or 1
            self.speakers_dict = {str(i): i for i in range(n)}
            self.speaker_names = list(self.speakers_dict)

        if stats is None:
            stats_json = (os.path.join(model_dir, "stats.json")
                          if model_dir else None)
            if stats_json and os.path.exists(stats_json):
                stats = load_stats(stats_json)
            else:
                stats = {"pitch": [-3.0, 9.5], "energy": [-1.5, 6.1]}

        n_spk = n_speakers or len(self.speaker_names)
        tc = config.model.transformer
        self.model = _materialize(
            lambda: build_fastspeech2(config.model, stats, n_spk),
            variables, weights_path, self.device, 0,
            "AcousticModel", lambda path: convert_fs2_checkpoint(
                path, tc.encoder_layer, tc.decoder_layer,
                config.model.use_cwt))
        if self.dtype != torch.float32:
            round_variables(self.model, self.dtype)
        self.phone_buckets = None   # optional tuned L-padding grid

    def check_ids(self, phonemes, speaker_ids):
        """Raise ValueError for a phoneme or speaker id outside the model's
        embedding tables. On the card such an id is a device-side assert,
        which ends the process (the JAX package clamps it silently)."""
        n_sym = self.model.encoder.src_word_emb.num_embeddings
        phonemes = np.asarray(phonemes)
        if phonemes.size and (phonemes.min() < 0 or phonemes.max() >= n_sym):
            raise ValueError(f"phoneme ids must be in [0, {n_sym})")
        emb = getattr(self.model, "speaker_emb", None)
        ids = np.asarray(speaker_ids)
        if emb is not None and ids.size and (
                ids.min() < 0 or ids.max() >= emb.num_embeddings):
            raise ValueError(f"speaker ids must be in [0, "
                             f"{emb.num_embeddings})")

    @torch.inference_mode()
    def generate(self, phonemes, duration_control=1.0, pitch_control=1.0,
                 energy_control=1.0, speaker_name=None, max_mel_len=None,
                 src_lens=None, defer_overflow=False):
        """phonemes: (B, L) ints -> dict of device tensors (postnet_mel
        (B, T, 80), mel_lens, mel_lens_raw, ...) and ``mel_bucket``, T.

        Pads L up to a bucket (``phone_buckets`` where it covers L); picks
        and escalates the mel bucket until the predicted raw lengths fit.
        max_mel_len pins one bucket (not clamped to max_seq_len: positional
        sinusoids regenerate past it). src_lens: per-item phoneme counts for
        ragged batches (default: L).

        defer_overflow=True runs the first bucket only and returns without
        waiting for the card: the caller holds mel_lens_raw against
        ``mel_bucket`` when it fetches the results anyway, and redoes the
        (rare) overflow itself (serve.py's pipeline).
        """
        phonemes = np.asarray(phonemes)
        B, L = phonemes.shape
        Lb = _phone_pad(L, self.phone_buckets)
        texts = np.zeros((B, Lb), np.int64)
        texts[:, :L] = phonemes
        src_lens = (np.asarray(src_lens, np.int32) if src_lens is not None
                    else np.full((B,), L, np.int32))
        speaker_ids = self._resolve_speakers(speaker_name, B)
        self.check_ids(texts, speaker_ids)

        if max_mel_len is not None:
            buckets = [max_mel_len]
        else:
            guess = int(L * _FRAMES_PER_PHONE_GUESS * duration_control)
            start = _bucket(guess, MEL_BUCKETS)
            buckets = ([b for b in MEL_BUCKETS if b >= start]
                       or [self.config.model.max_seq_len])

        dev = self.device
        texts_t = to_device(texts, dev)
        src_lens_t = to_device(src_lens, dev)
        speakers_t = to_device(speaker_ids.astype(np.int64), dev)
        out = None
        for T in buckets:
            out = self.model(speakers_t, texts_t, src_lens_t, max_mel_len=T,
                             p_control=pitch_control, e_control=energy_control,
                             d_control=duration_control)
            # escalate on the RAW length: mel_lens is clamped to T in-model
            if defer_overflow or int(out["mel_lens_raw"].max()) <= T:
                break
        out["mel_bucket"] = T
        return out

    def _resolve_speakers(self, speaker_name, batch_size):
        """Scalar name/id or per-item sequence -> (B,) int32 ids."""
        if speaker_name is None:
            return np.zeros((batch_size,), np.int32)
        if isinstance(speaker_name, str):
            if speaker_name not in self.speakers_dict:
                raise KeyError(f"Speaker {speaker_name!r} not in speakers.json")
            return np.full((batch_size,), self.speakers_dict[speaker_name],
                           np.int32)
        arr = np.asarray(speaker_name)
        if arr.ndim == 0:
            return np.full((batch_size,), int(arr), np.int32)
        ids = [self.speakers_dict[s] if isinstance(s, str) else int(s)
               for s in speaker_name]
        if len(ids) != batch_size:
            raise ValueError("per-item speakers must match batch size")
        return np.asarray(ids, np.int32)

    def generate_mel(self, *args, **kwargs):
        """The postnet mel and the mel lengths, like FSTWOapi.generate."""
        out = self.generate(*args, **kwargs)
        return out["postnet_mel"], out["mel_lens"]


class Vocoder:
    """Vocoder inference wrapper (HIFIapi equivalent, hifiapi.py:11-52), for
    both of the reference's vocoders (model_config.vocoder.model,
    fs_two/utils/model.py:46-99): HiFi-GAN, and MelGAN (the descript
    architecture; it consumes log10 mels, so natural-log mels are divided by
    ln 10, vocoder_infer:87-89)."""

    def __init__(self, config: TTSConfig, variables=None, dtype=torch.float32,
                 device="cuda"):
        self.device = resolve_device(device)
        self.dtype = _check_dtype(dtype)
        self.config = config
        self.kind = config.model.vocoder_model
        v = config.vocoder
        if self.kind == "MelGAN":
            ratios = tuple(v.upsample_rates)
            build = lambda: MelGANGenerator(ratios=ratios)
            convert = lambda path: convert_melgan_checkpoint(path, ratios)
        elif self.kind == "HiFi-GAN":
            build = lambda: Generator(v)
            convert = lambda path: convert_hifigan_checkpoint(
                path, n_ups=len(v.upsample_rates),
                n_kernels=len(v.resblock_kernel_sizes))
        else:
            raise ValueError(f"unknown vocoder {self.kind!r} (HiFi-GAN or "
                             "MelGAN)")
        self.model = _materialize(build, variables, v.weights_path,
                                  self.device, 1, "Vocoder",
                                  convert).to(self.dtype)

    def _mel(self, mel):
        mel = (mel.to(self.device) if isinstance(mel, torch.Tensor)
               else to_device(np.asarray(mel), self.device))
        if self.kind == "MelGAN":
            # one IEEE division, as the JAX package divides (PyTorch's CUDA
            # kernels divide by a Python scalar through its reciprocal); the
            # divisor is filled on the device, so nothing waits for the card
            mel = mel / torch.full((), math.log(10.0), dtype=mel.dtype,
                                   device=mel.device)
        return mel

    @torch.inference_mode()
    def __call__(self, mel):
        """mel: (B, T, 80) natural-log mel -> f32 waveform (B, T * hop)."""
        return self.model(self._mel(mel))

    @torch.inference_mode()
    def vocode_int16(self, mel):
        """mel -> device int16 waveform scaled by max_wav_value."""
        return wav_to_int16(self.model(self._mel(mel)),
                            self.config.vocoder.max_wav_value)

    def generate(self, mel, lengths=None):
        """mel -> int16 numpy waveform (hifiapi.py:40-52); optional
        per-item sample lengths trim it into a list."""
        wav = self.vocode_int16(mel).cpu().numpy()
        if lengths is not None:
            return [w[:n] for w, n in zip(wav, np.asarray(lengths))]
        return wav


class TTSKing:
    """Text -> speech orchestrator (tts_king.py:18-66 equivalent)."""

    def __init__(self, config="./config.yaml", lexicon_path=None,
                 dtype=torch.float32, device="cuda", acoustic_variables=None,
                 vocoder_variables=None, n_speakers=None):
        device = resolve_device(device)
        if isinstance(config, str):
            from tts_king_torch.config import load_config

            config = load_config(config)
        self.cfg = config
        self.tts = AcousticModel(config, variables=acoustic_variables,
                                 n_speakers=n_speakers, dtype=dtype,
                                 device=device)
        self.vocoder = Vocoder(config, variables=vocoder_variables,
                               dtype=dtype, device=device)
        self.speakers = self.tts.speaker_names
        self._lexicon = None
        self._lexicon_path = lexicon_path or config.preprocess.lexicon_path

    @property
    def lexicon(self):
        if self._lexicon is None and os.path.exists(self._lexicon_path):
            from tts_king_torch.text.g2p import read_lexicon

            self._lexicon = read_lexicon(self._lexicon_path)
        return self._lexicon

    def text_preprocess(self, text):
        from tts_king_torch.text.g2p import preprocess_rus

        return np.array([preprocess_rus(text, lexicon=self.lexicon)])

    def generate_mel(self, text, duration_control=1.0, pitch_control=1.0,
                     energy_control=1.0, speaker=0):
        phonemes = self.text_preprocess(text)
        return self.tts.generate_mel(
            phonemes, duration_control, pitch_control, energy_control,
            speaker_name=speaker)

    def mel_to_wav(self, mel_spec, mel_lens=None):
        hop = self.cfg.preprocess.stft.hop_length
        lengths = None
        if mel_lens is not None:
            lengths = np.asarray(mel_lens.cpu() if isinstance(
                mel_lens, torch.Tensor) else mel_lens) * hop
        return self.vocoder.generate(mel_spec, lengths)

    def speak(self, text, duration_control=1.0, pitch_control=1.0,
              energy_control=1.0, speaker=0):
        mel, mel_lens = self.generate_mel(
            text, duration_control, pitch_control, energy_control, speaker)
        return self.mel_to_wav(mel, mel_lens)

    def speak_streaming(self, text, duration_control=1.0, pitch_control=1.0,
                        energy_control=1.0, speaker=0, chunk_frames=64):
        """Yield int16 numpy waveform chunks as they are vocoded: audio
        starts after one small vocoder window instead of the whole
        utterance. The halo is the HiFi-GAN generator's receptive field
        (generator_receptive_field(cfg.vocoder)), whatever the vocoder, as
        in the JAX package; each window is scaled and cast on the device."""
        mel, mel_lens = self.generate_mel(
            text, duration_control, pitch_control, energy_control, speaker)
        n = int(mel_lens[0])
        mel = mel[:1, :max(n, 1)].float().cpu().numpy()
        halo = generator_receptive_field(self.cfg.vocoder)
        yield from stream_vocoder(
            lambda piece: self.vocoder.vocode_int16(piece).cpu().numpy(),
            mel, chunk_frames=chunk_frames, halo_frames=halo,
            hop=self.cfg.preprocess.stft.hop_length)
