"""End-to-end synthesis pipeline: text -> phonemes -> mel -> waveform.

Port of tts_king_tpu/pipeline.py (API of the reference tts_king.py TTSKing,
fsapi.py FSTWOapi, hifiapi.py HIFIapi), inference with HiFi-GAN:
  * phoneme lengths pad up to power-of-two buckets;
  * the mel length starts at a bucket guessed from the phoneme count and
    escalates through MEL_BUCKETS while the model's raw (unclamped) length
    overflows the bucket;
  * the waveform is scaled by max_wav_value and cast f32 -> int32 -> int16
    on the device, which wraps at full scale as numpy's astype does.

Every entry point takes ``device`` (default "cuda", which raises when CUDA is
missing; the CPU is used only when asked for) and ``dtype`` (float32 or
bfloat16: the dtype of the weights and activations, as in the JAX bench's
``build_fastspeech2(dtype=...)`` and ``Generator(dtype=...)``).

Weights come from ``variables=`` (a flax-style tree of numpy arrays, or a
state dict) or from an ``.npz`` weights path (``var::`` naming, see
scripts/export_flax_variables.py); without either, seeded random weights.
"""

import json
import os

import numpy as np
import torch

from tts_king_torch.config import TTSConfig
from tts_king_torch.models.fs2 import build_fastspeech2
from tts_king_torch.models.hifigan import Generator
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


def _phone_pad(n):
    """Phoneme padding length: the next power of two from 16 up, at most
    1024."""
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


def _weights_from_path(path, what):
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{what}: orbax checkpoint directories are not read by the port; "
            "export one to npz with scripts/export_flax_variables.py")
    if path.endswith(".npz"):
        return flax_to_torch(load_flax_npz(path))
    raise NotImplementedError(
        f"{what}: {os.path.basename(path)}: reference .pth.tar checkpoints "
        "are loaded in a later slice of the port; use an .npz export")


def _materialize(build, variables, weights_path, device, dtype, seed, what):
    """Build a module on the meta device (no init, no global RNG), allocate
    it on ``device``, fill it, cast it to ``dtype`` and set eval mode."""
    with torch.device("meta"):
        module = build()
    if variables is not None:
        sd = _state_dict(variables)
    elif weights_path and os.path.exists(weights_path):
        sd = _weights_from_path(weights_path, what)
    else:
        sd = seeded_state_dict(module, seed)
    module = module.to_empty(device=device)
    load_into(module, sd)
    return module.to(dtype).eval()


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
        self.model = _materialize(
            lambda: build_fastspeech2(config.model, stats, n_spk),
            variables, weights_path, self.device, self.dtype, 0,
            "AcousticModel")

    @torch.inference_mode()
    def generate(self, phonemes, duration_control=1.0, pitch_control=1.0,
                 energy_control=1.0, speaker_name=None, max_mel_len=None,
                 src_lens=None):
        """phonemes: (B, L) ints -> dict of device tensors (postnet_mel
        (B, T, 80), mel_lens, mel_lens_raw, ...).

        Pads L up to a bucket; picks and escalates the mel bucket until the
        predicted raw lengths fit. max_mel_len pins one bucket (not clamped
        to max_seq_len: positional sinusoids regenerate past it).
        src_lens: per-item phoneme counts for ragged batches (default: L).
        """
        phonemes = np.asarray(phonemes)
        B, L = phonemes.shape
        Lb = _phone_pad(L)
        texts = np.zeros((B, Lb), np.int64)
        texts[:, :L] = phonemes
        src_lens = (np.asarray(src_lens, np.int32) if src_lens is not None
                    else np.full((B,), L, np.int32))
        speaker_ids = self._resolve_speakers(speaker_name, B)

        if max_mel_len is not None:
            buckets = [max_mel_len]
        else:
            guess = int(L * _FRAMES_PER_PHONE_GUESS * duration_control)
            start = _bucket(guess, MEL_BUCKETS)
            buckets = ([b for b in MEL_BUCKETS if b >= start]
                       or [self.config.model.max_seq_len])

        dev = self.device
        texts_t = torch.from_numpy(texts).to(dev)
        src_lens_t = torch.from_numpy(src_lens).to(dev)
        speakers_t = torch.from_numpy(speaker_ids.astype(np.int64)).to(dev)
        out = None
        for T in buckets:
            out = self.model(speakers_t, texts_t, src_lens_t, max_mel_len=T,
                             p_control=pitch_control, e_control=energy_control,
                             d_control=duration_control)
            # escalate on the RAW length: mel_lens is clamped to T in-model
            if int(out["mel_lens_raw"].max()) <= T:
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
    """HiFi-GAN inference driver (HIFIapi equivalent, hifiapi.py:11-52)."""

    def __init__(self, config: TTSConfig, variables=None, dtype=torch.float32,
                 device="cuda"):
        self.device = resolve_device(device)
        self.dtype = _check_dtype(dtype)
        self.config = config
        self.kind = config.model.vocoder_model
        if self.kind != "HiFi-GAN":
            raise NotImplementedError(
                f"vocoder {self.kind!r}: only HiFi-GAN is ported so far; "
                "MelGAN comes in a later slice")
        self.model = _materialize(
            lambda: Generator(config.vocoder), variables,
            config.vocoder.weights_path, self.device, self.dtype, 1, "Vocoder")

    def _mel(self, mel):
        return torch.as_tensor(np.asarray(mel) if not isinstance(
            mel, torch.Tensor) else mel).to(self.device)

    @torch.inference_mode()
    def __call__(self, mel):
        """mel: (B, T, 80) natural-log mel -> f32 waveform (B, T*256)."""
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

    def speak_streaming(self, *args, **kwargs):
        raise NotImplementedError(
            "speak_streaming is not ported yet; it comes in a later slice")
