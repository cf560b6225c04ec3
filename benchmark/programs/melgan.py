"""MelGAN on the program's side: the port's vocoder configuration and
generator for a configuration's ``vocoder`` dict (core/program.py says what
a family's file gives)."""

# The name tts_king_torch's TTSConfig gives this vocoder (model.vocoder_model).
PROGRAM_NAME = "MelGAN"

KEYS = ("upsample_rates", "num_mels", "hop_size", "sampling_rate",
        "max_wav_value")


def vocoder_config(v):
    """tts_king_torch's VocoderModelConfig fields."""
    if (v["ngf"], v["n_residual_layers"]) != (32, 3):
        raise ValueError("the port's MelGAN is ngf 32 with 3 residual layers")
    return {k: v[k] for k in KEYS if k in v}


def generator(tc, v):
    """The port's generator for TTSConfig ``tc``."""
    from tts_king_torch.models.melgan import MelGANGenerator

    return MelGANGenerator(mel_channels=v["num_mels"],
                           ratios=tuple(v["upsample_rates"]))
