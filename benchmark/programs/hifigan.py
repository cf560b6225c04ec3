"""HiFi-GAN on the program's side: the port's vocoder configuration and
generator for a configuration's ``vocoder`` dict (core/program.py says what
a family's file gives)."""

# The name tts_king_torch's TTSConfig gives this vocoder (model.vocoder_model).
PROGRAM_NAME = "HiFi-GAN"

KEYS = ("upsample_rates", "upsample_kernel_sizes", "upsample_initial_channel",
        "resblock", "resblock_kernel_sizes", "resblock_dilation_sizes",
        "num_mels", "hop_size", "sampling_rate", "max_wav_value")


def vocoder_config(v):
    """tts_king_torch's VocoderModelConfig fields."""
    return {k: v[k] for k in KEYS if k in v}


def generator(tc, v):
    """The port's generator for TTSConfig ``tc``."""
    from tts_king_torch.models.hifigan import Generator

    return Generator(tc.vocoder)
