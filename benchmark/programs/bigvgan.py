"""BigVGAN-v2 on the program's side: the port's vocoder configuration and
generator for a configuration's ``vocoder`` dict (core/program.py says what
a family's file gives)."""

# The name tts_king_torch's TTSConfig gives this vocoder (model.vocoder_model).
PROGRAM_NAME = "BigVGAN"

KEYS = ("upsample_rates", "upsample_kernel_sizes", "upsample_initial_channel",
        "resblock", "resblock_kernel_sizes", "resblock_dilation_sizes",
        "num_mels", "hop_size", "sampling_rate", "max_wav_value")


def vocoder_config(v):
    """tts_king_torch's VocoderModelConfig fields; BigVGAN's published
    keys (activation, snake_logscale, use_tanh_at_final, use_bias_at_final)
    are checked against the ones the port runs, which follow from the
    vocoder being BigVGAN."""
    from tts_king_torch.config import take_bigvgan_keys

    take_bigvgan_keys(v, PROGRAM_NAME)
    if v["upsample_initial_channel"] % 2 ** len(v["upsample_rates"]):
        raise ValueError("upsample_initial_channel must halve at every stage")
    return {k: v[k] for k in KEYS}


def generator(tc, v):
    """The port's generator for TTSConfig ``tc``."""
    from tts_king_torch.models.bigvgan import BigVGAN

    return BigVGAN(tc.vocoder)
