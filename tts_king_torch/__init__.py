"""tts_king_torch: the PyTorch / CUDA (NVIDIA H100) port of tts_king_tpu.

Inference path of the TTS stack — Russian G2P, FastSpeech2, HiFi-GAN — with
the JAX package's two Pallas kernels on this path rewritten as CUDA kernels
for sm_90a (``csrc/``), each beside a plain PyTorch version that is the CPU
path and the kernel's test oracle. The package imports torch, numpy and the
standard library only; nothing of JAX or of tts_king_tpu.

Entry points: ``tts_king_torch.pipeline.TTSKing`` / ``AcousticModel`` /
``Vocoder``, the server ``tts_king_torch.serve.SynthesisServer``
(``python -m tts_king_torch.serve``), the data, training and vocoder
training CLIs (``python -m tts_king_torch.data``, ``.train``,
``.train.vocoder_loop``), the tools (``python -m
tts_king_torch.tools.make_base_mels``, ``.synthesize``, ``.evaluate``,
``.speaker_stats``) and the examples (``tts_king_torch.examples``). They
run on CUDA unless given ``device="cpu"`` (``--device cpu``).
"""
