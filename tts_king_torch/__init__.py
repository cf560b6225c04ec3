"""tts_king_torch: the PyTorch / CUDA (NVIDIA H100) port of tts_king_tpu.

Inference path of the TTS stack — Russian G2P, FastSpeech2, HiFi-GAN — with
the JAX package's two Pallas kernels on this path rewritten as CUDA kernels
for sm_90a (``csrc/``), each beside a plain PyTorch version that is the CPU
path and the kernel's test oracle. The package imports torch, numpy and the
standard library only; nothing of JAX or of tts_king_tpu.

Entry points: ``tts_king_torch.pipeline.TTSKing`` / ``AcousticModel`` /
``Vocoder``, and the server ``tts_king_torch.serve.SynthesisServer``
(``python -m tts_king_torch.serve``). They run on CUDA unless given
``device="cpu"``.
"""
