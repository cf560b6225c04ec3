"""The vocoder families' plain references, found by name, and what they
share: the precisions a generator computes in and the int16 cast of the
waveform.

A configuration's family is its ``model.vocoder_model`` lower-cased, with
everything but letters and digits dropped ("HiFi-GAN" -> ``hifigan``,
"MelGAN" -> ``melgan``). Its reference is ``benchmark/reference/<family>.py``
(``find``), which imports nothing of the program and gives:
  generate(sd, v, mel, precision="float32")
                mel (T, n_mel) natural-log -> waveform (T * hop,) in
                [-1, 1], from a state dict keyed as the program's module
                and the configuration's ``vocoder`` dict;
  flops_per_frame(v)
                the generator's FLOPs a mel frame (``mfu.bulk``);
  MICRO         the ``vocoder`` widths the CPU tests replace (may be {});
  WEIGHT_RULES  (optional) {regular expression: rule} for the tensors that
                core/weights.py's general rule does not fit, such as a fixed
                filter or a log-scale activation parameter: a rule takes the
                tensor's N(0, 1) draw and returns its value.
Its program side is ``benchmark/programs/<family>.py`` (core/program.py).

``precision`` is how a generator computes:
  "float32"   every op in float32 (TF32 off by the caller);
  "bfloat16"  as PyTorch computes a bfloat16 module: every tensor held in
              bfloat16 (the mel rounded on the way in, each op's result
              rounded), each conv's products of bfloat16 inputs and
              weights summed in float32 and rounded before its bias is
              added and rounded again; the tanh in float32;
  "float8"    the lower-precision control: each conv's input and weight
              rounded to float8 e4m3 with one scale per tensor, products
              summed in float32, the rest in float32.
"""

import importlib
import re

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def _fp8(t):
    scale = t.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _ops(precision):
    """(conv, transposed conv, rounding of every other op's result) in
    ``precision``; each conv takes (x, w, b, **conv kwargs)."""
    def make(fn, cast_in, cast_out):
        def conv(x, w, b, **k):
            y = fn(cast_in(x), cast_in(w), None, **k)
            return cast_out(cast_out(y) + cast_out(b)[:, None])
        return conv

    keep = lambda t: t
    if precision == "float32":
        cast_in, cast_out, r = keep, keep, keep
    elif precision == "bfloat16":
        cast_in, cast_out, r = _bf16, _bf16, _bf16
    elif precision == "float8":
        cast_in, cast_out, r = _fp8, keep, keep
    else:
        raise ValueError(precision)
    return (make(F.conv1d, cast_in, cast_out),
            make(F.conv_transpose1d, cast_in, cast_out), r)


def family(vocoder_model):
    """The file name of a ``model.vocoder_model``'s family."""
    return re.sub(r"[^a-z0-9]", "", vocoder_model.lower())


def find(vocoder_model):
    """The reference of a ``model.vocoder_model``'s family, as a module."""
    return importlib.import_module(
        f"benchmark.reference.{family(vocoder_model)}")


def to_int16(wav, max_wav_value):
    """Scale and cast f32 -> int32 -> int16: truncation toward zero, then
    the wrap of numpy's astype (+1.0 x 32768 -> -32768)."""
    return (wav * max_wav_value).to(torch.int32).to(torch.int16)

