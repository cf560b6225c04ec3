"""A dilated conv1d folded by its dilation (tts_king_torch/ops/
dilated_conv.py) and BigVGAN's AMP convs on the CPU:

  * ``dilated_conv1d``, a dilated conv1d run as a dilation-free conv over
    time folded by the dilation, against ``F.conv1d(..., dilation=d)``: T a
    multiple of d, no multiple, and shorter than the taps span; f32 and
    bf16;
  * ``folds``' rule at the published BigVGAN-v2 layout: exactly the convs
    that PERF.md's probe table names fold, in bf16 and in f32;
  * the counters and spans of one generator call (108 AMP convs);
  * the micro-width generator with every dilated conv folded, against the
    benchmark's plain reference.
"""

import os
import sys

import pytest
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from benchmark.reference import bigvgan as reference  # noqa: E402
from tests.test_torch_bigvgan import (bigvgan_config,  # noqa: E402
                                      micro_config, ref_v, seeded)
from tts_king_torch.models import bigvgan  # noqa: E402
from tts_king_torch.ops import dilated_conv  # noqa: E402

# The convs that fold at the published layout, as (channels, kernel size,
# dilation), by dtype: PERF.md's probe table.
FOLDED = {
    torch.bfloat16: {(c, k, d) for c in (768, 384, 192)
                     for k, d in ((7, 5), (11, 3), (11, 5))},
    torch.float32: set(),
}


@pytest.fixture(autouse=True)
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _bf16_ulp(t):
    """One bf16 ulp at each value of a bf16-valued tensor (2^(e - 7))."""
    e = torch.floor(torch.log2(t.float().abs().clamp(min=2.0 ** -126)))
    return torch.exp2(e - 7)


def _lies_as_its_dtype(t):
    """Whether (B, C, T) ``t`` lies in its dtype's layout: bf16 in (B, T,
    C) memory, rows C apart; f32 contiguous (B, C, T)."""
    return dilated_conv.laid_out(t) is t


def _lengths(k, d):
    """T a multiple of d, one past it, and shorter than the taps span."""
    return {"multiple": 12 * d, "ragged": 12 * d + 1,
            "short": (k - 1) * d // 2 + 1}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("length", ["multiple", "ragged", "short"])
@pytest.mark.parametrize("d", [1, 3, 5])
@pytest.mark.parametrize("k", [3, 7, 11])
def test_fold_matches_the_dilated_conv(k, d, length, dtype):
    """f32 within 1e-6 of F.conv1d's largest value; bf16 within one bf16
    ulp of the f32 result on the bf16 inputs rounded once, or 1e-5 of the
    largest value where the sums cancel to near zero."""
    T = _lengths(k, d)[length]
    g = torch.Generator().manual_seed(100 * k + 10 * d + T)
    x = torch.randn(2, 16, T, generator=g)
    w = torch.randn(12, 16, k, generator=g) / (16 * k) ** 0.5
    b = torch.randn(12, generator=g)
    p = d * (k - 1) // 2
    if dtype == "f32":
        ref = F.conv1d(x, w, b, padding=p, dilation=d)
        got = dilated_conv.dilated_conv1d(x, w, b, d, p)
        assert got.shape == ref.shape == (2, 12, T) and _lies_as_its_dtype(got)
        assert float((got - ref).abs().max()) <= 1e-6 * float(
            ref.abs().max())
        return

    xb, wb, bb = x.bfloat16(), w.bfloat16(), b.bfloat16()
    ref = F.conv1d(xb.float(), wb.float(), bb.float(), padding=p, dilation=d)
    got = dilated_conv.dilated_conv1d(xb, wb, bb, d, p)
    assert got.dtype == torch.bfloat16
    assert got.shape == (2, 12, T) and _lies_as_its_dtype(got)
    rounded = ref.bfloat16().float()
    err = (got.float() - rounded).abs()
    room = torch.maximum(_bf16_ulp(rounded), torch.full_like(
        err, 1e-5 * float(ref.abs().max())))
    assert bool((err <= room).all()), float((err - room).max())


@pytest.mark.parametrize("channels", [16, 48])
@pytest.mark.parametrize("op", ["conv1d", "conv_transpose1d"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_convs_take_and_give_signals_in_their_dtypes_layout(dtype, op,
                                                            channels):
    """The convs give F.conv1d's and F.conv_transpose1d's sums on a (B, C,
    T) signal in its dtype's layout (bf16 channels-last, f32 (B, C, T)) and
    return one so laid, with the signal and the weight in either layout:
    f32 within 1e-6 of the largest value, bf16 within 1e-2 of it (bf16's
    rounding of the output)."""
    g = torch.Generator().manual_seed(channels)
    x = torch.randn(2, 37, channels, generator=g).transpose(1, 2).to(dtype)
    if op == "conv1d":
        w = torch.randn(24, channels, 7, generator=g) / (7 * channels) ** 0.5
        b = torch.randn(24, generator=g)
        ref = F.conv1d(x.float(), w, b, padding=6, dilation=2)
        call = lambda x, w: dilated_conv.conv1d(  # noqa: E731
            x, w, b.to(dtype), 6, 2)
    else:
        w = torch.randn(channels, 24, 8, generator=g) / (8 * channels) ** 0.5
        b = torch.randn(24, generator=g)
        ref = F.conv_transpose1d(x.float(), w, b, stride=4, padding=2)
        call = lambda x, w: dilated_conv.conv_transpose1d(  # noqa: E731
            x, w, b.to(dtype), 4, 2)
    room = (1e-6 if dtype == torch.float32 else 1e-2) * float(
        ref.abs().max())
    for signal in (x, x.contiguous()):
        for weight in (w.to(dtype), dilated_conv.channels_last(w.to(dtype))):
            got = call(signal, weight)
            assert got.shape == ref.shape and got.dtype == dtype
            assert _lies_as_its_dtype(got)
            assert float((got.float() - ref).abs().max()) <= room
    assert dilated_conv.channels_last_for(dtype) == (dtype == torch.bfloat16)


def test_weights_are_laid_out_for_the_modules_dtype():
    """BigVGAN's conv weights lie in their dtype's layout after ``to``, to
    bf16 and back, with their values (rounded to bf16 once) and the state
    dict's names and shapes unchanged."""
    model = bigvgan.BigVGAN(micro_config())
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    convs = [m for m in model.modules()
             if isinstance(m, (torch.nn.Conv1d, torch.nn.ConvTranspose1d))]
    for dtype in (torch.bfloat16, torch.float32):
        model.to(dtype)
        assert all(_lies_as_its_dtype(m.weight) for m in convs)
        got = model.state_dict()
        assert [(k, v.shape) for k, v in got.items()] == [
            (k, v.shape) for k, v in sd.items()]
        assert all(torch.equal(got[k].float(), sd[k].bfloat16().float())
                   for k in sd)


def test_fold_refuses_what_it_cannot_fold():
    x, w = torch.zeros(1, 2, 20), torch.zeros(2, 2, 3)
    with pytest.raises(ValueError, match="multiple"):
        dilated_conv.dilated_conv1d(x, w, None, 3, 2)


def _amp_convs(model):
    """(name, conv) of every AMP block conv in a BigVGAN."""
    return [(n, m) for n, m in model.named_modules()
            if ".convs" in n and isinstance(m, torch.nn.Conv1d)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rule_folds_the_convs_perf_names_at_the_published_layout(dtype):
    with torch.device("meta"):
        model = bigvgan.BigVGAN(bigvgan_config())
    convs = _amp_convs(model)
    assert len(convs) == 108
    got = {(c.in_channels, c.kernel_size[0], c.dilation[0]) for _, c in convs
           if dilated_conv.folds(c.in_channels, c.kernel_size[0],
                                 c.dilation[0], dtype)}
    assert got == FOLDED[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_counters_and_spans_per_generator_call(monkeypatch, dtype):
    """At the published layout on the meta device (shapes only; the
    activation left out): 108 AMP convs a call, each under one
    vocoder.amp_conv span and counted in bigvgan.amp_conv_calls, the
    rule's folds in amp_conv_folded (3 blocks a stage run each of its convs
    once)."""
    spans = []
    real_span = bigvgan.span

    def counting_span(name, *args):
        spans.append(name)
        return real_span(name, *args)

    monkeypatch.setattr(bigvgan, "span", counting_span)
    monkeypatch.setattr(bigvgan, "amp_act", lambda x, a, b: x)
    with torch.device("meta"):
        model = bigvgan.BigVGAN(bigvgan_config()).to(dtype)
        mel = torch.zeros(2, 7, 80)
    calls, folded = bigvgan.amp_conv_calls, bigvgan.amp_conv_folded
    with torch.no_grad():
        wav = model(mel)
    assert wav.shape == (2, 7 * 256)
    assert (spans.count("vocoder.amp_conv")
            == bigvgan.amp_conv_calls - calls == 108)
    assert bigvgan.amp_conv_folded - folded == len(FOLDED[dtype])


def test_folded_generator_matches_the_reference_at_micro_widths(
        monkeypatch):
    """Every dilated AMP conv folded (the rule folds none at micro widths),
    held to the reference at test_torch_bigvgan's tolerance."""
    monkeypatch.setattr(bigvgan, "folds", lambda c, k, d, dtype: d > 1)
    cfg = micro_config()
    model, sd = seeded(bigvgan.BigVGAN(cfg), 3)
    mel = torch.randn(2, 29, 80, generator=torch.Generator().manual_seed(1))
    folded = bigvgan.amp_conv_folded
    with torch.no_grad():
        got = model(mel)
    assert bigvgan.amp_conv_folded - folded == 6 * 3 * 2
    for b in range(2):
        ref = reference.generate(sd, ref_v(cfg), mel[b])
        assert float(ref.abs().max()) < 1.0
        assert float((got[b] - ref).abs().max()) < 1e-5
