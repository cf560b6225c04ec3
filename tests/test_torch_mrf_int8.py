"""The port's int8 MRF stage on the CPU against the JAX package: the weight
quantization against ``pack_mrf_stage(int8=True)``, the plain int8 stage
against ``mrf_stage_apply(mode="int8")`` (the Pallas kernel in interpret
mode, as tests/test_pallas_mrf_packed.py runs it), the tile-window
arithmetic against ``ops/convs.pack_kernel_1d``, and the
``Generator(mrf_backend="fused_int8")`` against the committed JAX golden
(scripts/export_int8_vocoder_golden.py).

On the CPU the wrapper computes its plain version; the CUDA kernel is held
against the same plain version on the card by chip_smoke.py.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_king_torch.ops.kernels import mrf_int8
from tts_king_torch.ops.kernels.mrf import MrfStageWeights, mrf_stage_plain

KS = (3, 7, 11)
DIL = (1, 3, 5)
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                      "torch_port", "golden_int8_vocoder.npz")
# Plain int8 stage vs the JAX int8 kernel: both quantize the same f32 values
# with the same operations and sum the integer products exactly, so they
# differ only where XLA's f32 dequantization rounds otherwise (measured
# 6.4e-8 relative L2). The tile-shifted control misses by 9.8e-4 or more.
STAGE_REL_TOL = 1e-5
# Generator vs the JAX int8 golden: the convs outside the MRF stages (f32,
# summed in other orders) differ from XLA's by ~6e-7, which moves a few
# values across a rounding boundary of the activation quantization (each
# such flip moves one product by one quantization step). Measured 8.8e-4 on
# the CPU; a stage tiling shifted by half a window gives 5.2e-3, shifted by
# one packed row 1.5e-3.
GOLDEN_REL_TOL = 1.25e-3


def _segment_gain(rng, B, T, C, seg=8):
    """x of unit variance scaled by 10^U(-1, 1) per segment of ``seg``
    steps, so that the windows' scales differ."""
    x = rng.randn(B, T, C).astype(np.float32)
    gain = 10.0 ** rng.uniform(-1, 1, (B, T // seg, 1, 1))
    return (x.reshape(B, T // seg, seg, C) * gain).reshape(B, T, C).astype(
        np.float32)


def _stage(C, T, B=2, seed=0):
    """x and flax-layout branch params of N(0, 0.05^2)."""
    from tts_king_tpu.models.hifigan import ResBlock1

    rng = np.random.RandomState(seed)
    x = _segment_gain(rng, B, T, C)
    params = []
    for i, k in enumerate(KS):
        shapes = jax.eval_shape(lambda: ResBlock1(C, k, DIL).init(
            jax.random.PRNGKey(i), jnp.asarray(x)))["params"]
        params.append(jax.tree.map(
            lambda s: (rng.randn(*s.shape) * 0.05).astype(np.float32),
            shapes))
    return x, params


def _chain(p, leaf):
    return [np.asarray(p[f"{g}_{j}"][leaf]) for j in range(len(DIL))
            for g in ("convs1", "convs2")]


def _port_stage(params):
    """The same branches as MrfStageWeights (Conv1d layout)."""
    to_w = lambda k: torch.from_numpy(np.ascontiguousarray(k.transpose(2, 1,
                                                                       0)))
    return MrfStageWeights(
        KS, DIL, [[to_w(k) for k in _chain(p, "kernel")] for p in params],
        [[torch.from_numpy(b) for b in _chain(p, "bias")] for p in params])


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("r", [1, 2, 4])
def test_weight_quantization_matches_pack_mrf_stage(r):
    """At r = 1 the int8 taps and scales equal pack_mrf_stage's exactly; at
    r > 1 its per-lane scales are the port's per-channel scales tiled r
    times, and biases stay f32."""
    from tts_king_tpu.ops.pallas.mrf_packed import pack_mrf_stage

    _, params = _stage(16, 64)
    q = mrf_int8.quantize_mrf_stage(_port_stage(params))
    taps, biases, scales, _ = pack_mrf_stage(
        [_chain(p, "kernel") for p in params],
        [_chain(p, "bias") for p in params], KS, DIL, r, int8=True)
    C = q.channels
    np.testing.assert_array_equal(np.asarray(scales),
                                  np.tile(q.scales[:, :C].numpy(), (1, r)))
    np.testing.assert_array_equal(np.asarray(biases),
                                  np.tile(q.biases[:, :C].numpy(), (1, r)))
    assert q.scales.dtype == q.biases.dtype == torch.float32
    # the kernel's layout is zero past C
    assert not q.scales[:, C:].any() and not q.biases[:, C:].any()
    Cp = mrf_int8.padded_channels(C)
    blocks = torch.split(q.taps, [k * Cp * Cp for k in KS
                                  for _ in range(2 * len(DIL))])
    assert all(not b.view(-1, Cp, Cp)[:, C:].any()
               and not b.view(-1, Cp, Cp)[:, :, C:].any() for b in blocks)
    if r == 1:
        # "wide" layout: conv n's taps side by side, (C_in, k * C_out)
        port = np.concatenate(
            [np.concatenate(list(t.numpy().transpose(2, 1, 0)), axis=1)
             for row in q.conv_taps() for t in row], axis=1)
        assert np.asarray(taps).dtype == np.int8
        np.testing.assert_array_equal(np.asarray(taps), port)


@pytest.mark.parametrize("k,d,r", [(3, 1, 1), (11, 5, 1), (3, 1, 8),
                                   (7, 3, 2), (11, 5, 4), (11, 3, 8)])
def test_packed_halo_matches_pack_kernel_1d(k, d, r):
    from tts_king_tpu.ops.convs import pack_kernel_1d

    _, (pl, pr) = pack_kernel_1d(jnp.zeros((k, 2, 2)), r, dilation=d)
    assert mrf_int8.packed_halo(k, d, r) == pl == pr


@pytest.mark.parametrize("C,r,T,tile", [(32, 4, 512, 64), (16, 2, 128, 32),
                                        (8, 1, 128, 32)])
def test_plain_int8_stage_matches_pallas_int8(C, r, T, tile):
    """The plain int8 stage against the JAX int8 kernel within
    STAGE_REL_TOL; the same function on tiles shifted by half a tile misses
    by at least 10x that (the windows, not only the weights, fix the
    output); both within the JAX bound (rel < 0.05) of the unquantized
    stage."""
    from tts_king_tpu.ops.pallas.mrf_packed import mrf_stage_apply

    x, params = _stage(C, T)
    xp = jnp.asarray(x).reshape(x.shape[0], T // r, r * C)
    ref = np.asarray(mrf_stage_apply(xp, params, KS, DIL, r, tile=tile,
                                     mode="int8", interpret=True))
    ref = ref.reshape(x.shape)
    stage = _port_stage(params)
    q = mrf_int8.quantize_mrf_stage(stage)
    xt = torch.from_numpy(x)
    got = mrf_int8.mrf_stage_int8_plain(xt, q, r, tile).numpy()
    assert got.shape == x.shape and got.dtype == np.float32
    assert _rel(got, ref) < STAGE_REL_TOL
    shifted = mrf_int8._stage_tiles(xt, q, r, tile, tile // 2).numpy()
    assert _rel(shifted, ref) >= 10 * STAGE_REL_TOL
    f32 = mrf_stage_plain(xt, stage).numpy()
    assert _rel(got, f32) < 0.05 and _rel(ref, f32) < 0.05


def test_cpu_wrapper_is_the_plain_version():
    x, params = _stage(16, 128, seed=3)
    q = mrf_int8.quantize_mrf_stage(_port_stage(params))
    xt = torch.from_numpy(x)
    before = mrf_int8.launches
    np.testing.assert_array_equal(
        mrf_int8.mrf_stage_int8(xt, q, 2, 32).numpy(),
        mrf_int8.mrf_stage_int8_plain(xt, q, 2, 32).numpy())
    assert mrf_int8.launches == before   # no kernel launch on the CPU
    with pytest.raises(ValueError, match="device"):
        mrf_int8.mrf_stage_int8(xt.to("meta"), q, 2, 32)


def test_tile_geometry_matches_the_tpu_kernel():
    """The shipped stages at T_mel = 1000: r, the 1024-row tile and the
    k = 11 windows of the table in the kernel's notes."""
    for C, T, r, window in ((128, 64000, 1, 1144), (64, 128000, 2, 2180),
                            (32, 256000, 4, 4248)):
        assert mrf_int8.pack_factor(C, T) == r
        assert mrf_int8.tile_rows(T, r) == 1024
        assert r * 1024 + 2 * sum(mrf_int8.conv_halos(11, DIL, r)) == window
    assert mrf_int8.pack_factor(16, 2400) == 8
    assert mrf_int8.pack_factor(16, 2404) == 4   # T % r halves r
    assert mrf_int8.tile_rows(2400, 8) == 304    # Mp = 300, rounded up to 8


def _golden_generators():
    from tts_king_torch.config import VocoderModelConfig
    from tts_king_torch.models.hifigan import Generator
    from tts_king_torch.weights import flax_to_torch, load_flax_npz, load_into

    z = np.load(GOLDEN)
    cfg = VocoderModelConfig(**json.loads(str(z["meta::config"])))
    sd = flax_to_torch(load_flax_npz(GOLDEN))
    return z, {b: load_into(Generator(cfg, mrf_backend=b), sd).eval()
               for b in ("fused_int8", "fused")}


def test_int8_generator_matches_jax_golden():
    """B = 2, T_mel = 600: stage 1 (C = 8, r = 8) spans two 1024-row
    windows, the second partial; stage 0 one padded window."""
    z, gens = _golden_generators()
    mel = torch.from_numpy(z["in::mel"])
    with torch.no_grad():
        wav8 = gens["fused_int8"](mel).numpy()
        wav32 = gens["fused"](mel).numpy()
    ref8, ref32 = z["out::wav_int8"], z["out::wav_f32"]
    assert wav8.shape == ref8.shape == (2, 600 * 16)
    assert _rel(wav8, ref8) < GOLDEN_REL_TOL
    np.testing.assert_allclose(wav32, ref32, rtol=1e-5, atol=1e-5)
    snr = 20 * np.log10(np.linalg.norm(ref32) / np.linalg.norm(wav8 - ref32))
    assert snr > 25.0, snr


def test_int8_generator_requantizes_on_load():
    """Loading other weights into an int8 Generator replaces its int8
    buffers; requantize() after an in-place change does the same."""
    z, gens = _golden_generators()
    gen = gens["fused_int8"]
    before = gen.mrf_int8_1_taps.clone()
    g = torch.Generator().manual_seed(0)
    sd = {k: v + 0.05 * torch.randn(v.shape, generator=g)
          for k, v in gen.state_dict().items()}
    gen.load_state_dict(sd)
    assert not torch.equal(gen.mrf_int8_1_taps, before)
    with torch.no_grad():
        gen.resblocks_3.convs1_0.weight.mul_(2.0)
    gen.requantize()
    np.testing.assert_array_equal(
        gen._int8_stage(1, gen._fused_stage(gen._stage_blocks(1), 8))
        .conv_taps()[0][0].numpy(),
        mrf_int8.quantize_weights(gen.resblocks_3.convs1_0.weight)[0].numpy())


def test_int8_generator_quantizes_only_f32_weights():
    """The int8 stages are quantized from the f32 weights: loading into a
    Generator already cast to bf16 raises instead of quantizing the rounded
    weights; loading first and casting after keeps the f32 quantization."""
    from tts_king_torch.models.hifigan import Generator

    _, gens = _golden_generators()
    sd = gens["fused"].state_dict()
    cast_first = Generator(gens["fused"].config,
                           mrf_backend="fused_int8").to(torch.bfloat16)
    with pytest.raises(TypeError, match="f32"):
        cast_first.load_state_dict(sd)
    loaded_first = Generator(gens["fused"].config, mrf_backend="fused_int8")
    loaded_first.load_state_dict(sd)
    loaded_first.to(torch.bfloat16)
    for n, t in gens["fused_int8"].named_buffers():
        assert torch.equal(getattr(loaded_first, n), t), n
