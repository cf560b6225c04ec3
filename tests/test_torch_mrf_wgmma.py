"""The bf16 MRF kernel's layout and tiling (csrc/mrf_stage.cu, mrf_stage_tc)
on the CPU: the packed tap layout that its wgmma B descriptor reads, the
tile plan that fixes its windows, m64 tiles and ring of tap slots, a plain
emulation of the stage computed tile by tile on that plan (against the
plain stage and the JAX Pallas kernel in interpret mode), and the
Generator's packing once per set of weights.

The kernel itself is held against the plain version on the card by
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from tts_king_torch.config import TTSConfig, VocoderModelConfig
from tts_king_torch.models import hifigan
from tts_king_torch.ops.kernels import mrf

KS = (3, 7, 11)
DIL = (1, 3, 5)
# chip_smoke.TOL's bf16 bound: 2^-5 of the output's largest magnitude
BF16_TOL = 2.0 ** -5


def _stage(C, kernel_sizes, dilations, dtype, seed):
    rng = np.random.RandomState(seed)
    ws = [[torch.from_numpy((rng.randn(C, C, k) / np.sqrt(C * k))
                            .astype(np.float32)).to(dtype)
           for _ in range(2 * len(dilations))] for k in kernel_sizes]
    bs = [[torch.from_numpy(0.05 * rng.randn(C).astype(np.float32)).to(dtype)
           for _ in range(2 * len(dilations))] for _ in kernel_sizes]
    return mrf.MrfStageWeights(tuple(kernel_sizes), tuple(dilations), ws, bs)


def _row_swizzle(n, Cp):
    """The 16-byte group XOR of row n, as the 128/64/32-byte swizzle modes
    define it on rows of 128, 64 and 32 bytes (8 rows per atom): n mod 8,
    (n / 2) mod 4, (n / 4) mod 2."""
    swb = mrf.swizzle_bytes(Cp)
    return {128: n % 8, 64: (n // 2) % 4, 32: (n // 4) % 2}[swb]


# (a) pack / unpack


@pytest.mark.parametrize("C", [16, 13, 32, 30, 64, 50, 128, 100])
def test_unpack_inverts_pack_zero_past_c(C):
    stage = _stage(C, KS, (1, 3), torch.bfloat16, seed=C)
    Cp = mrf._padded_channels(C)
    assert Cp in (16, 32, 64, 128)
    packed = mrf.pack_stage(stage)
    assert packed.taps.numel() == 2 * 2 * sum(KS) * Cp * Cp
    back = mrf.unpack_taps(packed.taps, KS, (1, 3), C)
    for got_b, want_b in zip(back, stage.weights):
        for got, want in zip(got_b, want_b):
            assert torch.equal(got, want)
    # every element outside the (C x C) corner of each tap is zero
    n, k = np.meshgrid(np.arange(Cp), np.arange(Cp), indexing="ij")
    outside = torch.from_numpy(
        mrf.tap_byte_offset(n, k, Cp)[(n >= C) | (k >= C)] // 2)
    taps = packed.taps.view(-1, Cp * Cp)
    assert not bool(taps[:, outside].float().abs().sum())
    assert not bool(packed.biases[:, C:].float().abs().sum())
    for got_b, want_b in zip(packed.unpack().biases, stage.biases):
        assert all(torch.equal(g, w) for g, w in zip(got_b, want_b))


# (b) the B descriptor's byte offsets


@pytest.mark.parametrize("Cp", [16, 32, 64, 128])
def test_tap_byte_offset_is_the_swizzled_k_major_layout(Cp):
    """tap_byte_offset against the layout written out row by row: chunks of
    swizzle_bytes / 2 input channels, each Cp rows of swizzle_bytes bytes,
    the 16-byte group XORed with the row's swizzle; a permutation of the
    tap's bytes that keeps 8 input channels in one 16-byte group."""
    swb = mrf.swizzle_bytes(Cp)
    n, k = np.meshgrid(np.arange(Cp), np.arange(Cp), indexing="ij")
    got = mrf.tap_byte_offset(n, k, Cp)
    kh, kk = k // (swb // 2), k % (swb // 2)
    want = (kh * Cp * swb + n * swb + 16 * ((kk // 8) ^ _row_swizzle(n, Cp))
            + 2 * (kk % 8))
    np.testing.assert_array_equal(got, want)
    assert sorted(got.reshape(-1)) == list(range(0, 2 * Cp * Cp, 2))
    np.testing.assert_array_equal(got[:, 1::8] - got[:, 0::8], 2)
    # a chunk is one bulk copy: the K-halves are contiguous blocks
    assert mrf.chunk_bytes(Cp) * (Cp // (swb // 2)) == 2 * Cp * Cp


@pytest.mark.parametrize("Cp", [16, 32, 64, 128])
def test_packed_taps_sit_where_the_descriptor_reads(Cp):
    """Each weight of a packed conv lies at its tap's base plus
    tap_byte_offset(c_out, c_in), read as raw bytes."""
    C = Cp - 3
    stage = _stage(C, (3,), (1,), torch.bfloat16, seed=Cp)
    packed = mrf.pack_stage(stage)
    raw = packed.taps.view(torch.int16).numpy().view(np.uint8)
    for conv, w in enumerate(stage.weights[0]):
        wbits = w.view(torch.int16).numpy()
        for j in range(3):
            base = (conv * 3 + j) * Cp * Cp * 2
            n, k = np.meshgrid(np.arange(C), np.arange(C), indexing="ij")
            off = base + mrf.tap_byte_offset(n, k, Cp)
            got = raw[off] | (raw[off + 1].astype(np.int32) << 8)
            np.testing.assert_array_equal(
                got.astype(np.uint16), wbits[:, :, j].view(np.uint16))


# (c) the tile plan


def _plan_shapes():
    cfg = TTSConfig()
    shapes = {(C, T) for t_mel in (1000, 192)
              for C, T in chip_smoke.fused_stages(cfg, t_mel)}
    shapes |= {(C, T) for _, C, T in chip_smoke.MRF_CHECKS}
    return sorted(shapes)


@pytest.mark.parametrize("C,T", _plan_shapes())
def test_tile_plan_fits_one_block(C, T):
    plan = mrf.tile_plan(T, C, torch.bfloat16, KS, DIL)
    assert plan.smem_bytes <= mrf.SMEM_LIMIT == 232448
    assert plan.tt % 8 == 0 and 8 <= plan.tt <= 512
    assert plan.slots >= 3
    assert plan.rows == plan.tt + 2 * plan.hmax and plan.hmax == 60
    per_wg = mrf.m_tiles_per_warpgroup(plan.Cp)
    assert plan.rows_per_pass == 64 * 2 * per_wg
    for k, wins, tiles in zip(KS, plan.windows, plan.m_tiles):
        c = (k - 1) // 2
        halo = c * (sum(DIL) + len(DIL))
        assert wins[0] == (plan.hmax - halo + c, plan.hmax + plan.tt + halo - c)
        assert wins[-1] == (plan.hmax, plan.hmax + plan.tt)
        for (lo, hi), m in zip(wins, tiles):
            assert 0 <= lo < hi <= plan.rows
            assert m == -(-(hi - lo) // 64) and m <= 2 * per_wg
    assert 1.0 <= plan.work_factor < 1.3


@pytest.mark.parametrize("C,tt,slots,f32_tt", [(128, 208, 3, 112),
                                               (64, 512, 6, 240),
                                               (32, 512, 32, 240)])
def test_tile_plan_of_the_shipped_stages(C, tt, slots, f32_tt):
    """The plans PERF.md records: bf16 at T_mel = 1000, and the f32 route's
    pass tile there (the largest multiple of 16 whose conv1 rows fit the
    warps' m-tiles and whose buffers fit beside 3 tap slots; at this T a
    pass launches enough blocks without cutting it down)."""
    T = dict(chip_smoke.fused_stages(TTSConfig(), 1000))[C]
    plan = mrf.tile_plan(T, C, torch.bfloat16, KS, DIL)
    assert (plan.tt, plan.slots) == (tt, slots)
    f32 = mrf.tile_plan(T, C, torch.float32, KS, DIL)
    assert f32.tt == f32_tt and f32.slots >= 3
    assert f32.smem_bytes <= mrf.SMEM_LIMIT
    nxt = f32.tt + 16
    assert (mrf._smem_f32(nxt, f32.rmax, f32.cmax, f32.Cp, 3) > mrf.SMEM_LIMIT
            or nxt + 2 * f32.cmax > f32.rows_per_pass or f32.tt == 512)


def test_tile_plan_refuses_a_stage_that_cannot_fit():
    with pytest.raises(ValueError):
        mrf.tile_plan(1000, 128, torch.bfloat16, (301,), (1, 3, 5))


# (d) the stage tile by tile


@pytest.mark.parametrize("C,T,ks,dil", [
    (16, 100, KS, DIL),          # T < TT: one tile
    (16, 1100, KS, DIL),         # T no multiple of TT (512): three tiles
    (32, 40, KS, DIL),           # T shorter than the halo (60)
    (16, 700, (3,), (1, 3)),     # one branch, two dilations
    (128, 450, KS, DIL),         # the C = 128 plan: TT = 208, three tiles
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tiled_emulation_matches_plain(C, T, ks, dil, dtype):
    stage = _stage(C, ks, dil, dtype, seed=T)
    x = torch.from_numpy(np.random.RandomState(T).randn(2, T, C)
                         .astype(np.float32)).to(dtype)
    plan = mrf.tile_plan(T, C, dtype, ks, dil)
    got = mrf.mrf_stage_tiles_plain(x, stage, plan).float()
    ref = mrf.mrf_stage_plain(x, stage).float()
    assert got.shape == ref.shape == (2, T, C)
    scale = max(1.0, float(ref.abs().max()))
    tol = 1e-6 if dtype == torch.float32 else BF16_TOL
    assert float((got - ref).abs().max()) <= tol * scale


@pytest.mark.parametrize("C,T,ks,dil", [(8, 600, KS, DIL),
                                        (4, 90, (3,), (1, 3))])
def test_tiled_emulation_matches_pallas(C, T, ks, dil):
    """f32, against mrf_stage_apply (the Pallas kernel in interpret mode, r
    = 1) on the same weights."""
    import jax.numpy as jnp

    from tests.test_torch_kernels_plain import _resblock_stage, _torch_stage
    from tts_king_tpu.ops.pallas.mrf_packed import mrf_stage_apply

    x, params, _ = _resblock_stage(C, T, kernel_sizes=ks, dilations=dil)
    stage = _torch_stage(params, ks, dil)
    plan = mrf.tile_plan(T, C, torch.float32, ks, dil)
    assert -(-T // plan.tt) >= 1
    got = mrf.mrf_stage_tiles_plain(torch.from_numpy(x), stage, plan).numpy()
    pallas = np.asarray(mrf_stage_apply(jnp.asarray(x), params, ks, dil, 1,
                                        tile=64, interpret=True))
    np.testing.assert_allclose(got, pallas.reshape(got.shape), rtol=1e-5,
                               atol=1e-5)


# (e) the Generator packs once


def _tiny_generator(seed):
    cfg = VocoderModelConfig(upsample_rates=[4, 4],
                             upsample_kernel_sizes=[8, 8],
                             upsample_initial_channel=32)
    gen = hifigan.Generator(cfg)
    rng = np.random.RandomState(seed)
    sd = {k: torch.from_numpy((0.1 * rng.randn(*v.shape)).astype(np.float32))
          for k, v in gen.state_dict().items()}
    return gen, sd


def test_generator_reuses_its_packed_stages(monkeypatch):
    gen, sd = _tiny_generator(0)
    _, sd2 = _tiny_generator(1)
    gen.load_state_dict(sd)
    gen.eval()
    n_fused = len(gen.config.upsample_rates)
    assert all(hasattr(gen, f"mrf_{i}_taps") for i in range(n_fused))
    assert not any(k.startswith("mrf_") for k in gen.state_dict())
    ptrs = [getattr(gen, f"mrf_{i}_taps").data_ptr() for i in range(n_fused)]
    calls = []
    monkeypatch.setattr(hifigan, "pack_stage",
                        lambda *a, **kw: calls.append(a) or mrf.pack_stage(
                            *a, **kw))
    mel = torch.from_numpy(np.random.RandomState(1).randn(2, 12, 80)
                           .astype(np.float32))
    with torch.no_grad():
        first = gen(mel)
        second = gen(mel)
    assert not calls
    assert torch.equal(first, second)
    assert ptrs == [getattr(gen, f"mrf_{i}_taps").data_ptr()
                    for i in range(n_fused)]

    # a new state dict is packed once, and the forward follows it
    gen.load_state_dict(sd2)
    assert len(calls) == n_fused
    for i in range(n_fused):
        stage = gen._fused_stage(gen._stage_blocks(i), gen._stage_channels(i))
        assert torch.equal(getattr(gen, f"mrf_{i}_taps"),
                           mrf.pack_stage(stage).taps)
    with torch.no_grad():
        assert not torch.equal(gen(mel), first)


def test_generator_repacks_on_a_cast():
    gen, sd = _tiny_generator(2)
    gen.load_state_dict(sd)
    gen.to(torch.bfloat16)
    taps = gen.mrf_0_taps
    assert taps.dtype == torch.bfloat16
    stage = gen._fused_stage(gen._stage_blocks(0), gen._stage_channels(0))
    assert torch.equal(taps, mrf.pack_stage(stage).taps)
    C = gen._stage_channels(0)
    assert taps.numel() == 2 * 3 * sum(KS) * mrf._padded_channels(C) ** 2
