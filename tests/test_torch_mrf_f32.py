"""The f32 MRF kernel's plan, layout and arithmetic (csrc/mrf_stage.cu,
mrf_pass_f32 and mrf_mean_f32) on the CPU: the pass plan at speak's stages
(enough blocks for the card, shared memory, windows within a block), the
packed f32 tap layout that its ldmatrix reads, and a tile-by-tile emulation
of its passes with 3xTF32 products (tf32.matmul_3xtf32) and the branch mean
in branch order, held against the plain stage and the JAX Pallas kernel in
interpret mode.

The kernel itself is held against the plain version on the card by
chip_smoke.py and scripts/probe_mrf_int8.py --kernel f32.
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from tts_king_torch.config import TTSConfig
from tts_king_torch.ops.kernels import mrf, tf32

KS = (3, 7, 11)
DIL = (1, 3, 5)
SMS = 132   # streaming multiprocessors of an H100
# emulation against the plain stage and against the Pallas kernel: the
# tolerance of test_torch_mrf_wgmma.py's f32 Pallas check
RTOL = ATOL = 1e-5


def _stage(C, kernel_sizes, dilations, seed):
    """Weights N(0, 1/(C k)): each conv keeps unit scale, as chip_smoke's."""
    rng = np.random.RandomState(seed)
    ws = [[torch.from_numpy((rng.randn(C, C, k) / np.sqrt(C * k))
                            .astype(np.float32))
           for _ in range(2 * len(dilations))] for k in kernel_sizes]
    bs = [[torch.from_numpy(0.05 * rng.randn(C).astype(np.float32))
           for _ in range(2 * len(dilations))] for _ in kernel_sizes]
    return mrf.MrfStageWeights(tuple(kernel_sizes), tuple(dilations), ws, bs)


def _x(B, T, C, seed):
    return torch.from_numpy(np.random.RandomState(seed).randn(B, T, C)
                            .astype(np.float32))


# (a) the plan


def _speak_stages():
    return chip_smoke.fused_stages(TTSConfig(), chip_smoke.SPEAK_LEN)


@pytest.mark.parametrize("C,T", _speak_stages())
def test_plan_fills_the_card_at_speak(C, T):
    """At the 192-frame sentence every pass launches at least one block per
    SM, the block fits in shared memory, and each pass's windows stay
    within the rows the block holds and its warps cover."""
    plan = mrf.tile_plan(T, C, torch.float32, KS, DIL)
    assert isinstance(plan, mrf.F32Plan)
    assert plan.blocks(1, T) >= SMS
    assert plan.n_launches == len(DIL) + 1
    assert plan.smem_bytes <= mrf.SMEM_LIMIT == 232448
    assert plan.smem_bytes == mrf._smem_f32(plan.tt, plan.rmax, plan.cmax,
                                            plan.Cp, plan.slots)
    assert plan.tt % 16 == 0 and plan.slots >= 3
    wm, wn = mrf.f32_warp_grid(plan.Cp)
    assert wm * wn == 8 and plan.rows_per_pass == 16 * wm * mrf._F32_MT
    for k, wins in zip(KS, plan.windows):
        c = (k - 1) // 2
        for d, (m1, m2, r) in zip(DIL, wins):
            assert (m1, m2, r) == (plan.tt + 2 * c, plan.tt, c * (d + 1))
            assert m1 <= plan.rows_per_pass and m1 <= plan.rows_mid
            # conv1 reads input rows [0, m1 + 2 c d), conv2 reads [0, m1)
            assert m1 + 2 * c * d == plan.tt + 2 * r <= plan.rows_in
    assert 1.0 <= plan.work_factor < 1.05


@pytest.mark.parametrize("C,T,tt,blocks", [(128, 12288, 112, 330),
                                           (64, 24576, 240, 309),
                                           (32, 49152, 240, 615)])
def test_plan_of_speaks_stages(C, T, tt, blocks):
    """The plans PERF.md records for the 192-frame sentence."""
    plan = mrf.tile_plan(T, C, torch.float32, KS, DIL)
    assert (plan.tt, plan.blocks(1, T)) == (tt, blocks)


@pytest.mark.parametrize("T", [16, 40, 700, 2816])
def test_plan_of_short_windows(T):
    """Short sequences (a streamed window, the 44-frame sentence) get one
    tile of at least T steps or tiles of at least 64."""
    for C in (128, 64, 32, 16):
        plan = mrf.tile_plan(T, C, torch.float32, KS, DIL)
        assert plan.tt >= min(64, (T + 15) // 16 * 16)
        assert plan.smem_bytes <= mrf.SMEM_LIMIT


def test_plan_refuses_a_stage_that_cannot_fit():
    with pytest.raises(ValueError):
        mrf.tile_plan(1000, 128, torch.float32, (301,), (1, 3, 5))


# (b) the packed layout


@pytest.mark.parametrize("C", [4, 13, 16, 30, 32, 64, 100, 128])
def test_f32_pack_layout_and_exact_unpack(C):
    stage = _stage(C, KS, (1, 3), seed=C)
    Cp = mrf._padded_channels(C)
    assert Cp in (16, 32, 64, 128) and Cp >= C
    packed = mrf.pack_stage(stage)
    per = mrf.tap_elems(Cp, torch.float32)
    assert per == Cp * Cp * mrf.F32_ROW // mrf.F32_KC
    assert packed.taps.numel() == 2 * 2 * sum(KS) * per
    # each weight sits at its tap's base + f32_tap_offset(c_out, c_in)
    pos = 0
    for ws in stage.weights:
        for w in ws:
            k = w.shape[-1]
            blk = packed.taps[pos:pos + k * per].view(k, per)
            n, ci = np.meshgrid(np.arange(C), np.arange(C), indexing="ij")
            off = torch.from_numpy(mrf.f32_tap_offset(n, ci, Cp))
            for j in range(k):
                assert torch.equal(blk[j][off], w[:, :, j])
            # everything else (past C, the rows' padding) is zero
            rest = torch.ones(per, dtype=torch.bool)
            rest[off.reshape(-1)] = False
            assert not bool(blk[:, rest].abs().sum())
            pos += k * per
    back = packed.unpack()
    for got_b, want_b in zip(back.weights, stage.weights):
        assert all(torch.equal(g, w) for g, w in zip(got_b, want_b))
    for got_b, want_b in zip(back.biases, stage.biases):
        assert all(torch.equal(g, w) for g, w in zip(got_b, want_b))


@pytest.mark.parametrize("Cp", [16, 32, 64, 128])
def test_f32_rows_fall_in_distinct_banks(Cp):
    """ldmatrix reads 8 rows of 16 bytes: the tap chunk's rows (F32_ROW
    floats) and the activation rows (Cp + 4 floats) start in 8 distinct
    4-bank groups, and a chunk is one 16-byte-aligned bulk copy."""
    for stride in (mrf.F32_ROW, Cp + 4):
        groups = {(r * stride) % 32 // 4 for r in range(8)}
        assert len(groups) == 8, stride
    assert mrf.f32_chunk_bytes(Cp) % 16 == 0
    assert mrf.f32_tap_offset(Cp - 1, Cp - 1, Cp) == (
        mrf.tap_elems(Cp, torch.float32) - (mrf.F32_ROW - mrf.F32_KC) - 1)


# (c) the kernel's arithmetic, tile by tile


@pytest.mark.parametrize("C,T,ks,dil,B", [
    (16, 100, KS, DIL, 2),        # T below one tile
    (8, 600, KS, DIL, 1),         # several tiles, T no multiple of TT
    (32, 40, KS, DIL, 2),         # T shorter than a pass's reach (30)
    (4, 90, (3,), (1, 3), 3),     # one branch, two dilations, C = 4
    (32, 533, (3, 7), (1, 3, 5), 1),
])
def test_3xtf32_emulation_matches_plain(C, T, ks, dil, B):
    stage = _stage(C, ks, dil, seed=T)
    x = _x(B, T, C, seed=T)
    plan = mrf.tile_plan(T, C, torch.float32, ks, dil, batch=B)
    got = mrf.mrf_stage_f32_tiles_plain(x, stage, plan,
                                        matmul=tf32.matmul_3xtf32)
    ref = mrf.mrf_stage_plain(x, stage)
    assert got.shape == ref.shape == (B, T, C)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=RTOL,
                               atol=ATOL)
    # the plan's dispatch runs the same passes with plain products
    plain_tiles = mrf.mrf_stage_tiles_plain(x, stage, plan)
    np.testing.assert_allclose(plain_tiles.numpy(), ref.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_3xtf32_emulation_of_a_packed_stage_at_a_small_tile():
    """A packed stage (unpacked exactly), and a tile smaller than the plan's
    so that many tiles meet the sequence's edges."""
    C, T = 16, 300
    stage = mrf.pack_stage(_stage(C, KS, DIL, seed=3))
    x = _x(2, T, C, seed=3)
    plan = mrf.tile_plan(T, C, torch.float32, KS, DIL, batch=2)
    plan.tt = 16
    plan.windows = [[(16 + 2 * ((k - 1) // 2), 16, (k - 1) // 2 * (d + 1))
                     for d in DIL] for k in KS]
    got = mrf.mrf_stage_f32_tiles_plain(x, stage, plan,
                                        matmul=tf32.matmul_3xtf32)
    np.testing.assert_allclose(got.numpy(),
                               mrf.mrf_stage_plain(x, stage).numpy(),
                               rtol=RTOL, atol=ATOL)


def test_branch_mean_in_branch_order():
    """The mean adds the branches' h in order, ((h0 + h1) + h2) / 3, as
    the plain version does: bit for bit with plain products."""
    C, T = 8, 200
    stage = _stage(C, KS, DIL, seed=5)
    x = _x(1, T, C, seed=5)
    plan = mrf.tile_plan(T, C, torch.float32, KS, DIL)
    hs = [mrf.mrf_stage_f32_tiles_plain(
        x, mrf.MrfStageWeights((k,), DIL, [w], [b]),
        dataclasses.replace(plan, windows=[win]))
        for k, w, b, win in zip(KS, stage.weights, stage.biases,
                                plan.windows)]
    got = mrf.mrf_stage_f32_tiles_plain(x, stage, plan)
    assert torch.equal(got, ((hs[0] + hs[1]) + hs[2]) / 3)


@pytest.mark.parametrize("C,T,ks,dil", [(8, 600, KS, DIL),
                                        (4, 90, (3,), (1, 3)),
                                        (16, 257, KS, DIL)])
def test_3xtf32_emulation_matches_pallas(C, T, ks, dil):
    """f32, against mrf_stage_apply (the Pallas kernel in interpret mode,
    r = 1) on the same weights, as test_torch_mrf_wgmma.py holds the bf16
    kernel's tiles."""
    import jax.numpy as jnp

    from tests.test_torch_kernels_plain import _resblock_stage, _torch_stage
    from tts_king_tpu.ops.pallas.mrf_packed import mrf_stage_apply

    x, params, _ = _resblock_stage(C, T, kernel_sizes=ks, dilations=dil)
    stage = _torch_stage(params, ks, dil)
    plan = mrf.tile_plan(T, C, torch.float32, ks, dil, batch=x.shape[0])
    got = mrf.mrf_stage_f32_tiles_plain(torch.from_numpy(x), stage, plan,
                                        matmul=tf32.matmul_3xtf32).numpy()
    pallas = np.asarray(mrf_stage_apply(jnp.asarray(x), params, ks, dil, 1,
                                        tile=64, interpret=True))
    np.testing.assert_allclose(got, pallas.reshape(got.shape), rtol=RTOL,
                               atol=ATOL)
