"""The port's kernel modules on the CPU, against the JAX package's Pallas
kernels (run in interpret mode, as tests/test_pallas_*.py run them) and
their XLA references.

On the CPU each wrapper (``attention``, ``mrf_stage``) computes its plain
PyTorch version; the CUDA kernels themselves are held against the same plain
versions on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_king_torch.ops.kernels import attention as attn_mod
from tts_king_torch.ops.kernels import mrf as mrf_mod

KS = (3, 7, 11)
DIL = (1, 3, 5)


def _attn_inputs(B, H, T, D):
    rng = np.random.RandomState(B * 100 + T)
    q, k, v = (rng.randn(B, H, T, D).astype(np.float32) for _ in range(3))
    lens = rng.randint(max(T // 2, 1), T + 1, size=(B,))
    mask = np.arange(T)[None] >= lens[:, None]
    return q, k, v, mask, lens


@pytest.mark.parametrize("B,H,T,D", [(2, 2, 50, 32), (1, 2, 64, 128),
                                     (3, 1, 17, 16)])
def test_attention_plain_matches_pallas_and_reference(B, H, T, D):
    from tts_king_tpu.ops.pallas.attention import (attention_reference,
                                                   fused_attention)

    q, k, v, mask, lens = _attn_inputs(B, H, T, D)
    got = attn_mod.attention(*(torch.from_numpy(a) for a in (q, k, v, mask)))
    got = got.numpy()
    jargs = [jnp.asarray(a) for a in (q, k, v, mask)]
    pallas = np.asarray(fused_attention(*jargs, interpret=True))
    ref = np.asarray(attention_reference(*jargs))
    # valid query rows only: padded rows are zeroed downstream
    valid = np.arange(T)[None, None, :, None] < lens[:, None, None, None]
    np.testing.assert_allclose(got * valid, pallas * valid, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got * valid, ref * valid, rtol=1e-4, atol=1e-5)
    assert np.isfinite(got).all()  # padded query rows stay finite


def test_attention_cpu_wrapper_is_the_plain_version():
    q, k, v, mask, _ = _attn_inputs(2, 2, 40, 16)
    args = [torch.from_numpy(a) for a in (q, k, v, mask)]
    before = attn_mod.launches
    np.testing.assert_array_equal(attn_mod.attention(*args).numpy(),
                                  attn_mod.attention_plain(*args).numpy())
    assert attn_mod.launches == before  # no kernel launch on the CPU


def test_attention_all_keys_padded_stays_finite():
    q, k, v, _, _ = _attn_inputs(1, 1, 8, 8)
    mask = torch.ones((1, 8), dtype=torch.bool)
    out = attn_mod.attention(*(torch.from_numpy(a) for a in (q, k, v)), mask)
    assert torch.isfinite(out).all()
    # uniform over all keys, as softmax over equal -1e9 scores gives
    np.testing.assert_allclose(out.numpy()[0, 0], np.broadcast_to(
        v[0, 0].mean(0), (8, 8)), rtol=1e-5, atol=1e-6)


def test_wrappers_raise_off_cpu_and_cuda():
    """No silent fallback: a tensor that is neither on the CPU nor on CUDA
    is refused, not routed to the plain version."""
    q = torch.zeros((1, 1, 4, 8), device="meta")
    with pytest.raises(ValueError):
        attn_mod.attention(q, q, q, torch.zeros((1, 4), dtype=torch.bool,
                                                device="meta"))
    x = torch.zeros((1, 16, 8), device="meta")
    with pytest.raises(ValueError):
        mrf_mod.mrf_stage(x, mrf_mod.MrfStageWeights((3,), (1,), [[]], [[]]))


def _resblock_stage(C, T, B=2, seed=0, kernel_sizes=KS, dilations=DIL):
    """Random ResBlock1 params (flax layout), x, and the JAX unfused mean."""
    from tts_king_tpu.models.hifigan import ResBlock1

    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, C).astype(np.float32)
    params, ref = [], None
    for i, k in enumerate(kernel_sizes):
        rb = ResBlock1(C, k, dilations)
        shapes = jax.eval_shape(lambda: rb.init(jax.random.PRNGKey(i),
                                                jnp.asarray(x)))["params"]
        p = jax.tree.map(lambda s: (rng.randn(*s.shape) * 0.05).astype(
            np.float32), shapes)
        out = rb.apply({"params": p}, jnp.asarray(x))
        ref = out if ref is None else ref + out
        params.append(p)
    return x, params, np.asarray(ref / len(kernel_sizes))


def _torch_stage(params, kernel_sizes=KS, dilations=DIL):
    ws, bs = [], []
    for p in params:
        w_b, b_b = [], []
        for j in range(len(dilations)):
            for g in ("convs1", "convs2"):
                w_b.append(torch.from_numpy(np.ascontiguousarray(
                    np.asarray(p[f"{g}_{j}"]["kernel"]).transpose(2, 1, 0))))
                b_b.append(torch.from_numpy(np.asarray(p[f"{g}_{j}"]["bias"])))
        ws.append(w_b)
        bs.append(b_b)
    return mrf_mod.MrfStageWeights(tuple(kernel_sizes), tuple(dilations), ws,
                                   bs)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("C,T,r,tile", [(8, 128, 1, 32), (32, 256, 4, 32)])
def test_mrf_plain_matches_pallas_and_resblocks(C, T, r, tile):
    from tts_king_tpu.ops.pallas.mrf_packed import mrf_stage_apply

    x, params, ref = _resblock_stage(C, T)
    stage = _torch_stage(params)
    got = mrf_mod.mrf_stage(torch.from_numpy(x), stage).numpy()
    xp = jnp.asarray(x).reshape(x.shape[0], T // r, r * C)
    pallas = np.asarray(mrf_stage_apply(xp, params, KS, DIL, r, tile=tile,
                                        interpret=True)).reshape(ref.shape)
    assert got.shape == ref.shape
    assert _rel(got, ref) < 1e-5
    assert _rel(got, pallas) < 1e-5


def test_mrf_plain_two_dilations_one_branch():
    """The trained-vocoder shape of stage: one k=3 branch, dilations (1, 3)."""
    x, params, ref = _resblock_stage(4, 64, kernel_sizes=(3,),
                                     dilations=(1, 3))
    got = mrf_mod.mrf_stage(torch.from_numpy(x),
                            _torch_stage(params, (3,), (1, 3))).numpy()
    assert _rel(got, ref) < 1e-5


def test_mrf_halo_matches_the_branch_reach():
    # per side: sum over the 6 convs of (k-1)/2 * dilation
    assert mrf_mod._halo((11,), DIL) == 60
    assert mrf_mod._halo((7,), DIL) == 36
    assert mrf_mod._halo((3,), DIL) == 12
    assert mrf_mod._halo(KS, DIL) == 60
    assert mrf_mod._halo((3,), (1, 3)) == 6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mrf_pack_layout(dtype):
    """Packed taps are blocks of k (Cp x Cp) taps in chain order, zero past
    C: [tap][c_in][c_out] for the f32 (CUDA-core) path; for the bf16
    (tensor-core) path each tap in the swizzled K-major layout of the wgmma
    B operand, element (c_out, c_in) at byte tap_byte_offset(c_out, c_in)."""
    C = 5
    Cp = mrf_mod._padded_channels(C, dtype)
    assert Cp == (16 if dtype == torch.bfloat16 else 8)
    rng = np.random.RandomState(0)
    ws = [[torch.from_numpy(rng.randn(C, C, 3).astype(np.float32)).to(dtype)
           for _ in range(2)]]
    bs = [[torch.from_numpy(rng.randn(C).astype(np.float32)).to(dtype)
           for _ in range(2)]]
    stage = mrf_mod.MrfStageWeights((3,), (1,), ws, bs)
    taps, biases = mrf_mod._pack(stage, C, Cp, dtype, "cpu")
    assert taps.shape == (2 * 3 * Cp * Cp,) and taps.dtype == dtype
    blk = taps[3 * Cp * Cp:].reshape(3, Cp * Cp)     # second conv
    if dtype == torch.bfloat16:
        n, k = np.meshgrid(np.arange(Cp), np.arange(Cp), indexing="ij")
        blk = blk[:, torch.from_numpy(
            mrf_mod.tap_byte_offset(n, k, Cp).reshape(-1) // 2)]
    want = ws[0][1].permute(2, 0, 1) if dtype == torch.bfloat16 \
        else ws[0][1].permute(2, 1, 0)
    blk = blk.reshape(3, Cp, Cp)
    assert torch.equal(blk[:, :C, :C], want)
    assert float(blk[:, C:, :].float().abs().sum()) == 0.0
    assert float(blk[:, :, C:].float().abs().sum()) == 0.0
    assert torch.equal(biases[1, :C], bs[0][1])
    assert float(biases[:, C:].float().abs().sum()) == 0.0


@pytest.mark.parametrize("C,want", [(1, 16), (16, 16), (17, 32), (32, 32),
                                    (64, 64), (100, 128), (128, 128)])
def test_mrf_padded_channels_bf16(C, want):
    assert mrf_mod._padded_channels(C, torch.bfloat16) == want
    assert mrf_mod._padded_channels(C, torch.float32) == (C + 7) // 8 * 8
