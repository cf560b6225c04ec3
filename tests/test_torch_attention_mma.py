"""The arithmetic of the tensor-core attention kernels (csrc/attention_mma.cuh)
on the CPU, before any card sees it.

* The 3xTF32 split (ops/kernels/tf32.split_tf32) rounds as cvt.rna.tf32.f32
  does and reconstructs f32 to 2^-21.
* Attention and flash attention forward and backward with every product as
  emulated 3xTF32 stay within chip_smoke.py's kernel tolerances (TOL) of the
  plain versions and of the JAX package (fused_attention in interpret mode,
  attention_reference and its gradients), at D = 8, 16 and 32.
* golden_fs2 and the train-step golden hold at their bounds with the emulated
  attention in place of the port's.
* Skipping key tiles whose keys are all padded, as the kernels do, leaves
  every row with a valid key unchanged; an item with no valid key still
  averages v over T.
* The wrappers' layout checks and the build's cache key and bindings.

The CUDA kernels themselves are held against the plain versions on the card
by chip_smoke.py.
"""

import math
import os
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import TOL, key_mask, replay_train_step_golden
from tts_king_torch.ops.kernels import _build
from tts_king_torch.ops.kernels import attention as attn_mod
from tts_king_torch.ops.kernels import flash_attention as fa
from tts_king_torch.ops.kernels.tf32 import matmul_3xtf32, split_tf32

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
TILE = 32   # keys per tile of the kernels (attention_mma.cuh kKeys)


# ---------------------------------------------------------------- helpers


def inputs(B, H, T, D, kind, seed):
    """Seeded q, k, v and a key mask of chip_smoke.key_mask's ``kind``
    ("suffix", or "edge": padded tiles in the middle and at the start of
    an item, an item of length 1), every item with a valid key."""
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, H, T, D).astype(np.float32) for _ in range(3))
    return q, k, v, key_mask(B, T, rng, kind, empty_item=False)


def attention_3xtf32(q, k, v, key_pad_mask):
    """The inference kernel's f32 arithmetic: q * scale in f32, S = q k^T
    and P V as 3xTF32, an f32 softmax."""
    scale = torch.tensor(1.0 / math.sqrt(q.shape[-1]), dtype=q.dtype)
    s = matmul_3xtf32(q * scale, k.transpose(-1, -2))
    s = s.masked_fill(key_pad_mask[:, None, None, :], attn_mod.NEG_INF)
    return matmul_3xtf32(torch.softmax(s, dim=-1), v)


def _scores_3xtf32(q, k, key_pad_mask):
    s = matmul_3xtf32(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    return s.masked_fill(key_pad_mask[:, None, None, :], fa.NEG_INF)


def flash_forward_3xtf32(q, k, v, key_pad_mask):
    """The flash forward kernel's arithmetic: (O, lse) with S scaled in f32
    after the product."""
    s = _scores_3xtf32(q, k, key_pad_mask)
    lse = torch.logsumexp(s, dim=-1)
    return matmul_3xtf32(torch.exp(s - lse[..., None]), v), lse


def flash_backward_3xtf32(q, k, v, key_pad_mask, o, lse, do):
    """The dQ and dK/dV kernels' arithmetic: all five products as 3xTF32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.exp(_scores_3xtf32(q, k, key_pad_mask) - lse[..., None])
    delta = (do * o).sum(-1, keepdim=True)
    ds = p * (matmul_3xtf32(do, v.transpose(-1, -2)) - delta)
    dq = matmul_3xtf32(ds, k) * scale
    dk = matmul_3xtf32(ds.transpose(-1, -2), q) * scale
    dv = matmul_3xtf32(p.transpose(-1, -2), do)
    return dq, dk, dv


class Flash3xTF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, key_pad_mask):
        o, lse = flash_forward_3xtf32(q, k, v, key_pad_mask)
        ctx.save_for_backward(q, k, v, key_pad_mask, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        return (*flash_backward_3xtf32(*ctx.saved_tensors, do), None)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# ----------------------------------------------------------- (a) the split


@pytest.mark.parametrize("scale", [1e-30, 1.0, 3e30])
def test_split_tf32_reconstructs_f32(scale):
    rng = np.random.RandomState(0)
    x = torch.from_numpy((rng.randn(20000) * scale).astype(np.float32))
    hi, lo = split_tf32(x)
    for part in (hi, lo):   # both are TF32 values
        assert not bool((part.view(torch.int32) & 0x1FFF).any())
    err = ((hi.double() + lo.double() - x.double()).abs()
           / x.double().abs()).max()
    assert float(err) <= 2.0 ** -21


def test_split_tf32_rounds_to_nearest_ties_away():
    """hi is cvt.rna.tf32.f32's rounding: below half an ulp of TF32 rounds
    down, half an ulp and above rounds away from zero, for either sign."""
    base = np.array([0x3F800000, 0x40490000, 0x3E000000], dtype=np.int64)
    for low, up in ((0x0FFF, False), (0x1000, True), (0x1001, True)):
        for sign in (0, 0x80000000):
            bits = (base | low | sign).astype(np.uint32).view(np.int32)
            hi, _ = split_tf32(torch.from_numpy(bits).view(torch.float32))
            want = (base + (0x2000 if up else 0)) | sign
            np.testing.assert_array_equal(
                hi.view(torch.int32).numpy().view(np.uint32),
                want.astype(np.uint32))


def test_matmul_3xtf32_is_f32_accurate():
    """A 3xTF32 product is as close to the float64 product as an f32
    matmul is (within 2x), and far closer than one TF32 product."""
    rng = np.random.RandomState(1)
    a, b = _t(rng.randn(64, 128).astype(np.float32),
              rng.randn(128, 48).astype(np.float32))
    exact = a.double() @ b.double()
    err3 = float((matmul_3xtf32(a, b).double() - exact).abs().max())
    err32 = float(((a @ b).double() - exact).abs().max())
    hi_a, _ = split_tf32(a)
    hi_b, _ = split_tf32(b)
    err1 = float(((hi_a @ hi_b).double() - exact).abs().max())
    assert err3 <= 2 * err32
    assert err1 > 50 * err3


# --------------------------------------------- (b) against plain and JAX


@pytest.mark.parametrize("kind", ["suffix", "edge"])
@pytest.mark.parametrize("D", [8, 16, 32])
def test_attention_3xtf32_matches_plain_and_jax(D, kind):
    from tts_king_tpu.ops.pallas.attention import (attention_reference,
                                                   fused_attention)

    q, k, v, mask = inputs(5, 2, 77, D, kind, seed=D)
    got = attention_3xtf32(*_t(q, k, v, mask)).numpy()
    plain = attn_mod.attention_plain(*_t(q, k, v, mask)).numpy()
    jargs = [jnp.asarray(a) for a in (q, k, v, mask)]
    pallas = np.asarray(fused_attention(*jargs, interpret=True))
    ref = np.asarray(attention_reference(*jargs))
    tol = TOL[("attention", "f32")]
    for other in (plain, pallas, ref):
        assert np.abs(got - other).max() <= tol
    assert np.isfinite(got).all()


@pytest.mark.parametrize("kind", ["suffix", "edge"])
@pytest.mark.parametrize("D", [8, 16, 32])
def test_flash_3xtf32_matches_plain_and_jax(D, kind):
    """Forward and dq/dk/dv of sum(out * g) against autograd through the
    plain version and jax.grad through attention_reference, padded query
    rows given no upstream gradient (as FFTBlock's zeroing makes it)."""
    from tts_king_tpu.ops.pallas.attention import attention_reference

    q, k, v, mask = inputs(5, 2, 77, D, kind, seed=10 + D)
    g = np.random.RandomState(D).randn(*q.shape).astype(np.float32)
    g *= ~mask[:, None, :, None]
    tol = TOL[("flash_attention", "f32")]

    def torch_run(fn):
        qt, kt, vt = (t.requires_grad_(True) for t in _t(q, k, v))
        out = fn(qt, kt, vt, torch.from_numpy(mask))
        grads = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(g))
        return [out.detach().numpy()] + [x.numpy() for x in grads]

    got = torch_run(Flash3xTF32.apply)
    plain = torch_run(fa.flash_attention_plain)
    jm, jg = jnp.asarray(mask), jnp.asarray(g)
    out, vjp = jax.vjp(lambda a, b, c: attention_reference(a, b, c, jm),
                       *(jnp.asarray(a) for a in (q, k, v)))
    ref = [np.asarray(out)] + [np.asarray(x) for x in vjp(jg)]
    for name, a, b, c in zip(("o", "dq", "dk", "dv"), got, plain, ref):
        assert np.abs(a - b).max() <= tol, name
        assert np.abs(a - c).max() <= tol, name
    pad = np.broadcast_to(mask[:, None, :, None], got[2].shape)
    assert not got[2][pad].any() and not got[3][pad].any()


# -------------------------------------------------------- (c) the goldens


def test_golden_fs2_with_3xtf32_attention(monkeypatch):
    """golden_fs2 (D = 8) at 1e-5 with the inference attention's products
    as 3xTF32."""
    from tts_king_torch.models import layers
    from test_torch_models import _run_fs2, _torch_fs2
    from tts_king_torch.weights import load_flax_npz

    monkeypatch.setattr(layers, "attention", attention_3xtf32)
    path = os.path.join(FIXTURES, "golden_fs2.npz")
    z = np.load(path)
    out = _run_fs2(_torch_fs2(load_flax_npz(path)), z["in::speakers"],
                   z["in::texts"], z["in::src_lens"], max_mel_len=32)
    np.testing.assert_array_equal(out["mel_lens"], z["out::mel_lens"])
    for key in ("log_duration_prediction", "mel", "postnet_mel"):
        np.testing.assert_allclose(out[key], z[f"out::{key}"], rtol=1e-5,
                                   atol=1e-5, err_msg=key)


def test_golden_train_step_with_3xtf32_flash(monkeypatch):
    """The JAX train step of golden_train_step.npz through the port at
    compare_train_step's bounds (which replay_train_step_golden asserts)
    with every attention product, forward and backward, as 3xTF32."""
    from tts_king_torch.models import layers

    calls = []

    def flash(q, k, v, key_pad_mask):
        calls.append(q.shape)
        return Flash3xTF32.apply(q, k, v, key_pad_mask)

    monkeypatch.setattr(layers, "flash_attention", flash)
    monkeypatch.setattr(layers, "attention", attention_3xtf32)
    losses, errs = replay_train_step_golden(device="cpu")
    assert calls and np.isfinite(losses["total"])
    assert errs["loss_rel"] <= 1e-5


# ------------------------------------------- (d), (e) padded key tiles


def _live_keys(mask_row, tile):
    """Indices of the keys in tiles that hold a valid key."""
    T = mask_row.shape[0]
    keep = [t for t0 in range(0, T, tile) if not mask_row[t0:t0 + tile].all()
            for t in range(t0, min(t0 + tile, T))]
    return np.asarray(keep)


@pytest.mark.parametrize("tile", [TILE, 64])
@pytest.mark.parametrize("kind", ["suffix", "edge"])
@pytest.mark.parametrize("fn", ["attention", "flash_forward"])
def test_skipping_all_padded_tiles_changes_nothing(fn, kind, tile):
    """Every row of an item with a valid key is unchanged (1e-6, f32) when
    the key tiles whose keys are all padded are left out."""
    B, H, T, D = 5, 2, 200, 16
    q, k, v, mask = inputs(B, H, T, D, kind, seed=tile)
    if kind == "suffix":
        mask[1, T // 3:] = True   # several whole tiles padded
    assert any(mask[b, t0:t0 + tile].all() for b in range(B)
               for t0 in range(0, T, tile))
    run = {"attention": attn_mod.attention_plain,
           "flash_forward": fa.flash_forward_plain}[fn]
    full = run(*_t(q, k, v, mask))
    full = full if isinstance(full, tuple) else (full,)
    for b in range(B):
        keep = _live_keys(mask[b], tile)
        part = run(*_t(q[b:b + 1], k[b:b + 1][:, :, keep],
                       v[b:b + 1][:, :, keep], mask[b:b + 1][:, keep]))
        part = part if isinstance(part, tuple) else (part,)
        for a, c in zip(full, part):
            np.testing.assert_allclose(c.numpy()[0], a.numpy()[b],
                                       rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("fn", ["plain", "3xtf32", "wrapper"])
def test_item_with_no_valid_key_averages_v(fn):
    q, k, v, mask = inputs(2, 2, 45, 16, "suffix", seed=3)
    mask[1] = True
    run = {"plain": attn_mod.attention_plain, "3xtf32": attention_3xtf32,
           "wrapper": attn_mod.attention}[fn]
    got = run(*_t(q, k, v, mask)).numpy()
    want = np.broadcast_to(v[1].mean(axis=1, keepdims=True), got[1].shape)
    np.testing.assert_allclose(got[1], want, rtol=1e-5, atol=1e-6)
    assert np.isfinite(got).all()


# ------------------------------------------ wrappers, build, bindings


def test_check_aligned_raises_on_rows_off_16_bytes():
    x = torch.zeros(2, 6, 2, 8).transpose(1, 2)   # (B, H, T, D) view
    attn_mod.check_aligned("attention", x, x, x)
    with pytest.raises(ValueError, match="16 bytes"):
        attn_mod.check_aligned("attention", x.flatten()[1:].contiguous()
                               .view(-1)[:96].view(2, 2, 6, 4), x, x)
    y = torch.zeros(2, 2, 6, 12)[..., :8]   # rows 48 bytes apart: aligned
    attn_mod.check_aligned("attention", y)
    with pytest.raises(ValueError, match="16 bytes"):   # rows 20 bytes apart
        attn_mod.check_aligned("attention", torch.zeros(2, 2, 6, 5)[..., :4])


def test_library_key_covers_the_shared_header(tmp_path, monkeypatch):
    """An edited header rebuilds every library that includes it: the
    library's name hashes the headers beside the source."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    before = {n: _build._lib_path(n) for n in _build.SOURCES}
    with open(csrc / "attention_mma.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {n: _build._lib_path(n) for n in _build.SOURCES}
    assert all(before[n] != after[n] for n in _build.SOURCES)
    assert len(set(after.values())) == len(_build.SOURCES)


def test_bindings_cover_every_entry_point():
    """SIGNATURES names each C entry point of each source (the profiling
    readers, built only with -DTK_PROFILE_PHASES, aside), so every launch
    goes through argtypes set once when the library opens."""
    for name, src in _build.SOURCES.items():
        with open(os.path.join(_build.CSRC_DIR, src)) as f:
            text = f.read()
        entries = set(re.findall(r'extern "C" [\w\s\*]+?\b(tk_\w+)\(', text))
        entries -= {"tk_error_string", "tk_mrf_int8_phase_cycles",
                    "tk_mrf_phase_cycles", "tk_mrf_block_counts"}
        assert entries == set(_build.SIGNATURES[name]), name
