"""ModelConfig.attention_probs_bf16 in the port on the CPU: the attention
kernels' bf16-probability mode, and the route table of MultiHeadAttention.

The JAX package rounds the normalized f32 softmax probabilities to bf16 on
its XLA attention (tts_king_tpu/models/layers.py, MultiHeadAttention's last
branch); ``jax.vjp`` of that formulation gives dV = round(P)^T dO, dP =
round(dO v^T), Delta_i = sum_j P_ij dP_ij and dS = P * (dP - Delta).

* Kernel arithmetic: a tile-by-tile emulation of what the kernels
  (csrc/attention_round.cuh) do in the mode (the forward's two passes over
  the key tiles, S kept in a scratch between them and P left there for the
  backward; the dQ kernel's Delta pass, round(dP) kept in a second scratch,
  before its dS pass; dK/dV over query tiles reading both; all-padded key
  tiles skipped, every product as emulated 3xTF32) against the plain
  versions and JAX's XLA route, at D = 8, 16 and 32, suffix and edge masks
  (tests/test_torch_attention_round_hopper.py: H = 1 and 2, the scratch).
* Modules: a JAX MultiHeadAttention, an FFTBlock and a tiny FastSpeech2
  with the flag, their weights carried across with the weight bridge: the
  forward on the XLA route, one train step against JAX's make_train_step,
  and the unrounded routes that use_flash_attention and
  use_pallas_attention select.

Tolerances. A probability within an ulp of a bf16 rounding boundary can
round the other way in another library's exp or sum (torch's softmax, XLA's,
the emulation's): one such flip moves an output by up to 2^-8 of p |v|.
So each comparison holds the max error (MAX_TOL, flips included) and the
mean error (MEAN_TOL, which flips barely move). Readings on the CPU, D = 8
to 128: the plain version against JAX's XLA route 6e-8 to 1.3e-7 mean,
3.2e-4 max; the f32 route against it 1.2e-4 to 2.6e-4 mean, 1.5e-3 to
2.6e-3 max. Every test asserts the negative control: the f32 route fails
MEAN_TOL.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import key_mask
from tts_king_torch.ops.kernels import attention as attn_mod
from tts_king_torch.ops.kernels import flash_attention as fa
from tts_king_torch.ops.kernels.tf32 import matmul_3xtf32

MAX_TOL = 2e-3     # flips of single roundings of P or dP included
MEAN_TOL = 5e-6    # 1/20 of the f32 route's mean error
ROWS, KEYS = 64, 32   # the kernels' query rows per block and keys per tile


def inputs(B, H, T, D, kind, seed):
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(B, H, T, D).astype(np.float32) for _ in range(4))
    mask = key_mask(B, T, rng, kind, empty_item=False)
    do *= ~mask[:, None, :, None]   # padded query rows get no gradient
    return q, k, v, do, mask


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def assert_mode_close(got, want, what):
    err = np.abs(_np(got).astype(np.float64) - _np(want).astype(np.float64))
    assert err.max() <= MAX_TOL, (what, "max", err.max())
    assert err.mean() <= MEAN_TOL, (what, "mean", err.mean())


def assert_far(got, want, what):
    """The negative control: the f32 route misses the mode's MEAN_TOL."""
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert err.mean() > MEAN_TOL, (what, err.mean())


# ------------------------------------------------- JAX's XLA route


def jax_xla(q, k, v, mask, probs_bf16=True, do=None):
    """tts_king_tpu/models/layers.py's XLA branch on (B, H, T, D) arrays: the
    output, and with ``do`` also (dq, dk, dv) from jax.vjp."""
    scale = 1.0 / np.power(q.shape[-1], 0.5)
    jmask = jnp.asarray(mask)

    def f(q, k, v):
        a = jnp.einsum("bhqd,bhkd->bhqk", q, k) * scale
        a = jnp.where(jmask[:, None, None, :], -1e9, a)
        a = jax.nn.softmax(a.astype(jnp.float32), axis=-1)
        a = a.astype(jnp.bfloat16 if probs_bf16 else v.dtype)
        return jnp.einsum("bhqk,bhkd->bhqd", a, v)

    out, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    if do is None:
        return np.asarray(out)
    return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(do))]


# ------------------------------------- the kernels, tile by tile


def _live_tiles(mask_row, tile):
    """The key tiles a kernel runs for one item: all-padded tiles are
    skipped when the item has a valid key (attention_mma.cuh skip_tile)."""
    T = mask_row.shape[0]
    tiles = [(t0, min(t0 + tile, T)) for t0 in range(0, T, tile)]
    if mask_row.all():
        return tiles
    return [(a, b) for a, b in tiles if not mask_row[a:b].all()]


def _scores(q, k, mask_row, scale):
    s = matmul_3xtf32(q, k.transpose(-1, -2)) * scale
    return s.masked_fill(mask_row[None, :], attn_mod.NEG_INF)


def _ld(T):
    """The kernels' scratch row length (attention.probs_plan)."""
    return attn_mod.probs_plan(1, 1, T, 4)["ld"]


def forward_two_sweeps(q, k, v, mask, write_p=False):
    """attention_round.cuh's round_fwd_kernel: per item, pass 1 over the
    live key tiles computes S (3xTF32, scaled, padded keys at -1e9) into a
    (B, H, T, ld) scratch and keeps each row's running max m and sum l (the
    online softmax's rescaling); pass 2 reads S back and adds round(exp(S -
    m) * (1 / l)) V, writing P (unrounded) over S with ``write_p``, as the
    training forward does for the backward. The scratch starts as NaN: an
    entry the kernel never writes (skipped tiles) shows if it is read.
    Returns (O, lse = m + log l, the scratch)."""
    B, H, T, D = q.shape
    scale = 1.0 / math.sqrt(D)
    o = torch.zeros_like(q)
    lse = torch.zeros((B, H, T))
    sp = torch.full((B, H, T, _ld(T)), float("nan"))
    for b in range(B):
        tiles = _live_tiles(mask[b].numpy(), KEYS)
        m = torch.full((H, T), -1e30)
        l = torch.zeros((H, T))
        for a, e in tiles:
            s = _scores(q[b], k[b, :, a:e], mask[b, a:e], scale)
            sp[b, :, :, a:e] = s
            m_new = torch.maximum(m, s.max(-1).values)
            l = l * torch.exp(m - m_new) + torch.exp(
                s - m_new[..., None]).sum(-1)
            m = m_new
        inv_l = 1.0 / l
        for a, e in tiles:
            pu = torch.exp(sp[b, :, :, a:e] - m[..., None]) * inv_l[..., None]
            if write_p:
                sp[b, :, :, a:e] = pu
            # round(P) is exact in TF32: its low split is 0 (2 passes)
            o[b] += matmul_3xtf32(attn_mod.round_bf16(pu), v[b, :, a:e])
        lse[b] = m + torch.log(l)
    return o, lse, sp


def backward_delta_sweep(q, k, v, mask, probs, do):
    """round_dq_kernel (pass 1 over the live key tiles: dP = round(dO
    v^T) into a NaN-filled (B, H, T, ld) scratch, Delta = sum_j P dP with P
    read from the forward's ``probs``; pass 2: dQ += P (dP - Delta) K, both
    read back) and round_dkdv_kernel (per block of 64 keys, zeros for an
    all-padded block of an item with a valid key; over query tiles of 32:
    P^T and dP^T read from the scratch, 0 at padded keys of an item with a
    valid key, dV += round(P)^T dO, dK += dS^T Q), every product 3xTF32."""
    B, H, T, D = q.shape
    scale = 1.0 / math.sqrt(D)
    dq, dk, dv = (torch.zeros_like(q) for _ in range(3))
    dprobs = torch.full(probs.shape, float("nan"))
    delta = torch.full((B, H, probs.shape[-1]), float("nan"))
    for b in range(B):
        mrow = mask[b]
        tiles = _live_tiles(mrow.numpy(), KEYS)
        d = torch.zeros((H, T, 1))
        for a, e in tiles:
            dp = attn_mod.round_bf16(matmul_3xtf32(
                do[b], v[b, :, a:e].transpose(-1, -2)))
            dprobs[b, :, :, a:e] = dp
            d += (probs[b, :, :, a:e] * dp).sum(-1, keepdim=True)
        delta[b, :, :T] = d[..., 0]
        for a, e in tiles:
            ds = probs[b, :, :, a:e] * (dprobs[b, :, :, a:e] - d)
            dq[b] += matmul_3xtf32(ds, k[b, :, a:e])
        dq[b] *= scale
        has_key = not bool(mrow.all())
        for k0 in range(0, T, ROWS):
            k1 = min(k0 + ROWS, T)
            if has_key and bool(mrow[k0:k1].all()):
                continue   # written as zeros
            zero = (mrow[k0:k1] & has_key)[None, :, None]
            for t0 in range(0, T, KEYS):
                t1 = min(t0 + KEYS, T)
                pT = torch.where(zero, 0.0, probs[b, :, t0:t1, k0:k1]
                                 .transpose(-1, -2))
                dpT = torch.where(zero, 0.0, dprobs[b, :, t0:t1, k0:k1]
                                  .transpose(-1, -2))
                dsT = pT * (dpT - delta[b, :, t0:t1][:, None, :])
                dv[b, :, k0:k1] += matmul_3xtf32(attn_mod.round_bf16(pT),
                                                 do[b, :, t0:t1])
                dk[b, :, k0:k1] += matmul_3xtf32(dsT, q[b, :, t0:t1])
        dk[b] *= scale
    return dq, dk, dv


# -------------------------------------------------- the tests


@pytest.mark.parametrize("kind", ["suffix", "edge"])
@pytest.mark.parametrize("D", [8, 16, 32])
def test_two_sweep_forward_matches_plain_and_jax(D, kind):
    """The forward's two passes against attention_plain(probs_bf16=True),
    flash_forward_plain(probs_bf16=True) and JAX's XLA route; the inference
    and the flash forward kernels compute the same O."""
    q, k, v, _, mask = inputs(5, 2, 150, D, kind, seed=D)
    got, lse, _ = forward_two_sweeps(*_t(q, k, v, mask))
    plain = attn_mod.attention_plain(*_t(q, k, v, mask), probs_bf16=True)
    fplain, flse = fa.flash_forward_plain(*_t(q, k, v, mask), probs_bf16=True)
    ref = jax_xla(q, k, v, mask)
    for what, other in (("plain", plain), ("flash plain", fplain),
                        ("jax", ref)):
        assert_mode_close(got.numpy(), np.asarray(other), what)
    np.testing.assert_allclose(lse.numpy(), flse.numpy(), rtol=1e-6,
                               atol=1e-5)
    # the negative control: the unrounded forward misses the mode
    assert_far(attn_mod.attention_plain(*_t(q, k, v, mask)).numpy(), ref,
               "f32 route")


@pytest.mark.parametrize("kind", ["suffix", "edge"])
@pytest.mark.parametrize("D", [8, 16, 32])
def test_delta_sweep_backward_matches_plain_and_jax(D, kind):
    """dQ, dK, dV of the kernels' arithmetic against
    flash_backward_plain(probs_bf16=True), autograd through the plain
    formulation and jax.vjp of the XLA route; padded keys get exactly 0."""
    q, k, v, do, mask = inputs(5, 2, 150, D, kind, seed=20 + D)
    tq, tk, tv, tdo, tmask = _t(q, k, v, do, mask)
    o, lse, probs = forward_two_sweeps(tq, tk, tv, tmask, write_p=True)
    got = backward_delta_sweep(tq, tk, tv, tmask, probs, tdo)
    plain = fa.flash_backward_plain(tq, tk, tv, tmask, o, lse, tdo,
                                    probs_bf16=True)
    leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    auto = torch.autograd.grad(
        fa.flash_attention_plain(*leaves, tmask, probs_bf16=True), leaves,
        tdo)
    _, ref = jax_xla(q, k, v, mask, do=do)
    for name, a, b, c, r in zip(("dq", "dk", "dv"), got, plain, auto, ref):
        for what, other in (("plain", b), ("autograd", c), ("jax", r)):
            assert_mode_close(a, other, f"{name} vs {what}")
    pad = np.broadcast_to(mask[:, None, :, None], q.shape)
    assert not got[1].numpy()[pad].any() and not got[2].numpy()[pad].any()
    # the negative control: the unrounded backward misses the mode
    _, ref32 = jax_xla(q, k, v, mask, probs_bf16=False, do=do)
    for name, a, r in zip(("dq", "dk", "dv"), ref32, ref):
        assert_far(a, r, f"f32 {name}")


def test_flash_function_runs_the_mode_on_cpu_tensors():
    """FlashAttention (the autograd Function the CUDA path takes) on CPU
    tensors computes the mode through the plain versions, float64 for
    gradcheck, and flash_attention passes the flag on."""
    q, k, v, do, mask = inputs(2, 2, 40, 8, "suffix", seed=3)
    tq, tk, tv = (torch.from_numpy(x).double().requires_grad_(True)
                  for x in (q, k, v))
    tmask = torch.from_numpy(mask)
    out = fa.FlashAttention.apply(tq, tk, tv, tmask, True)
    want = fa.flash_attention_plain(tq, tk, tv, tmask, probs_bf16=True)
    np.testing.assert_allclose(out.detach().numpy(), want.detach().numpy(),
                               rtol=1e-12, atol=1e-12)
    g = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do).double())
    gw = torch.autograd.grad(want, (tq, tk, tv), torch.from_numpy(do).double())
    for a, b in zip(g, gw):
        # rounding P and dP at bf16 in f64: the two orders agree to f64's
        # rounding of sums unless one product sits on a bf16 boundary
        assert float((a - b).abs().mean()) <= 1e-9
    plain32 = fa.flash_attention(*_t(q, k, v, mask), probs_bf16=True)
    np.testing.assert_array_equal(
        plain32.numpy(),
        attn_mod.attention_probs_bf16_plain(*_t(q, k, v, mask)).numpy())


def test_flag_changes_nothing_on_bf16_inputs_and_when_off():
    """On bf16 inputs the JAX cast is a no-op and the bf16 kernel's function
    runs as before; with the flag off the functions are unchanged."""
    q, k, v, _, mask = inputs(2, 2, 40, 16, "suffix", seed=4)
    tq, tk, tv, tm = _t(q, k, v, mask)
    b16 = [x.to(torch.bfloat16) for x in (tq, tk, tv)]
    assert torch.equal(attn_mod.attention(*b16, tm, probs_bf16=True),
                       attn_mod.attention(*b16, tm))
    assert torch.equal(attn_mod.attention(tq, tk, tv, tm, probs_bf16=False),
                       attn_mod.attention_plain(tq, tk, tv, tm))


# ------------------------------------------------------ the modules

D_MODEL, N_HEAD = 32, 2   # d_k = 16


def _mha_pair(kind, seed, **flags):
    """(port module, JAX module, flax variables): MultiHeadAttention or
    FFTBlock with the route flags, the port's seeded weights carried to
    flax by the weight bridge."""
    from tts_king_torch.models.layers import FFTBlock, MultiHeadAttention
    from tts_king_torch.weights import seeded_state_dict, torch_to_flax
    from tts_king_tpu.models import layers as jl

    d_k = D_MODEL // N_HEAD
    jflags = {"probs_bf16": flags.get("probs_bf16", False),
              "use_flash": flags.get("use_flash", False),
              "use_pallas": flags.get("use_pallas", False)}
    if kind == "mha":
        port = MultiHeadAttention(N_HEAD, D_MODEL, d_k, d_k, 0.1, **flags)
        jmod = jl.MultiHeadAttention(N_HEAD, D_MODEL, d_k, d_k, 0.1, **jflags)
    else:
        port = FFTBlock(D_MODEL, N_HEAD, d_k, d_k, 64, (9, 1), 0.1, **flags)
        jmod = jl.FFTBlock(D_MODEL, N_HEAD, d_k, d_k, 64, (9, 1), 0.1,
                           **jflags)
    sd = seeded_state_dict(port, seed)
    port.load_state_dict({k: torch.from_numpy(np.asarray(v))
                          for k, v in sd.items()})
    variables = {c: t for c, t in torch_to_flax(sd).items() if t}
    return port.eval(), jmod, variables


def _x_mask(seed, B=3, T=70):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, D_MODEL).astype(np.float32)
    mask = np.arange(T)[None] >= np.array([T, 41, 9])[:, None]
    return x, mask


def _jax_apply(jmod, variables, x, mask):
    return np.asarray(jmod.apply(jax.tree.map(jnp.asarray, variables),
                                 jnp.asarray(x), jnp.asarray(mask), True))


@pytest.mark.parametrize("kind", ["mha", "fft"])
def test_module_forward_matches_jax_xla_route(kind):
    """Eval mode, the default flags (use_flash and use_pallas off): the
    port's module against the JAX module on its XLA route with
    probs_bf16=True; the same module without the flag misses it."""
    port, jmod, variables = _mha_pair(kind, 1, probs_bf16=True)
    x, mask = _x_mask(2)
    want = _jax_apply(jmod, variables, x, mask)
    with torch.no_grad():
        got = port(*_t(x, mask))
        (port if kind == "mha" else port.slf_attn).probs_bf16 = False
        f32 = port(*_t(x, mask))
    keep = ~mask[:, :, None]   # padded rows: JAX and the port both finite
    assert_mode_close(got.numpy() * keep, want * keep, kind)
    assert_far(f32.numpy() * keep, want * keep, f"{kind} f32 route")


def test_route_table_follows_jax(monkeypatch):
    """Which calls round P, per MultiHeadAttention's flags and mode (the
    JAX module's branches): recorded from the flag the port passes to its
    attention wrappers, with and without a gradient."""
    from tts_king_torch.models import layers

    seen = []
    monkeypatch.setattr(
        layers, "attention", lambda q, k, v, m, probs_bf16=False: (
            seen.append(("attention", probs_bf16))
            or attn_mod.attention_plain(q, k, v, m, probs_bf16)))
    monkeypatch.setattr(
        layers, "flash_attention", lambda q, k, v, m, probs_bf16=False: (
            seen.append(("flash", probs_bf16))
            or fa.flash_attention_plain(q, k, v, m, probs_bf16)))
    x, mask = _x_mask(3)
    table = {  # (use_flash, use_pallas): (training rounds, eval rounds)
        (True, False): (False, False),
        (True, True): (False, False),
        (False, True): (True, False),
        (False, False): (True, True)}
    for (use_flash, use_pallas), (train_r, eval_r) in table.items():
        port, _, _ = _mha_pair("mha", 4, probs_bf16=True,
                               use_flash=use_flash, use_pallas=use_pallas)
        seen.clear()
        port.train()
        port(*_t(x, mask), torch.Generator().manual_seed(0))   # with grad
        with torch.no_grad():
            port(*_t(x, mask), torch.Generator().manual_seed(0))
            port.eval()
            port(*_t(x, mask))
        port.eval()
        port(*_t(x, mask))   # eval with grad: flash, not rounded if eval
        assert seen == [("flash", train_r), ("attention", train_r),
                        ("attention", eval_r), ("flash", eval_r)], (
            use_flash, use_pallas, seen)
        # without the flag no call rounds
        port.probs_bf16 = False
        seen.clear()
        port.train()
        port(*_t(x, mask), torch.Generator().manual_seed(0))
        assert seen == [("flash", False)]


@pytest.mark.parametrize("flags", [{"use_pallas": True},
                                   {"use_flash": True}],
                         ids=["pallas", "flash"])
def test_unrounded_routes_match_jax(flags):
    """Eval mode with use_pallas_attention (JAX: fused_attention, interpret
    mode) or use_flash_attention (JAX: the stock flash kernel, which
    computes the unrounded function; held to attention_reference's XLA
    formulation without the flag, as the TPU kernel is): the flag leaves
    the port's output as it is without it, and on the JAX function at the
    f32 bound of tests/test_torch_models.py (1e-5)."""
    import tts_king_tpu.ops.pallas.attention as pa

    port, jmod, variables = _mha_pair("fft", 5, probs_bf16=True, **flags)
    ref_mod = jmod if "use_pallas" in flags else _mha_pair("fft", 5)[1]
    x, mask = _x_mask(6)
    orig = pa.fused_attention
    pa.fused_attention = lambda q, k, v, m: orig(q, k, v, m, interpret=True)
    try:
        want = _jax_apply(ref_mod, variables, x, mask)
    finally:
        pa.fused_attention = orig
    with torch.no_grad():
        got = port(*_t(x, mask)).numpy()
        port.slf_attn.probs_bf16 = False
        plain = port(*_t(x, mask)).numpy()
    np.testing.assert_array_equal(got, plain)
    keep = ~mask[:, :, None]
    np.testing.assert_allclose(got * keep, want * keep, rtol=1e-5, atol=1e-5)


def test_train_step_matches_jax_make_train_step():
    """One optimizer step (acc 2, dropout off) of a tiny FastSpeech2 with
    attention_probs_bf16 against JAX's make_train_step on its XLA route, at
    compare_train_step's bounds: losses, clipped gradients, Adam moments,
    new weights, BatchNorm stats. The same step without the flag misses
    them (the negative control)."""
    from test_torch_train import (TINY_MODEL, TINY_OPT, jax_train,
                                  seeded_variables, synthetic_superbatch)

    from chip_smoke import compare_train_step, port_train_steps
    from tts_king_torch.train.schedule import noam_schedule

    model = dict(TINY_MODEL, attention_probs_bf16=True)
    variables = seeded_variables(model, seed=7)
    sbs = [synthetic_superbatch(2, 4, 12, 40, seed=8)]
    want = jax_train(model, TINY_OPT, variables, sbs)[0]
    lr = noam_schedule(16, TINY_OPT["warm_up_step"], [300000], 0.7)(0)
    errs = compare_train_step(port_train_steps(model, TINY_OPT, variables,
                                               sbs)[0], want, lr)
    assert errs["loss_rel"] <= 1e-5
    f32 = port_train_steps(TINY_MODEL, TINY_OPT, variables, sbs)[0]
    with pytest.raises(AssertionError):
        compare_train_step(f32, want, lr)


def test_flag_runs_on_every_fs2_route(tmp_path, monkeypatch):
    """With the flag: AcousticModel against the JAX AcousticModel with it
    (equal rounded durations and lengths; mels at MAX_TOL / MEAN_TOL),
    TTSKing.speak, and train() for 2 steps with its validation; every call
    of each route rounds (the default flags)."""
    import dataclasses

    from test_torch_pipeline import _seeded_fs2_variables
    from test_torch_train import _loop_config, _write_corpus

    from tts_king_torch.config import micro_config
    from tts_king_torch.models import layers
    from tts_king_torch.pipeline import AcousticModel, TTSKing
    from tts_king_torch.train.loop import train
    from tts_king_tpu.config import micro_config as jax_micro_config
    from tts_king_tpu.pipeline import AcousticModel as JaxAcousticModel

    seen = []
    for name in ("attention", "flash_attention"):
        orig = getattr(layers, name)
        monkeypatch.setattr(
            layers, name, lambda q, k, v, m, probs_bf16=False, orig=orig: (
                seen.append(probs_bf16) or orig(q, k, v, m, probs_bf16)))
    cfg = micro_config()
    cfg.model = dataclasses.replace(cfg.model, attention_probs_bf16=True)
    jcfg = jax_micro_config()
    jcfg.model = dataclasses.replace(jcfg.model, attention_probs_bf16=True)
    variables = _seeded_fs2_variables(micro_config(), 3)
    rng = np.random.RandomState(1)
    phonemes = rng.randint(1, 200, (3, 21))
    phonemes[1, 15:] = 0
    phonemes[2, 9:] = 0
    kw = dict(speaker_name=[0, 2, 1], src_lens=[21, 15, 9])
    want = JaxAcousticModel(jcfg, variables, n_speakers=3).generate(
        phonemes, **kw)
    got = AcousticModel(cfg, variables, n_speakers=3,
                        device="cpu").generate(phonemes, **kw)
    for key in ("duration_rounded", "mel_lens", "mel_lens_raw"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    assert_mode_close(got["postnet_mel"], np.asarray(want["postnet_mel"]),
                      "postnet_mel")
    king = TTSKing(cfg, device="cpu", n_speakers=3,
                   acoustic_variables=variables)
    wav = king.speak("Привет, мир!")[0]
    assert wav.dtype == np.int16 and wav.size > 0
    n_infer = len(seen)
    root = _write_corpus(tmp_path / "corpus", n_train=6)
    tcfg = _loop_config(root, tmp_path / "ckpt", total_step=2)
    tcfg = dataclasses.replace(tcfg, model=dataclasses.replace(
        tcfg.model, attention_probs_bf16=True))
    state = train(tcfg, device="cpu")
    assert state.step == 2
    assert n_infer and len(seen) > n_infer and all(seen)
