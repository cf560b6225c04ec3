"""The bf16-probability mode's Hopper kernels (csrc/attention_round.cuh) on
the CPU: their order of work against JAX's XLA route, the wrapper's scratch
and kernel plan, and row 1 on bf16 inputs against JAX's XLA route at bf16.

* Data flow: the tile-by-tile emulation of test_torch_attention_probs_bf16
  (the forward keeps S in a NaN-filled scratch between its passes and leaves
  P there; dQ keeps round(dP) in a second one; dK/dV reads both, P = 0 at
  padded keys; every product as emulated 3xTF32), at H = 1 (a tp rank's
  heads) and H = 2 with ragged masks, against jax.vjp of the XLA route with
  probs_bf16 at chip_smoke.PROBS_TOL (max 4e-3: single roundings of P or dP
  that flip between libraries; mean 5e-6). No output is NaN, so no entry of
  a skipped tile is read.
* ``attention.probs_plan``: the scratch shapes, the padded head dim each D
  takes, every T the port reaches, and the shapes it refuses.
* bf16 inputs: the port's MultiHeadAttention cast to bf16 (the plain route:
  S = (q * scale) k^T accumulated in f32, softmax in f32, P rounded to bf16,
  P.V accumulated in f32) against the JAX module with dtype=bfloat16 on its
  XLA route, which rounds S to bf16 (einsum's output) before the softmax.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from chip_smoke import PROBS_TOL
from test_torch_attention_probs_bf16 import (_t, backward_delta_sweep,
                                             forward_two_sweeps, inputs,
                                             jax_xla)
from tts_king_torch.ops.kernels import attention as attn_mod


def assert_probs_tol(got, want, what):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert np.isfinite(err).all(), (what, "not finite")
    assert err.max() <= PROBS_TOL["max"], (what, "max", err.max())
    assert err.mean() <= PROBS_TOL["mean"], (what, "mean", err.mean())


@pytest.mark.parametrize("kind", ["suffix", "edge"])
@pytest.mark.parametrize("H", [1, 2])
def test_round_data_flow_matches_jax_vjp(H, kind):
    """Forward and backward in the kernels' order of work, H = 1 and 2,
    ragged masks (edge: an item of length 1, a random mask with all-padded
    key tiles in the middle, leading padded tiles), against the XLA route's
    output and jax.vjp; padded keys get exactly 0 in dK and dV."""
    q, k, v, do, mask = inputs(5, H, 150, 16, kind, seed=40 + H)
    tq, tk, tv, tdo, tmask = _t(q, k, v, do, mask)
    o, _, probs = forward_two_sweeps(tq, tk, tv, tmask, write_p=True)
    dq, dk, dv = backward_delta_sweep(tq, tk, tv, tmask, probs, tdo)
    want_o, want = jax_xla(q, k, v, mask, do=do)
    assert_probs_tol(o.numpy(), want_o, "o")
    for name, a, r in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert_probs_tol(a.numpy(), r, name)
    pad = np.broadcast_to(mask[:, None, :, None], q.shape)
    assert not dk.numpy()[pad].any() and not dv.numpy()[pad].any()


def test_round_forward_item_without_valid_key():
    """Inference may see an item whose keys are all padded: every tile
    runs, so the scratch is written wherever it is read, and its rows
    average v over T as the XLA route does."""
    rng = np.random.RandomState(5)
    q, k, v = (rng.randn(3, 2, 70, 8).astype(np.float32) for _ in range(3))
    mask = np.arange(70)[None] >= np.array([70, 0, 23])[:, None]
    o, _, scratch = forward_two_sweeps(*_t(q, k, v, mask))
    assert_probs_tol(o.numpy(), jax_xla(q, k, v, mask), "o")
    assert np.isfinite(scratch[1].numpy()[..., :70]).all()


@pytest.mark.parametrize("D,dp", [(4, 32), (16, 32), (32, 32), (36, 64),
                                  (64, 64), (100, 128), (128, 128)])
def test_probs_plan_picks_the_kernel_by_head_dim(D, dp):
    """D is padded to the 32, 64 or 128 the kernels are built for."""
    assert attn_mod.probs_plan(2, 1, 50, D)["dp"] == dp


@pytest.mark.parametrize("T,ld", [(1, 64), (64, 64), (65, 128), (96, 128),
                                  (256, 256), (640, 640), (1000, 1024),
                                  (4000, 4032)])
def test_probs_plan_sizes_the_scratch(T, ld):
    """The scratch rows are T rounded up to 64 (dK/dV's block of keys);
    P and round(dP) are (B, H, T, ld), Delta (B, H, ld)."""
    plan = attn_mod.probs_plan(3, 2, T, 128)
    assert plan["ld"] == ld
    assert plan["probs"] == plan["dprobs"] == (3, 2, T, ld)
    assert plan["delta"] == (3, 2, ld)


def test_probs_plan_shared_memory_and_refusals():
    """Every T the port's attention reaches takes a plan: the encoder's
    L, speak's mel buckets, the batched 1000 (MEL_BUCKETS' largest, the
    most any path gives), the train step's 640; T = 4000 is a sizing
    case past every path. The plan holds no shared memory: the kernels'
    launches size their own (attention_round.cuh's round_smem) and fail
    past it, at T of ~77,000, which the wrapper raises. The memory the
    mode keeps at the bench step's decoder call: P 52.4 MB from the
    forward to the backward, round(dP) 26.2 MB. A head dim no kernel is
    built for, or an empty shape, is refused."""
    for T in (1, 21, 96, 128, 256, 512, 640, 1000, 4000):
        plan = attn_mod.probs_plan(32, 2, T, 128)
        assert plan["ld"] >= T and plan["ld"] % 64 == 0
        assert set(plan) == {"dp", "ld", "probs", "dprobs", "delta"}
    bench = attn_mod.probs_plan(16, 2, 640, 128)
    assert np.prod(bench["probs"]) * 4 == 52428800
    assert np.prod(bench["dprobs"]) * 2 == 26214400
    for bad in ((2, 1, 50, 130), (2, 1, 50, 6), (2, 1, 0, 64),
                (0, 1, 50, 64), (2, 0, 50, 64)):
        with pytest.raises(ValueError):
            attn_mod.probs_plan(*bad)


# ------------------------------------------- row 1 on bf16 inputs

D_MODEL, N_HEAD = 64, 2   # d_k = 32: scale 2^-2.5, not a power of two
# Tolerances, |port - JAX| on bf16 outputs of order 1 (an ulp is 2^-8 to
# 2^-6 there). The attention: JAX's XLA einsum returns S in bf16, rounded
# from its f32 sum, then scales it in f32; row 1's kernel (and the TPU
# kernel) keeps S in f32 (q scaled in bf16 first). A rounding of S by up to
# 2^-9 relative moves P, and the output moves by an ulp or two. Readings
# on the CPU: max 1.6e-2, mean 1.2e-3 with the flag and without; the
# port's arithmetic with S rounded as the einsum rounds it: mean 1.1e-6
# (0.4% of the outputs an ulp off: the two softmaxes' own roundings).
CORE_TOL = {"max": 3.2e-2, "mean": 2.5e-3}
CORE_XLA_ORDER_TOL = {"max": 3.9e-3, "mean": 1e-5}
# The module adds the four bf16 Dense layers, which JAX rounds after the
# product and again after the bias, torch's bf16 Linear once: max 3.1e-2,
# mean 2.0e-3 read.
MODULE_TOL = {"max": 6.25e-2, "mean": 4e-3}


def _errs(got, want, keep):
    err = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    err = err * keep
    return float(err.max()), float(err.sum() / np.broadcast_to(
        keep, err.shape).sum())


def _within(err, tol):
    return err[0] <= tol["max"] and err[1] <= tol["mean"]


@pytest.mark.parametrize("probs_bf16", [True, False], ids=["flag", "no_flag"])
def test_row1_bf16_inputs_match_jax_xla_route_at_bf16(probs_bf16):
    """Row 1's function on bf16 inputs (``attention``, the plain route on
    the CPU) against the JAX package's default XLA route at bf16, with the
    flag and without (on bf16 inputs JAX's cast of P to bf16 is the same
    either way): the port's MultiHeadAttention cast to bf16 against the
    JAX module with dtype=bfloat16 (MODULE_TOL), and the attention alone on
    the same bf16 q, k, v (CORE_TOL). The gap is S's bf16 rounding: the
    port's arithmetic with S rounded as XLA's einsum rounds it comes within
    CORE_XLA_ORDER_TOL, a hundredth of the gap's mean."""
    from tts_king_torch.models.layers import MultiHeadAttention
    from tts_king_torch.weights import seeded_state_dict, torch_to_flax
    from tts_king_tpu.models import layers as jl

    d_k = D_MODEL // N_HEAD
    port = MultiHeadAttention(N_HEAD, D_MODEL, d_k, d_k, 0.1,
                              probs_bf16=probs_bf16)
    sd = seeded_state_dict(port, 11)
    port.load_state_dict({k: torch.from_numpy(np.asarray(v))
                          for k, v in sd.items()})
    port = port.to(torch.bfloat16).eval()
    jmod = jl.MultiHeadAttention(N_HEAD, D_MODEL, d_k, d_k, 0.1,
                                 dtype=jnp.bfloat16, probs_bf16=probs_bf16)
    variables = {c: t for c, t in torch_to_flax(sd).items() if t}
    rng = np.random.RandomState(12)
    B, T = 3, 90
    x = torch.from_numpy(rng.randn(B, T, D_MODEL).astype(np.float32))
    x = x.to(torch.bfloat16)
    mask = np.arange(T)[None] >= np.array([T, 57, 12])[:, None]
    want = jmod.apply(jax.tree.map(jnp.asarray, variables),
                      jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
                      jnp.asarray(mask), True)
    with torch.no_grad():
        got = port(x, torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16
    err = _errs(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                ~mask[:, :, None])
    assert _within(err, MODULE_TOL), err

    # the attention alone on one set of bf16 q, k, v (B, H, T, D)
    q, k, v = (torch.from_numpy(rng.randn(B, N_HEAD, T, d_k).astype(
        np.float32)).to(torch.bfloat16) for _ in range(3))
    tmask = torch.from_numpy(mask)
    keep = ~mask[:, None, :, None]
    want = jax_xla(*(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                     for t in (q, k, v)), mask, probs_bf16=probs_bf16)
    want = np.asarray(want.astype(jnp.float32))
    got = attn_mod.attention(q, k, v, tmask, probs_bf16=probs_bf16)
    assert got.dtype == torch.bfloat16
    err = _errs(got.float().numpy(), want, keep)
    assert _within(err, CORE_TOL), err
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    s = s.to(torch.bfloat16).float() * (1.0 / np.sqrt(d_k))
    s = s.masked_fill(tmask[:, None, None, :], attn_mod.NEG_INF)
    xla = torch.matmul(torch.softmax(s, -1).to(torch.bfloat16).float(),
                       v.float()).to(torch.bfloat16)
    err_x = _errs(xla.float().numpy(), want, keep)
    assert _within(err_x, CORE_XLA_ORDER_TOL), err_x
    assert err_x[1] < err[1] / 100, (err_x, err)
